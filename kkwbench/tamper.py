"""Tampered copies of a proof file, for the check that follows a verify
mix's window: each alters one field that a sound verifier has to catch, so
its verdict must be False.

The file (bincode 1.3, trailofbits/reverie src/proof/mod.rs:40-66): the
commitment (32 bytes); then the GF(2) proof and the Z_2^64 one, each a u64
count of opened reps, each rep its omitted player (u8), the 8 players' keys
(8 x 16 bytes, the omitted one zeroed) and three u64-length streams (the
omitted player's broadcast, the corrections, the masked inputs), then a u64
count of unopened reps, each its seed (16) and its online hash (32).  Every
kind below alters the GF(2) proof's first rep of its sort: the broadcast's
first bit is the first MUL's or AssertZero's share, so the kind needs a
circuit with one (both configurations have many).
"""

from __future__ import annotations

import struct
from typing import Dict

KINDS = ("commitment", "broadcast", "player_key", "unopened_seed", "unopened_hash")
PLAYERS, KEY, HASH = 8, 16, 32


def fields(data: bytes) -> Dict[str, int]:
    """Byte offsets of the fields KINDS alter."""

    def u64(at: int) -> int:
        return struct.unpack_from("<Q", data, at)[0]

    pos, n_open = HASH + 8, u64(HASH)
    out = {"commitment": 0}
    for r in range(n_open):
        keys = pos + 1
        streams = keys + PLAYERS * KEY
        if r == 0:
            out["player_key"] = keys + KEY * ((data[pos] + 1) % PLAYERS)
            out["broadcast"] = streams + 8
            if u64(streams) == 0:
                raise ValueError("the first opened rep's broadcast is empty")
        pos = streams
        for _ in range(3):
            pos += 8 + u64(pos)
    if u64(pos) == 0:
        raise ValueError("the proof has no unopened rep")
    out["unopened_seed"] = pos + 8
    out["unopened_hash"] = pos + 8 + KEY
    return out


def tamper(data: bytes, kind: str) -> bytes:
    """A copy of the proof file with the field of `kind` altered: a bit
    flipped (the broadcast's first, the top bit of its first byte; else the
    lowest of the field's first byte)."""
    at = fields(data)[kind]
    out = bytearray(data)
    out[at] ^= 0x80 if kind == "broadcast" else 0x01
    return bytes(out)
