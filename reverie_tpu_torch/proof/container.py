"""Proof containers and bincode-compatible (de)serialization.

The port's copy of reverie_tpu/proof/container.py; proofs cross between
the two packages as `to_bytes()` / `from_bytes()`.  Byte-compatible with
the reference's serde+bincode-1.3 proof files (src/proof/mod.rs:40-66,
main.rs:84,103): fixed-width LE integers, Vec length as u64, fixed-size
arrays inline, u8 enum-free structs.
"""

from __future__ import annotations

import dataclasses
import io
import struct
from typing import List

from ..params import HASH_SIZE, KEY_SIZE, PLAYERS

_U64 = struct.Struct("<Q")


@dataclasses.dataclass
class OpenOnline:
    """Opening of an online repetition (proof/mod.rs:41-47)."""

    omit: int  # unopened player
    seeds: bytes  # 8 x 16 bytes player keys, unopened player zeroed
    recons: bytes  # packed broadcast shares of the omitted player
    corrs: bytes  # packed corrections
    inputs: bytes  # packed masked inputs


@dataclasses.dataclass
class OpenPreprocessing:
    """Opening of a preprocessing-only repetition (proof/mod.rs:49-53)."""

    seed: bytes  # 16-byte repetition seed
    comm_online: bytes  # 32-byte commitment to the online phase


@dataclasses.dataclass
class ProofSingle:
    online: List[OpenOnline]
    preprocessing: List[OpenPreprocessing]

    def check_format(self, online_reps: int, preprocessing_reps: int) -> bool:
        """Length and field-shape validation (proof/mod.rs:229-236 checks the
        list lengths; the omit/seed checks are additional hardening -- the
        reference panics on out-of-range omit, a bool API must not)."""
        if len(self.online) != online_reps:
            return False
        if len(self.preprocessing) != preprocessing_reps:
            return False
        for o in self.online:
            if not (0 <= o.omit < PLAYERS):
                return False
            if len(o.seeds) != PLAYERS * KEY_SIZE:
                return False
        for p in self.preprocessing:
            if len(p.seed) != KEY_SIZE or len(p.comm_online) != HASH_SIZE:
                return False
        return True


@dataclasses.dataclass
class Proof:
    comm: bytes  # 32-byte challenge commitment
    gf2: ProofSingle
    z64: ProofSingle

    # ---- serialization ----------------------------------------------------
    def to_bytes(self) -> bytes:
        out = io.BytesIO()
        assert len(self.comm) == HASH_SIZE
        out.write(self.comm)
        for single in (self.gf2, self.z64):
            out.write(_U64.pack(len(single.online)))
            for o in single.online:
                out.write(bytes([o.omit]))
                assert len(o.seeds) == KEY_SIZE * PLAYERS
                out.write(o.seeds)
                for stream in (o.recons, o.corrs, o.inputs):
                    out.write(_U64.pack(len(stream)))
                    out.write(stream)
            out.write(_U64.pack(len(single.preprocessing)))
            for p in single.preprocessing:
                assert len(p.seed) == KEY_SIZE and len(p.comm_online) == HASH_SIZE
                out.write(p.seed)
                out.write(p.comm_online)
        return out.getvalue()

    @staticmethod
    def from_bytes(data: bytes) -> "Proof":
        buf = memoryview(data)
        pos = 0

        def take(n: int) -> bytes:
            nonlocal pos
            if pos + n > len(buf):
                raise ValueError("truncated proof")
            out = bytes(buf[pos : pos + n])
            pos += n
            return out

        def take_u64() -> int:
            return _U64.unpack(take(8))[0]

        comm = take(HASH_SIZE)
        singles = []
        for _ in range(2):
            online = []
            for _ in range(take_u64()):
                omit = take(1)[0]
                seeds = take(KEY_SIZE * PLAYERS)
                recons = take(take_u64())
                corrs = take(take_u64())
                inputs = take(take_u64())
                online.append(OpenOnline(omit, seeds, recons, corrs, inputs))
            preprocessing = []
            for _ in range(take_u64()):
                seed = take(KEY_SIZE)
                comm_online = take(HASH_SIZE)
                preprocessing.append(OpenPreprocessing(seed, comm_online))
            singles.append(ProofSingle(online, preprocessing))
        if pos != len(buf):
            raise ValueError(f"trailing bytes in proof: {len(buf) - pos}")
        return Proof(comm, singles[0], singles[1])
