"""The KKW 2018 prover of trailofbits/reverie for GF(2) circuits, plain.

A straightforward reading of the protocol (src/proof/mod.rs,
src/transcript/, src/interpreter/, src/algebra/gf2/), written for this
benchmark and independent of the code under test: it imports nothing of
reverie_tpu_torch, and the only thing it shares with it is the program
file's columns, which the benchmark builds for both.

Every repetition (rep) is a lane; a proof's reps are the lanes p * R .. p *
R + R - 1, so several proofs of one circuit run side by side.  A share of a
wire is one byte a lane, player j's share at bit 7 - j; a reconstructed
value is 0x00 or 0xFF.  The circuit is put in SSA form and levelled; the
gates of one level and opcode run as one vector operation over all lanes,
each gate writing its transcript bytes at its own place in the online and
preprocessing streams, so the streams come out in program order.

  prove: rep seeds -> player keys (AES-128-CTR of the seed) -> random tapes
  (each player key's AES-CTR keystream, bit i of player j the share of
  mask i) -> execute -> per rep BLAKE3 of each stream, H(pre || online),
  and H(that || the Z_2^64 leg's, whose streams are empty) -> the
  commitment, BLAKE3 of the reps' hashes -> the Fiat-Shamir challenge ->
  the opened reps' broadcast, correction and input bits, packed -> the
  proof file's bytes (bincode, src/proof/mod.rs:40-66).
"""

from __future__ import annotations

import struct
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from kkwbench.program import (ADD, ADDC, ASSERT_ZERO, CONST, GF2, INPUT, MUL, MULC, RANDOM,
                              SIZE_HINT, SUB, SUBC, Program)

from . import aes, blake3

PLAYERS = 8
KEY = 16
CHALLENGE_CONTEXT = b"random-oracle challenge"
#: bytes of one (lane, player, keystream byte, bit) a tape pass holds
TAPE_PASS_BYTES = 1 << 28


class Group(NamedTuple):
    """The gates of one opcode in one level (device index tensors)."""

    op: int
    dst: torch.Tensor  # value ids written
    a: torch.Tensor  # first source value ids
    b: torch.Tensor  # second source value ids
    tape: torch.Tensor  # first tape position
    onl: torch.Tensor  # online stream position
    pre: torch.Tensor  # preprocessing stream position
    const: int  # 0x00 / 0xFF (ADDC, SUBC, MULC, CONST)
    wit: torch.Tensor  # witness bit index (INPUT)


class Plan(NamedTuple):
    groups: List[Group]
    n_values: int
    m2: int  # tape shares a player
    n_onl: int  # online stream bytes a rep
    n_pre: int  # preprocessing stream bytes a rep
    inputs: torch.Tensor  # online positions of INPUT bytes, in order
    recons: torch.Tensor  # online positions of MUL and ASSERT_ZERO bytes
    n_witness: int


def plan(p: Program, device) -> Plan:
    """SSA values, levels and stream positions of a GF(2) program."""
    if not np.all((p.kind == GF2) | (p.kind == SIZE_HINT)):
        raise NotImplementedError("the plain reference proves GF(2) programs only")
    cur: Dict[int, int] = {}
    level = [0]  # value 0: a wire never written (mask 0, corr 0)
    rows: Dict[tuple, list] = {}
    tape = onl = pre = wit = 0
    inputs, recons = [], []
    for kind, op, dst, s1, s2, c in zip(p.kind.tolist(), p.op.tolist(), p.dst.tolist(),
                                         p.src1.tolist(), p.src2.tolist(), p.const.tolist()):
        if kind != GF2:
            continue
        a = cur.get(s1, 0) if op in (ADD, SUB, MUL, ADDC, SUBC, MULC, ASSERT_ZERO) else 0
        b = cur.get(s2, 0) if op in (ADD, SUB, MUL) else 0
        lv = 1 + max(level[a], level[b]) if op not in (INPUT, RANDOM, CONST) else 0
        op = ADD if op == SUB else ADDC if op == SUBC else op
        row = [0, a, b, tape, onl, pre, wit]
        if op == INPUT:
            inputs.append(onl)
            tape, onl, wit = tape + 1, onl + 1, wit + 1
        elif op == RANDOM:
            tape += 1
        elif op == MUL:
            recons.append(onl)
            tape, onl, pre = tape + 2, onl + 1, pre + 1
        elif op == ASSERT_ZERO:
            recons.append(onl)
            onl += 1
        if op != ASSERT_ZERO:
            row[0] = len(level)
            level.append(lv)
            cur[dst] = row[0]
        rows.setdefault((lv, op, 0xFF if (c & 1) else 0), []).append(row)

    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.int64), device=device)

    groups = []
    for (lv, op, const), r in sorted(rows.items()):
        cols = np.asarray(r, dtype=np.int64).T
        groups.append(Group(op, *(t(cols[i]) for i in range(6)), const, t(cols[6])))
    return Plan(groups, len(level), tape, onl, pre, t(inputs), t(recons), wit)


def _rec(x: torch.Tensor) -> torch.Tensor:
    """A share byte's parity as 0x00 / 0xFF (reconstruct, gf2/domain.rs:47-63)."""
    x = x ^ (x >> 4)
    x = x ^ (x >> 2)
    x = x ^ (x >> 1)
    return (x & 1) * 255


def execute(pl: Plan, tape: torch.Tensor, wit: torch.Tensor):
    """tape (m2, L) and wit (n_witness, L) 0x00 / 0xFF -> the online and
    preprocessing streams (n, L) uint8, and a lane's AssertZero failures."""
    L, dev = tape.shape[1], tape.device
    mask = torch.zeros((pl.n_values, L), dtype=torch.uint8, device=dev)
    corr = torch.zeros_like(mask)
    onl = torch.zeros((pl.n_onl, L), dtype=torch.uint8, device=dev)
    pre = torch.zeros((pl.n_pre, L), dtype=torch.uint8, device=dev)
    fail = torch.zeros(L, dtype=torch.bool, device=dev)
    for g in pl.groups:
        if g.op == INPUT:
            m = tape[g.tape]
            c = wit[g.wit] ^ _rec(m)
            onl[g.onl] = c
        elif g.op == RANDOM:
            m, c = tape[g.tape], torch.zeros_like(tape[g.tape])
        elif g.op == CONST:
            m = torch.zeros((len(g.dst), L), dtype=torch.uint8, device=dev)
            c = torch.full_like(m, g.const)
        elif g.op == ADD:
            m, c = mask[g.a] ^ mask[g.b], corr[g.a] ^ corr[g.b]
        elif g.op == ADDC:
            m, c = mask[g.a], corr[g.a] ^ g.const
        elif g.op == MULC:
            m, c = mask[g.a] & g.const, corr[g.a] & g.const
        elif g.op == ASSERT_ZERO:
            m = mask[g.a]
            onl[g.onl] = m
            fail |= ((corr[g.a] ^ _rec(m)) != 0).any(dim=0)
            continue
        elif g.op == MUL:  # single.rs:25-69
            m1, c1, m2, c2 = mask[g.a], corr[g.a], mask[g.b], corr[g.b]
            mab, m = tape[g.tape], tape[g.tape + 1]
            delta = (_rec(m1) & _rec(m2)) ^ _rec(mab)
            s = (m2 & c1) ^ (m1 & c2) ^ mab ^ m
            c = _rec(s) ^ delta ^ (c1 & c2)
            onl[g.onl] = s
            pre[g.pre] = delta
            del m1, c1, m2, c2, mab, s, delta
        else:
            raise ValueError(f"opcode {g.op}")
        mask[g.dst] = m
        corr[g.dst] = c
    return onl, pre, fail


def player_keys(seeds: np.ndarray, device) -> np.ndarray:
    """(L, 16) rep seeds -> (L, 8, 16) player keys: the seed's first 128
    keystream bytes (transcript/mod.rs:99-106)."""
    return aes.keystream(seeds, PLAYERS, device).cpu().numpy().reshape(-1, PLAYERS, KEY)


def tapes(keys: np.ndarray, m2: int, device) -> torch.Tensor:
    """(L, 8, 16) player keys -> (m2, L) share bytes: share i of lane l has
    player j's bit i of its keystream (most significant bit of a byte
    first) at bit 7 - j (gf2/batch.rs, gf2/domain.rs)."""
    L = len(keys)
    nblk = -(-m2 // 128)
    out = torch.empty((m2, L), dtype=torch.uint8, device=device)
    per = max(1, TAPE_PASS_BYTES // (64 * nblk * 16))
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=device)
    for l0 in range(0, L, per):
        l1 = min(L, l0 + per)
        ks = aes.keystream(keys[l0:l1].reshape(-1, KEY), nblk, device).view(l1 - l0, PLAYERS, -1)
        bits = (ks[..., None] >> shifts) & 1  # (l, player, byte, bit)
        share = (bits << shifts[:, None, None]).sum(dim=1, dtype=torch.uint8)  # (l, byte, bit)
        out[:, l0:l1] = share.view(l1 - l0, -1)[:, :m2].T
        del ks, bits, share
    return out


def challenge(comm: bytes, total: int, online: int) -> Dict[int, int]:
    """{rep: omitted player}: 16-byte little-endian draws of the random
    oracle on comm, rep then player, a rep drawn again taking the later
    player, until `online` reps are drawn (proof/mod.rs:68-100)."""
    data = CHALLENGE_CONTEXT + b"\x00" + comm
    n = 64 * online
    while True:
        stream = blake3.xof(data, n)
        opened: Dict[int, int] = {}
        pos = 0
        while len(opened) < online and pos + 32 <= n:
            rep = int.from_bytes(stream[pos:pos + 16], "little") % total
            opened[rep] = int.from_bytes(stream[pos + 16:pos + 32], "little") % PLAYERS
            pos += 32
        if len(opened) == online:
            return opened
        n *= 2


def _pack(bits: torch.Tensor) -> torch.Tensor:
    """(K, N) 0/1 -> (K, N // 8 + 1) bytes, bit j of a byte at 7 - j, the
    last byte always emitted (gf2/recon.rs:126-259, gf2/share.rs:87-146)."""
    K, N = bits.shape
    nb = N // 8 + 1
    pad = torch.zeros((K, nb * 8), dtype=torch.uint8, device=bits.device)
    pad[:, :N] = bits
    w = torch.arange(7, -1, -1, dtype=torch.uint8, device=bits.device)
    return (pad.view(K, nb, 8) << w).sum(dim=-1, dtype=torch.uint8)


def _u64(n: int) -> bytes:
    return struct.pack("<Q", n)


def prove(p: Program, witnesses: np.ndarray, seeds: np.ndarray, device,
          total_reps: int = 256, online_reps: int = 40, pl: Plan = None) -> List[bytes]:
    """The proof files of P statements of one program: witnesses (P, n
    witness bits) 0/1, seeds (P, total_reps, 16) uint8 rep seeds."""
    pl = plan(p, device) if pl is None else pl
    P, R = len(witnesses), total_reps
    seeds = np.ascontiguousarray(seeds, dtype=np.uint8).reshape(P * R, KEY)
    keys = player_keys(seeds, device)
    tape = tapes(keys, pl.m2, device)
    wit = torch.as_tensor(np.asarray(witnesses, dtype=np.uint8).T * 255, device=device)
    onl, pre, fail = execute(pl, tape, wit.repeat_interleave(R, dim=1))
    del tape
    if bool(fail.any()):
        raise AssertionError("witness is invalid: an AssertZero wire is nonzero")
    onl_t, pre_t = onl.T.contiguous(), pre.T.contiguous()
    ho2 = blake3.hash_rows(onl_t, pl.n_onl)
    h2 = blake3.hash_rows(torch.cat([blake3.hash_rows(pre_t, pl.n_pre), ho2], dim=1), 64)
    empty = blake3.hash_bytes(b"")
    hz = blake3.hash_bytes(empty + empty)
    rep = blake3.hash_rows(torch.cat([h2, torch.tensor(list(hz), dtype=torch.uint8,
                                                       device=device).expand(P * R, 32)], 1), 64)
    comms = blake3.hash_rows(rep.reshape(P, R * 32), R * 32).cpu().numpy()
    ho2 = ho2.cpu().numpy()
    proofs = []
    for i in range(P):
        comm = comms[i].tobytes()
        opened = challenge(comm, R, online_reps)
        reps = sorted(opened)
        lanes = torch.as_tensor([i * R + r for r in reps], dtype=torch.int64, device=device)
        omit = torch.as_tensor([7 - opened[r] for r in reps], dtype=torch.uint8, device=device)
        rec = _pack(((onl_t[lanes][:, pl.recons] >> omit[:, None]) & 1)).cpu().numpy()
        cor = _pack(pre_t[lanes] & 1).cpu().numpy()
        inp = _pack(onl_t[lanes][:, pl.inputs] & 1).cpu().numpy()
        parts = [comm]
        for z64 in (False, True):
            parts.append(_u64(online_reps))
            for j, r in enumerate(reps):
                k = keys[i * R + r].copy()
                k[opened[r]] = 0
                parts += [bytes([opened[r]]), k.tobytes()]
                for s in ((b"", b"", b"") if z64 else (rec[j], cor[j], inp[j])):
                    parts += [_u64(len(s)), bytes(s)]
            parts.append(_u64(R - online_reps))
            for r in range(R):
                if r not in opened:
                    parts += [seeds[i * R + r].tobytes(), empty if z64 else ho2[i * R + r].tobytes()]
        proofs.append(b"".join(parts))
    return proofs
