"""The KKW 2018 prover of trailofbits/reverie for circuits over GF(2) and
Z_2^64 joined by B2A bridges, plain.

A straightforward reading of the protocol (src/proof/mod.rs,
src/transcript/, src/interpreter/single.rs and combine.rs,
src/algebra/gf2/ and z64/), written for this benchmark and independent of
the code under test: it imports nothing of reverie_tpu_torch, and takes
from the rest of the benchmark only the program's columns and the plain
AES, BLAKE3 and GF(2) helpers beside it (kkw.py).

Every repetition (rep) is a lane; a proof's reps are the lanes p * R ..
p * R + R - 1.  A GF(2) share is one byte a lane, player j's share at bit
7 - j, a reconstructed GF(2) value 0x00 or 0xFF (as in kkw.py).  A Z_2^64
share is 8 int64 words a lane, one a player, a reconstructed value one
int64 word; arithmetic wraps mod 2^64 in int64, the bits of reverie's u64.

  tapes: each player key's AES-128-CTR keystream from counter 0 gives both
  domains' masks (generator/batch.rs): GF(2) mask i is bit i of the
  player's stream (kkw.tapes), Z_2^64 mask i its little-endian u64 at byte
  8 i (z64/batch.rs);
  streams, a rep each: GF(2) events 1 byte (a broadcast share byte, a
  masked input, a MUL's correction); Z_2^64 masked inputs and corrections
  8 bytes (one u64 LE), broadcast shares 64 (the 8 players' u64 LE);
  B2A(dst, src) (combine.rs:132-219), in this order: 64 fresh GF(2) masks
  (RANDOM gates, correction 0); a Z_2^64 mask r and its correction,
  the masks' bits as a u64 less r's reconstruction (a preprocessing event);
  the ripple-carry adder of those bits and the GF(2) wires src .. src + 63
  (add_64, combine.rs:39-93: 1 + 62 MULs and their XORs); the 64 sum bits
  broadcast and reconstructed (online events); dst's mask the negated r,
  its correction the sum's u64 less r's correction;
  rep hash H(H(H(pre2) || H(onl2)) || H(H(prez) || H(onlz))), then the
  commitment, the challenge and the proof file as kkw.py does, each opened
  rep's Z_2^64 half the omitted player's broadcast words, the corrections
  and the masked inputs, u64 LE, and each unopened rep's the seed and
  H(onlz).

Departures from reverie, none of which changes a byte of a proof:
  * the circuit is put in SSA form and levelled, and the gates of one
    level, domain and kind run as one vector operation over all lanes
    (reverie steps gate by gate over 8 reps packed in a u64); each event
    lands at its program-order place in its stream, precomputed;
  * a B2A's 64 reconstructions run as one step with its output;
  * reverie hands each domain its own copy of a rep's seed; an honest
    proof's are equal, and one is used for both;
  * a witness failing an AssertZero raises AssertionError, in either
    domain (reverie's prover panics in debug builds);
  * Z_2^64 inputs take their words from `witz` (the benchmark's harness
    hands statements GF(2) bits alone, and its statements have none).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch

from kkwbench.program import (ADD, ADDC, ASSERT_ZERO, B2A, CONST, GF2, INPUT, MUL, MULC,
                              RANDOM, SIZE_HINT, SUB, SUBC, Z64, Program)

from . import aes, blake3, kkw

PLAYERS, KEY = kkw.PLAYERS, kkw.KEY
D2, DZ = 0, 1  # the domains
B2A_CORR, B2A_OUT = 16, 17  # a B2A's Z_2^64 steps, beside the gate kinds
#: bytes one gathered operand of a step may hold, a pass
PASS_BYTES = 1 << 28
#: keystream bytes a pass of the Z_2^64 tape holds
KEYSTREAM_PASS_BYTES = 1 << 30
BIT = torch.arange(64, dtype=torch.int64)


class Group(NamedTuple):
    """The gates of one level, domain and kind (device index tensors, one
    entry a gate)."""

    domain: int
    op: int
    dst: torch.Tensor  # value ids written
    a: torch.Tensor  # first source value ids
    b: torch.Tensor  # second source value ids
    tape: torch.Tensor  # first mask position
    onl: torch.Tensor  # online stream position (GF(2) byte, Z_2^64 word)
    pre: torch.Tensor  # preprocessing stream position
    wit: torch.Tensor  # witness index (INPUT)
    const: torch.Tensor  # GF(2) 0x00 / 0xFF uint8, Z_2^64 int64
    bits: torch.Tensor  # (gates, 64) GF(2) value ids (B2A_CORR, B2A_OUT)


class Plan(NamedTuple):
    groups: List[Group]
    n_values: tuple  # (GF(2), Z_2^64) value ids, 0 a wire never written
    tape: tuple  # masks a player, a domain (m2, mz)
    n_onl: tuple  # online stream length a rep: GF(2) bytes, Z_2^64 words
    n_pre: tuple  # preprocessing stream length a rep: bytes, words
    n_witness: tuple  # GF(2) bits, Z_2^64 words
    inputs2: torch.Tensor  # GF(2) online positions of masked inputs, in order
    recons2: torch.Tensor  # GF(2) online positions of broadcast shares
    inputsz: torch.Tensor  # Z_2^64 online word of each masked input
    reconsz: torch.Tensor  # Z_2^64 online word of each broadcast's player 0


class _Domain:
    """One domain's SSA values and its counters, in program order."""

    def __init__(self):
        self.cur: Dict[int, int] = {}
        self.level = [0]
        self.tape = self.onl = self.pre = self.wit = 0
        self.inputs: List[int] = []
        self.recons: List[int] = []

    def read(self, wire: int) -> int:
        return self.cur.get(wire, 0)

    def fresh(self, level: int) -> int:
        self.level.append(level)
        return len(self.level) - 1


def plan(p: Program, device) -> Plan:
    """SSA values, levels and stream positions of a GF(2) / Z_2^64 / B2A
    program."""
    dom = (_Domain(), _Domain())
    rows: Dict[tuple, list] = {}

    def emit(level, d, op, dst=0, a=0, b=0, tape=0, onl=0, pre=0, wit=0, const=0, bits=None):
        rows.setdefault((level, d, op), []).append(
            (dst, a, b, tape, onl, pre, wit, const, bits or [0] * 64))

    def gate(d: int, op: int, dst: int, s1: int, s2: int, c: int) -> None:
        st = dom[d]
        recon_len = 1 if d == D2 else PLAYERS
        if d == D2:
            c = 0xFF if c & 1 else 0
            op = ADD if op == SUB else ADDC if op == SUBC else op
        else:
            c = int(np.uint64(c).view(np.int64))
        a = st.read(s1) if op not in (INPUT, RANDOM, CONST) else 0
        b = st.read(s2) if op in (ADD, SUB, MUL) else 0
        lv = 0 if op in (INPUT, RANDOM, CONST) else 1 + max(st.level[a], st.level[b])
        row = dict(a=a, b=b, tape=st.tape, onl=st.onl, pre=st.pre, wit=st.wit, const=c)
        if op == INPUT:
            st.inputs.append(st.onl)
            st.tape, st.onl, st.wit = st.tape + 1, st.onl + 1, st.wit + 1
        elif op == RANDOM:
            st.tape += 1
        elif op == MUL:
            st.recons.append(st.onl)
            st.tape, st.onl, st.pre = st.tape + 2, st.onl + recon_len, st.pre + 1
        elif op == ASSERT_ZERO:
            st.recons.append(st.onl)
            st.onl += recon_len
            emit(lv, d, op, **row)
            return
        v = st.fresh(lv)
        st.cur[dst] = v
        emit(lv, d, op, dst=v, **row)

    g2, gz = dom

    def add2(x: int, y: int) -> int:
        v = g2.fresh(1 + max(g2.level[x], g2.level[y]))
        emit(g2.level[v], D2, ADD, dst=v, a=x, b=y)
        return v

    def mul2(x: int, y: int) -> int:
        v = g2.fresh(1 + max(g2.level[x], g2.level[y]))
        emit(g2.level[v], D2, MUL, dst=v, a=x, b=y, tape=g2.tape, onl=g2.onl, pre=g2.pre)
        g2.recons.append(g2.onl)
        g2.tape, g2.onl, g2.pre = g2.tape + 2, g2.onl + 1, g2.pre + 1
        return v

    def b2a(dst: int, src: int) -> None:
        fresh = []
        for _ in range(64):
            fresh.append(g2.fresh(0))
            emit(0, D2, RANDOM, dst=fresh[-1], tape=g2.tape)
            g2.tape += 1
        r = gz.fresh(1)
        emit(1, DZ, B2A_CORR, dst=r, tape=gz.tape, pre=gz.pre, bits=fresh)
        gz.tape, gz.pre = gz.tape + 1, gz.pre + 1
        bw = [g2.read(src + i) for i in range(64)]
        out = [0] * 64
        carry = mul2(fresh[0], bw[0])
        out[0] = add2(fresh[0], bw[0])
        for i in range(1, 63):
            ac, bc = add2(fresh[i], carry), add2(bw[i], carry)
            prod = mul2(ac, bc)
            out[i] = add2(ac, bw[i])
            carry = add2(prod, carry)
        out[63] = add2(carry, add2(fresh[63], bw[63]))
        lv = 1 + max(max(g2.level[v] for v in out), gz.level[r])
        v = gz.fresh(lv)
        gz.cur[dst] = v
        emit(lv, DZ, B2A_OUT, dst=v, a=r, onl=g2.onl, bits=out)
        g2.recons.extend(range(g2.onl, g2.onl + 64))
        g2.onl += 64

    for kind, op, dst, s1, s2, c in zip(p.kind.tolist(), p.op.tolist(), p.dst.tolist(),
                                         p.src1.tolist(), p.src2.tolist(), p.const.tolist()):
        if kind == GF2:
            gate(D2, op, dst, s1, s2, c)
        elif kind == Z64:
            gate(DZ, op, dst, s1, s2, c)
        elif kind == B2A:
            b2a(dst, s1)
        elif kind != SIZE_HINT:
            raise ValueError(f"op kind {kind}")

    def t(x, dtype=torch.int64):
        return torch.as_tensor(np.asarray(x, dtype=np.int64), device=device).to(dtype)

    groups = []
    for (lv, d, op), r in sorted(rows.items()):
        cols = list(zip(*r))
        const = t(cols[7], torch.uint8 if d == D2 else torch.int64)
        groups.append(Group(d, op, *(t(cols[i]) for i in range(7)), const, t(cols[8])))
    return Plan(groups, (len(g2.level), len(gz.level)), (g2.tape, gz.tape), (g2.onl, gz.onl),
                (g2.pre, gz.pre), (g2.wit, gz.wit), t(g2.inputs), t(g2.recons), t(gz.inputs),
                t(gz.recons))


def _word(bits: torch.Tensor) -> torch.Tensor:
    """(..., 64, L) 0x00 / 0xFF -> (..., L) int64, bit i from row i."""
    w = (bits & 1).to(torch.int64) << BIT.to(bits.device)[:, None]
    return w.sum(dim=-2)  # the bits are disjoint: the sum is their OR


def execute(pl: Plan, tape2: torch.Tensor, tapez: torch.Tensor, wit2: torch.Tensor,
            witz: torch.Tensor):
    """tape2 (m2, L) share bytes, tapez (mz, L, 8) share words, wit2
    (n_wit2, L) 0x00 / 0xFF and witz (n_witz, L) int64 -> the streams
    (onl2, pre2) (n, L) uint8 and (onlz, prez) (n, L) int64, and a lane's
    AssertZero failures."""
    L, dev = tape2.shape[1], tape2.device
    mask2 = torch.zeros((pl.n_values[D2], L), dtype=torch.uint8, device=dev)
    corr2 = torch.zeros_like(mask2)
    maskz = torch.zeros((pl.n_values[DZ], L, PLAYERS), dtype=torch.int64, device=dev)
    corrz = torch.zeros((pl.n_values[DZ], L), dtype=torch.int64, device=dev)
    onl2 = torch.zeros((pl.n_onl[D2], L), dtype=torch.uint8, device=dev)
    pre2 = torch.zeros((pl.n_pre[D2], L), dtype=torch.uint8, device=dev)
    onlz = torch.zeros((pl.n_onl[DZ], L), dtype=torch.int64, device=dev)
    prez = torch.zeros((pl.n_pre[DZ], L), dtype=torch.int64, device=dev)
    fail = torch.zeros(L, dtype=torch.bool, device=dev)
    per = max(1, PASS_BYTES // (L * PLAYERS * 8))
    for g in pl.groups:
        for lo in range(0, len(g.dst), per):
            piece = Group(g.domain, g.op, *(x[lo:lo + per] for x in g[2:]))
            if g.domain == D2:
                fail |= _step2(piece, mask2, corr2, tape2, wit2, onl2, pre2)
            else:
                fail |= _stepz(piece, mask2, corr2, maskz, corrz, tapez, witz, onl2, onlz, prez)
    return onl2, pre2, onlz, prez, fail


def _step2(g: Group, mask, corr, tape, wit, onl, pre) -> torch.Tensor:
    """One GF(2) step (kkw.execute's gates) -> its lanes' AssertZero
    failures."""
    rec, op, L = kkw._rec, g.op, mask.shape[1]
    k = g.const[:, None]
    fail = torch.zeros(L, dtype=torch.bool, device=mask.device)
    if op == INPUT:
        m = tape[g.tape]
        c = wit[g.wit] ^ rec(m)
        onl[g.onl] = c
    elif op == RANDOM:
        m, c = tape[g.tape], torch.zeros_like(tape[g.tape])
    elif op == CONST:
        m = torch.zeros((len(g.dst), L), dtype=torch.uint8, device=mask.device)
        c = k.expand(-1, L).contiguous()
    elif op == ADD:
        m, c = mask[g.a] ^ mask[g.b], corr[g.a] ^ corr[g.b]
    elif op == ADDC:
        m, c = mask[g.a], corr[g.a] ^ k
    elif op == MULC:
        m, c = mask[g.a] & k, corr[g.a] & k
    elif op == ASSERT_ZERO:
        m = mask[g.a]
        onl[g.onl] = m
        return ((corr[g.a] ^ rec(m)) != 0).any(dim=0)
    elif op == MUL:  # single.rs:25-69
        m1, c1, m2, c2 = mask[g.a], corr[g.a], mask[g.b], corr[g.b]
        mab, m = tape[g.tape], tape[g.tape + 1]
        delta = (rec(m1) & rec(m2)) ^ rec(mab)
        s = (m2 & c1) ^ (m1 & c2) ^ mab ^ m
        c = rec(s) ^ delta ^ (c1 & c2)
        onl[g.onl] = s
        pre[g.pre] = delta
    else:
        raise ValueError(f"GF(2) opcode {op}")
    mask[g.dst] = m
    corr[g.dst] = c
    return fail


def _stepz(g: Group, mask2, corr2, mask, corr, tape, wit, onl2, onl, pre) -> torch.Tensor:
    """One Z_2^64 step (single.rs over z64/domain.rs: a share's
    reconstruction is the wrapping sum of its 8 words; a public value
    scales every player's word and is added to the correction alone), or a
    B2A's -> its lanes' AssertZero failures."""
    op, L, dev = g.op, mask.shape[1], mask.device
    k = g.const[:, None]
    fail = torch.zeros(L, dtype=torch.bool, device=dev)
    if op == INPUT:
        m = tape[g.tape]
        c = wit[g.wit] - m.sum(dim=-1)
        onl[g.onl] = c
    elif op == RANDOM:
        m = tape[g.tape]
        c = torch.zeros(m.shape[:2], dtype=torch.int64, device=dev)
    elif op == CONST:
        m = torch.zeros((len(g.dst), L, PLAYERS), dtype=torch.int64, device=dev)
        c = k.expand(-1, L).contiguous()
    elif op == ADD:
        m, c = mask[g.a] + mask[g.b], corr[g.a] + corr[g.b]
    elif op == SUB:
        m, c = mask[g.a] - mask[g.b], corr[g.a] - corr[g.b]
    elif op == ADDC:
        m, c = mask[g.a], corr[g.a] + k
    elif op == SUBC:
        m, c = mask[g.a], corr[g.a] - k
    elif op == MULC:
        m, c = mask[g.a] * k[..., None], corr[g.a] * k
    elif op == ASSERT_ZERO:
        m = mask[g.a]
        onl[g.onl[:, None] + torch.arange(PLAYERS, device=dev)] = m.transpose(1, 2)
        return ((corr[g.a] + m.sum(dim=-1)) != 0).any(dim=0)
    elif op == MUL:  # single.rs:25-69
        m1, c1, m2, c2 = mask[g.a], corr[g.a], mask[g.b], corr[g.b]
        mab, m = tape[g.tape], tape[g.tape + 1]
        delta = m1.sum(dim=-1) * m2.sum(dim=-1) - mab.sum(dim=-1)
        s = m2 * c1[..., None] + m1 * c2[..., None] + mab - m
        c = s.sum(dim=-1) + delta + c1 * c2
        onl[g.onl[:, None] + torch.arange(PLAYERS, device=dev)] = s.transpose(1, 2)
        pre[g.pre] = delta
        del m1, m2, mab, s
    elif op == B2A_CORR:  # combine.rs:140-160: the fresh masks' bits as a u64, shared
        value = _word(kkw._rec(mask2[g.bits]) ^ corr2[g.bits])
        m = tape[g.tape]
        c = value - m.sum(dim=-1)
        pre[g.pre] = c
    elif op == B2A_OUT:  # combine.rs:195-219: the sum's bits broadcast, less r
        bm = mask2[g.bits]  # (gates, 64, L)
        onl2[g.onl[:, None] + torch.arange(64, device=dev)] = bm
        value = _word(kkw._rec(bm) ^ corr2[g.bits])
        m, c = -mask[g.a], value - corr[g.a]
    else:
        raise ValueError(f"Z_2^64 opcode {op}")
    mask[g.dst] = m
    corr[g.dst] = c
    return fail


def tapes_z64(keys: np.ndarray, mz: int, device) -> torch.Tensor:
    """(L, 8, 16) player keys -> (mz, L, 8) int64: mask i of lane l's player
    j the little-endian u64 at byte 8 i of player j's keystream."""
    L = len(keys)
    nblk = -(-mz // 2)
    out = torch.empty((mz, L, PLAYERS), dtype=torch.int64, device=device)
    if mz == 0:
        return out
    per = max(1, KEYSTREAM_PASS_BYTES // (PLAYERS * nblk * 16))
    for l0 in range(0, L, per):
        l1 = min(L, l0 + per)
        ks = aes.keystream(keys[l0:l1].reshape(-1, KEY), nblk, device)
        words = ks.view(torch.int64).view(l1 - l0, PLAYERS, -1)[..., :mz]
        out[:, l0:l1] = words.permute(2, 0, 1)
        del ks, words
    return out


def _bytes_le(words: torch.Tensor) -> np.ndarray:
    """(K, n) int64 -> (K, 8 n) uint8, each word little-endian."""
    w = np.ascontiguousarray(words.cpu().numpy(), dtype="<i8")
    return w.view(np.uint8).reshape(len(w), -1)


def _hash(stream: torch.Tensor) -> torch.Tensor:
    """(n, L) uint8 or int64 stream, a lane a column -> (L, 32): BLAKE3 of
    each lane's bytes (a word little-endian)."""
    n, L = stream.shape
    rows = torch.empty((L, n * stream.element_size()), dtype=torch.uint8, device=stream.device)
    if n:
        rows.view(stream.dtype).copy_(stream.T)
    return blake3.hash_rows(rows, rows.shape[1])


def prove(p: Program, witnesses: np.ndarray, seeds: np.ndarray, device,
          total_reps: int = 256, online_reps: int = 40, pl: Plan = None,
          witz: np.ndarray = None) -> List[bytes]:
    """The proof files of P statements of one program: witnesses (P, n
    GF(2) witness bits) 0/1, seeds (P, total_reps, 16) uint8 rep seeds,
    witz (P, n Z_2^64 words) where the program has Z_2^64 inputs."""
    pl = plan(p, device) if pl is None else pl
    P, R = len(witnesses), total_reps
    n_witz = pl.n_witness[DZ]
    if witz is None:
        if n_witz:
            raise ValueError("the program has Z_2^64 inputs: pass their words as witz")
        witz = np.zeros((P, 0), dtype=np.uint64)
    seeds = np.ascontiguousarray(seeds, dtype=np.uint8).reshape(P * R, KEY)
    keys = kkw.player_keys(seeds, device)
    tape2 = kkw.tapes(keys, pl.tape[D2], device) if pl.tape[D2] else \
        torch.zeros((0, P * R), dtype=torch.uint8, device=device)
    tapez = tapes_z64(keys, pl.tape[DZ], device)
    w2 = torch.as_tensor(np.asarray(witnesses, dtype=np.uint8).T * 255, device=device)
    wz = torch.as_tensor(np.asarray(witz, dtype=np.uint64)[:, :n_witz].view(np.int64).T.copy(),
                         device=device)
    onl2, pre2, onlz, prez, fail = execute(pl, tape2, tapez, w2.repeat_interleave(R, dim=1),
                                           wz.repeat_interleave(R, dim=1))
    del tape2, tapez
    if bool(fail.any()):
        raise AssertionError("witness is invalid: an AssertZero wire is nonzero")
    ho2, hoz = _hash(onl2), _hash(onlz)
    h2 = blake3.hash_rows(torch.cat([_hash(pre2), ho2], dim=1), 64)
    hz = blake3.hash_rows(torch.cat([_hash(prez), hoz], dim=1), 64)
    rep = blake3.hash_rows(torch.cat([h2, hz], dim=1), 64)
    comms = blake3.hash_rows(rep.reshape(P, R * 32), R * 32).cpu().numpy()
    ho2, hoz = ho2.cpu().numpy(), hoz.cpu().numpy()
    onl2_t, pre2_t = onl2.T.contiguous(), pre2.T.contiguous()
    del onl2, pre2
    proofs = []
    for i in range(P):
        comm = comms[i].tobytes()
        opened = kkw.challenge(comm, R, online_reps)
        reps = sorted(opened)
        lanes = torch.as_tensor([i * R + r for r in reps], dtype=torch.int64, device=device)
        who = torch.as_tensor([opened[r] for r in reps], dtype=torch.int64, device=device)
        omit = (7 - who).to(torch.uint8)
        rec2 = kkw._pack((onl2_t[lanes][:, pl.recons2] >> omit[:, None]) & 1).cpu().numpy()
        cor2 = kkw._pack(pre2_t[lanes] & 1).cpu().numpy()
        inp2 = kkw._pack(onl2_t[lanes][:, pl.inputs2] & 1).cpu().numpy()
        ol, pr = onlz[:, lanes], prez[:, lanes]  # (n, K)
        recz = _bytes_le(ol[pl.reconsz[:, None] + who[None, :], torch.arange(len(reps), device=device)].T)
        corz = _bytes_le(pr.T)
        inpz = _bytes_le(ol[pl.inputsz].T)
        parts = [comm]
        for streams, ho in (((rec2, cor2, inp2), ho2), ((recz, corz, inpz), hoz)):
            parts.append(kkw._u64(online_reps))
            for j, r in enumerate(reps):
                k = keys[i * R + r].copy()
                k[opened[r]] = 0
                parts += [bytes([opened[r]]), k.tobytes()]
                for s in streams:
                    parts += [kkw._u64(len(s[j])), s[j].tobytes()]
            parts.append(kkw._u64(R - online_reps))
            for r in range(R):
                if r not in opened:
                    parts += [seeds[i * R + r].tobytes(), ho[i * R + r].tobytes()]
        proofs.append(b"".join(parts))
    return proofs
