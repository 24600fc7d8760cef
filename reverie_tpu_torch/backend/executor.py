"""Levelized batched KKW execution in PyTorch, GF(2) and Z_2^64 kinds.

Port of reverie_tpu/backend/tpu.py (`Executor`, `_gf2_kind`, `_z64_kind`,
`_prep_tables`, `_Acc`, `_classify`, `_assemble_stream`, `_parity8`,
`_expand`, `_recon_sum`, `_compose_bits`, `carry_arena`,
`_dead_dst_columns`, `Executor._arena_rows`, and the segment carries of
streaming).  Every gate of a level runs as one vector op over
all repetitions:

  mask2 arena : (L2, R) uint8 -- byte r = the 8 player bits of rep r
                (bit 7-p = player p, the reference byte layout)
  corr2 arena : (L2, R) uint8 -- 0/1 per rep
  maskz arena : (Lz, 8, R) int64 -- player-major Z_2^64 shares
  corrz arena : (Lz, R) int64
  tape        : (m2, R) uint8 (aes_tape.py); tapez (mz, 8, R) int64
                (aes_tape_z64.py)

Z_2^64 is native int64: add, sub, mul and sum wrap mod 2^64.  Transcript
rows land at their compile-time offsets in the (stream_len, R) onl2 / pre2
/ onlz / prez streams, so each column is byte-identical to the reference's
sequential absorption (a z64 word is 8 little-endian bytes, a z64 share
event 8 players x 8 bytes).  Index columns that are constant or arithmetic
runs become broadcasts and (strided) slices; the rest are device int64
gathers.

PyTorch runs eagerly, and the arenas are updated in place: a gate's level
is one more than the levels of the values it reads, so within a level every
kind reads values of earlier levels only and writes fresh SSA values, and
no read sees a write of its own level.  That holds at any depth, so deep
circuits run here level by level too.  reverie_tpu sends circuits deeper
than 128 levels to its scan executor only because XLA compiles the
levelized trace unrolled; eager execution has no compile cost per level.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..circuit.compile import (
    B2A_CORR,
    B2A_OUT,
    G_ADD,
    G_ADDC,
    G_ASSERT,
    G_CONST,
    G_INPUT,
    G_MUL,
    G_MULC,
    G_RANDOM,
    G_SUBC,
    GF2,
    N_KINDS,
    Z_SUB,
    CompiledCircuit,
)
from .profiling import annotate

PROVER = 0
VERIFY_ONL = 1
VERIFY_PRE = 2

#: a compiled gate kind's name (circuit.compile's G_*, Z_SUB, B2A_*)
KIND_NAMES = ("INPUT", "ADD", "ADDC", "SUBC", "MULC", "MUL", "ASSERT", "RANDOM", "CONST",
              "SUB", "B2A_CORR", "B2A_OUT")
#: the profiler range of a level's step of one table key (domain, kind):
#: "executor.<gf2|z64>.<KIND>", the level kept out of the name
STEP_NAMES = tuple(f"executor.{'gf2' if d == GF2 else 'z64'}.{k}"
                   for d in range(2) for k in KIND_NAMES)


def _parity8(x: torch.Tensor) -> torch.Tensor:
    t = x ^ (x >> 4)
    t = t ^ (t >> 2)
    t = t ^ (t >> 1)
    return t & 1


def _expand(c: torch.Tensor) -> torch.Tensor:
    """0/1 uint8 -> 0x00/0xFF (the hash byte form)."""
    return torch.zeros_like(c) - c


def _recon_sum(x: torch.Tensor) -> torch.Tensor:
    """Reconstruct z64 shares: (k, 8, R) int64 -> (k, R), the sum over the
    players mod 2^64."""
    return x.sum(dim=1)


def _compose_bits(bits: torch.Tensor) -> torch.Tensor:
    """(k, 64, R) 0/1 uint8 -> (k, R) int64 with bit i = wire i.  The
    terms are distinct powers of two, so their wrapping sum is their OR."""
    sh = torch.arange(64, dtype=torch.int64, device=bits.device)[None, :, None]
    return (bits.to(torch.int64) << sh).sum(dim=1)


def _word_bytes(x: torch.Tensor) -> torch.Tensor:
    """(k, R) int64 -> (8k, R) uint8 transcript rows, row 8e + j = byte j
    (little-endian) of word e, permuted from the words' byte view (no
    byte is widened to an int64)."""
    k, R = x.shape
    b = x.contiguous().view(torch.uint8).reshape(k, R, 8)
    return b.permute(0, 2, 1).reshape(8 * k, R)


def _share_bytes(s: torch.Tensor) -> torch.Tensor:
    """(k, 8, R) int64 shares -> (64k, R) uint8 transcript rows, row
    64e + 8p + j = byte j of player p's share of event e."""
    k, P, R = s.shape
    b = s.contiguous().view(torch.uint8).reshape(k, P, R, 8)
    return b.permute(0, 1, 3, 2).reshape(64 * k, R)


def _classify(idx: np.ndarray):
    """('const', v) | ('arith', start, step) | ('gather', None)."""
    k = len(idx)
    if k == 0:
        return ("gather", None)
    if np.all(idx == idx[0]):
        return ("const", int(idx[0]))
    d = np.diff(idx.astype(np.int64))
    if np.all(d == d[0]) and d[0] > 0:
        return ("arith", int(idx[0]), int(d[0]))
    return ("gather", None)


def take(src: torch.Tensor, meta: tuple, index=None) -> torch.Tensor:
    """Rows of src for one lowered index column (meta as in
    tables_to_device): a broadcast row, a (strided) slice, or a gather with
    the column's device `index`."""
    kind, *rest = meta
    if kind == "const":
        v, k = rest
        return src[v : v + 1].expand(k, *src.shape[1:])
    if kind == "arith":
        start, step, k = rest
        return src[start : start + (k - 1) * step + 1 : step]
    return src.index_select(0, index)


def event_rows(starts, width: int) -> np.ndarray:
    """Stream rows of events that start at `starts`, `width` rows each."""
    return (np.asarray(starts, np.int64)[:, None] + np.arange(width)).reshape(-1)


def _derived_rows(kind: int, cols: dict):
    """The z64 kinds' derived transcript-row columns (tpu.py _prep_tables):
    (name, base column, rows per event).  A share event is 64 stream rows,
    a word event 8, and B2A_OUT's 64 bit events are 64 GF(2) rows."""
    if kind in (G_MUL, G_ASSERT) and "onl" in cols:
        yield "onl_rows", "onl", 64
    if kind in (G_MUL, B2A_CORR) and "pre" in cols:
        yield "pre_rows", "pre", 8
    if kind == G_INPUT and "onl" in cols:
        yield "onl_rows", "onl", 8
    if kind == B2A_OUT:
        yield "onl_rows", "onl", 64
        yield "rec_rows", "rec", 64


def tables_to_device(cc: CompiledCircuit, device: torch.device
                     ) -> Tuple[Dict[str, tuple], Dict[str, torch.Tensor]]:
    """Lower the compiled index columns once: `meta[name]` is
    ('const', v, k) | ('arith', start, step, k) | ('gather', None, k) and
    `tables[name]` holds the device int64 index tensor of every 'gather'
    column, the GF(2) constants as 0/1 uint8 ('cbit') and the z64 constants
    as int64 ('cz').  B2A's (k, 64) 'bits' columns are lowered flat, and
    the z64 kinds' event rows are derived columns (_derived_rows).  Names are
    '<level>.<key>.<column>'."""
    meta: Dict[str, tuple] = {}
    tables: Dict[str, torch.Tensor] = {}

    def lower(name: str, col) -> None:
        col = np.asarray(col, np.int64).reshape(-1)
        m = _classify(col)
        meta[name] = m + (len(col),)
        if m[0] == "gather":
            tables[name] = torch.from_numpy(col).to(device)

    for li, table in enumerate(cc.levels):
        for key, cols in table.items():
            domain, kind = divmod(key, N_KINDS)
            pre = f"{li}.{key}."
            for name, arr in cols.items():
                if name != "const":
                    lower(pre + name, arr)
                elif domain == GF2:
                    cbit = (np.asarray(arr) & 1).astype(np.uint8)
                    tables[pre + "cbit"] = torch.from_numpy(cbit).to(device)
                else:
                    cz = np.asarray(arr, np.uint64).view(np.int64)
                    tables[pre + "cz"] = torch.from_numpy(cz).to(device)
            if domain != GF2:
                for name, base, width in _derived_rows(kind, cols):
                    lower(pre + name, event_rows(cols[base], width))
    return meta, tables


def carry_arena(n_rows: int, R: int, carried=None, lead=(), dtype=torch.uint8,
                device=None) -> torch.Tensor:
    """A value arena (n_rows, *lead, R) with the segment carry contract
    (reverie_tpu/backend/tpu.py carry_arena): row 0 is the zero value,
    rows 1..k the carried rows in order, the rest zeros."""
    arena = torch.zeros((n_rows, *lead, R), dtype=dtype, device=device)
    if carried is not None and carried.shape[0]:
        arena[1 : 1 + carried.shape[0]] = carried
    return arena


def _dead_dst_columns(cc: CompiledCircuit, carry_out_vals=None,
                      carry_outz_vals=None) -> Dict[tuple, bool]:
    """(level, key) -> True when no later gate, and no segment carry-out,
    reads the column's dst values: their arena writes are skipped
    (transcripts are unchanged).  GF(2) and z64 values are numbered apart,
    so their liveness is kept apart; B2A gates read GF(2) values through
    'bits' and B2A_OUT reads a z64 value through 'zr'."""
    read = (np.zeros(cc.n_vals2 + 1, bool), np.zeros(cc.n_valsz + 1, bool))
    for tgt, vals in zip(read, (carry_out_vals, carry_outz_vals)):
        if vals is not None:
            tgt[np.asarray(vals, np.int64)] = True
    for table in cc.levels:
        for key, cols in table.items():
            tgt = read[key // N_KINDS != GF2]
            for nm in ("a", "b"):
                if nm in cols:
                    tgt[np.asarray(cols[nm], np.int64)] = True
            if "zr" in cols:
                read[1][np.asarray(cols["zr"], np.int64)] = True
            if "bits" in cols:
                read[0][np.asarray(cols["bits"], np.int64).reshape(-1)] = True
    return {
        (li, key): not bool(
            read[key // N_KINDS != GF2][np.asarray(cols["dst"], np.int64)].any())
        for li, table in enumerate(cc.levels)
        for key, cols in table.items()
        if "dst" in cols
    }


def _arena_rows(cc: CompiledCircuit, dead: Dict[tuple, bool], carry_in: int = 0,
                carry_out_vals=None, carry_inz: int = 0,
                carry_outz_vals=None) -> Tuple[int, int]:
    """(L2, Lz): per domain, 1 + the highest arena row any gate reads or
    (live) writes, a carry-in fills or a carry-out reads."""
    hi = [carry_in, carry_inz]
    for z, vals in enumerate((carry_out_vals, carry_outz_vals)):
        if vals is not None and len(vals):
            hi[z] = max(hi[z], int(np.max(vals)))
    for li, table in enumerate(cc.levels):
        for key, cols in table.items():
            z = int(key // N_KINDS != GF2)
            names = ["a", "b"] + ([] if dead.get((li, key), False) else ["dst"])
            for nm in names:
                if nm in cols and len(cols[nm]):
                    hi[z] = max(hi[z], int(np.max(cols[nm])))
            if "zr" in cols and len(cols["zr"]):
                hi[1] = max(hi[1], int(np.max(cols["zr"])))
            if "bits" in cols and np.size(cols["bits"]):
                hi[0] = max(hi[0], int(np.max(cols["bits"])))
    return min(cc.n_vals2, hi[0] + 1), min(cc.n_valsz, hi[1] + 1)


def stream_bytes(cc: CompiledCircuit, R: int) -> int:
    """Bytes of the four (rows, R) uint8 streams a run returns (an empty
    stream is one row)."""
    return sum(max(n, 1) for n in (cc.onl2, cc.pre2, cc.onlz, cc.prez)) * R


def prover_bytes(cc: CompiledCircuit, R: int) -> int:
    """Device bytes a PROVER run at R lanes holds at its end, the index
    tables apart (table_bytes):

      inputs    tape (m2, R) uint8 (the tape kernel does not pad m2),
                tapez (mz, 8, R) int64, wit2 (n_wit2, R) uint8, witz
                (n_witz, R) int64
      arenas    mask2 + corr2 (L2, R) uint8, maskz (Lz, 8, R) and corrz
                (Lz, R) int64
      streams   three times over: each level's parts, their concatenation
                and one level's temporaries"""
    L2, Lz = _arena_rows(cc, _dead_dst_columns(cc))
    inputs = cc.m2 * R + cc.mz * 8 * R * 8 + cc.n_wit2 * R + cc.n_witz * R * 8
    return inputs + 2 * L2 * R + Lz * R * (8 * 8 + 8) + 3 * stream_bytes(cc, R)


def table_bytes(cc: CompiledCircuit) -> int:
    """Bytes of the device index and constant tables (tables_to_device)."""
    _, tables = tables_to_device(cc, torch.device("meta"))
    return sum(t.numel() * t.element_size() for t in tables.values())


class Executor:
    """Eager executor for one compiled circuit in one role.

    Call with an input dict: 'tape' (m2, R) uint8 and 'tapez' (mz, 8, R)
    int64, plus 'wit2' (n_wit2, R) uint8 and 'witz' (n_witz, R) int64 in
    PROVER mode, or 'in2', 'co2', 're2' (rows, R) uint8 and 'inz', 'coz'
    (rows, R) and 'rez' (rows, 8, R) int64 in VERIFY_ONL mode.  Returns
    {'onl2', 'pre2', 'onlz', 'prez': (rows, R) uint8, 'fail': (R,) bool}.

    The segment carries of streaming (reverie_tpu/backend/tpu.py:180-200):
    with carry_in = k, GF(2) arena rows 1..k start from the inputs
    'carry_mask2' and 'carry_corr2' (k, R) uint8, and with carry_out_vals
    the outputs gain those rows of the final arenas; carry_inz and
    carry_outz_vals the same for the z64 arenas, 'carry_maskz' (k, 8, R)
    and 'carry_corrz' (k, R) int64."""

    def __init__(self, cc: CompiledCircuit, mode: int, total_reps: int,
                 device: torch.device, carry_in: int = 0, carry_out_vals=None,
                 carry_inz: int = 0, carry_outz_vals=None):
        self.cc = cc
        self.mode = mode
        self.R = total_reps
        self.device = device
        self.carry_in, self.carry_inz = carry_in, carry_inz
        self.carry_out_vals, self.carry_outz_vals = (
            None if v is None or len(v) == 0 else np.asarray(v, np.int64)
            for v in (carry_out_vals, carry_outz_vals))
        self.meta, self.tables = tables_to_device(cc, device)
        for name, vals in (("carry_out_vals", self.carry_out_vals),
                           ("carry_outz_vals", self.carry_outz_vals)):
            if vals is not None:
                self.tables[name] = torch.from_numpy(vals).to(device)
        self._dead = _dead_dst_columns(cc, self.carry_out_vals, self.carry_outz_vals)
        self._rows2, self._rowsz = _arena_rows(cc, self._dead, carry_in, self.carry_out_vals,
                                               carry_inz, self.carry_outz_vals)

    def __call__(self, inp: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        cc, R, dev = self.cc, self.R, self.device
        c2 = inp if self.carry_in else {}
        cz = inp if self.carry_inz else {}
        st = dict(
            mask2=carry_arena(self._rows2, R, c2.get("carry_mask2"), device=dev),
            corr2=carry_arena(self._rows2, R, c2.get("carry_corr2"), device=dev),
            maskz=carry_arena(self._rowsz, R, cz.get("carry_maskz"), (8,), torch.int64, dev),
            corrz=carry_arena(self._rowsz, R, cz.get("carry_corrz"), (), torch.int64, dev),
            fail=torch.zeros((R,), dtype=torch.bool, device=dev),
            pending={"onl2": [], "pre2": [], "onlz": [], "prez": []},
        )
        for li, table in enumerate(cc.levels):
            for key in sorted(table):
                domain, kind = divmod(key, N_KINDS)
                run = self._gf2_kind if domain == GF2 else self._z64_kind
                with annotate(STEP_NAMES[key]):
                    run(st, inp, kind, _Acc(self, li, key))
        out = {"fail": st["fail"]}
        with annotate("executor.assemble"):
            for name, n_rows in (("onl2", cc.onl2), ("pre2", cc.pre2),
                                 ("onlz", cc.onlz), ("prez", cc.prez)):
                out[name] = _assemble_stream(st["pending"][name], n_rows, R, dev)
        if self.carry_out_vals is not None:
            vals = self.tables["carry_out_vals"]
            out["carry_mask2"] = st["mask2"].index_select(0, vals)
            out["carry_corr2"] = st["corr2"].index_select(0, vals)
        if self.carry_outz_vals is not None:
            vals = self.tables["carry_outz_vals"]
            out["carry_maskz"] = st["maskz"].index_select(0, vals)
            out["carry_corrz"] = st["corrz"].index_select(0, vals)
        return out

    def _gf2_kind(self, st, inp, kind: int, A: "_Acc") -> None:
        mode = self.mode
        mask2, corr2 = st["mask2"], st["corr2"]
        if kind == G_INPUT:
            m = A.take(inp["tape"], "tape")
            if mode == PROVER:
                corr = A.take(inp["wit2"], "wit") ^ _parity8(m)
            elif mode == VERIFY_ONL:
                corr = A.take(inp["in2"], "rec")
            else:
                corr = torch.zeros_like(m)
            if mode != VERIFY_PRE:
                A.put_stream(st, "onl2", "onl", _expand(corr))
            A.put_dst(mask2, m)
            A.put_dst(corr2, corr)
        elif kind == G_ADD:
            a, b = A.take(mask2, "a"), A.take(mask2, "b")
            ac, bc = A.take(corr2, "a"), A.take(corr2, "b")
            A.put_dst(mask2, a ^ b)
            A.put_dst(corr2, ac ^ bc)
        elif kind in (G_ADDC, G_SUBC):
            a, ac = A.take(mask2, "a"), A.take(corr2, "a")
            A.put_dst(mask2, a)
            A.put_dst(corr2, ac ^ A.arr("cbit")[:, None])
        elif kind == G_MULC:
            a, ac = A.take(mask2, "a"), A.take(corr2, "a")
            cbit = A.arr("cbit")[:, None]
            A.put_dst(mask2, a & _expand(cbit))
            A.put_dst(corr2, ac & cbit)
        elif kind == G_MUL:
            a, b = A.take(mask2, "a"), A.take(mask2, "b")
            ac, bc = A.take(corr2, "a"), A.take(corr2, "b")
            m_ab, m_new = A.take_tape_pair(inp["tape"], "tape_ab", "tape_new")
            if mode == VERIFY_ONL:
                delta = A.take(inp["co2"], "corr")
            else:
                delta = (_parity8(a) & _parity8(b)) ^ _parity8(m_ab)
            A.put_stream(st, "pre2", "pre", _expand(delta))
            s = (b & _expand(ac)) ^ (a & _expand(bc)) ^ m_ab ^ m_new
            if mode == VERIFY_ONL:
                s = s ^ A.take(inp["re2"], "rec")
            if mode != VERIFY_PRE:
                A.put_stream(st, "onl2", "onl", s)
                recon = _parity8(s) ^ delta
            else:
                recon = torch.zeros_like(s)  # junk (verifier/preprocess.rs:63-65)
            corr = recon ^ (ac & bc)
            A.put_dst(mask2, m_new)
            A.put_dst(corr2, corr)
        elif kind == G_ASSERT:
            if mode == VERIFY_PRE:
                return
            s, ac = A.take(mask2, "a"), A.take(corr2, "a")
            if mode == VERIFY_ONL:
                s = s ^ A.take(inp["re2"], "rec")
            A.put_stream(st, "onl2", "onl", s)
            st["fail"] |= ((_parity8(s) ^ ac) != 0).any(dim=0)
        elif kind == G_RANDOM:
            A.put_dst(mask2, A.take(inp["tape"], "tape"))
        elif kind == G_CONST:
            cbit = A.arr("cbit")
            A.put_dst(corr2, cbit[:, None].expand(cbit.shape[0], self.R))
        else:
            raise ValueError(f"bad gf2 kind {kind}")

    def _z64_kind(self, st, inp, kind: int, A: "_Acc") -> None:
        mode = self.mode
        maskz, corrz = st["maskz"], st["corrz"]

        def put(mask, corr) -> None:
            A.put_dst(maskz, mask)
            A.put_dst(corrz, corr)

        if kind == G_INPUT:
            m = A.take(inp["tapez"], "tape")
            if mode == PROVER:
                corr = A.take(inp["witz"], "wit") - _recon_sum(m)
            elif mode == VERIFY_ONL:
                corr = A.take(inp["inz"], "rec")
            else:
                corr = torch.zeros_like(m[:, 0])
            if mode != VERIFY_PRE:
                A.put_stream(st, "onlz", "onl_rows", _word_bytes(corr))
            put(m, corr)
        elif kind in (G_ADD, Z_SUB):
            a, b = A.take(maskz, "a"), A.take(maskz, "b")
            ac, bc = A.take(corrz, "a"), A.take(corrz, "b")
            if kind == G_ADD:
                put(a + b, ac + bc)
            else:
                put(a - b, ac - bc)
        elif kind in (G_ADDC, G_SUBC):
            a, ac = A.take(maskz, "a"), A.take(corrz, "a")
            cz = A.arr("cz")[:, None]
            put(a, ac + cz if kind == G_ADDC else ac - cz)
        elif kind == G_MULC:
            a, ac = A.take(maskz, "a"), A.take(corrz, "a")
            cz = A.arr("cz")[:, None]
            put(a * cz[:, None], ac * cz)
        elif kind == G_MUL:
            a, b = A.take(maskz, "a"), A.take(maskz, "b")
            ac, bc = A.take(corrz, "a"), A.take(corrz, "b")
            m_ab, m_new = A.take_tape_pair(inp["tapez"], "tape_ab", "tape_new")
            if mode == VERIFY_ONL:
                delta = A.take(inp["coz"], "corr")
            else:
                delta = _recon_sum(a) * _recon_sum(b) - _recon_sum(m_ab)
            A.put_stream(st, "prez", "pre_rows", _word_bytes(delta))
            s = b * ac[:, None] + a * bc[:, None] + m_ab - m_new
            if mode == VERIFY_ONL:
                s = s + A.take(inp["rez"], "rec")
            if mode != VERIFY_PRE:
                A.put_stream(st, "onlz", "onl_rows", _share_bytes(s))
                recon = _recon_sum(s) + delta
            else:
                recon = torch.zeros_like(delta)  # junk (verifier/preprocess.rs:63-65)
            put(m_new, recon + ac * bc)
        elif kind == G_ASSERT:
            if mode == VERIFY_PRE:
                return
            s, ac = A.take(maskz, "a"), A.take(corrz, "a")
            if mode == VERIFY_ONL:
                s = s + A.take(inp["rez"], "rec")
            A.put_stream(st, "onlz", "onl_rows", _share_bytes(s))
            st["fail"] |= ((_recon_sum(s) + ac) != 0).any(dim=0)
        elif kind == G_RANDOM:
            A.put_dst(maskz, A.take(inp["tapez"], "tape"))
        elif kind == G_CONST:
            cz = A.arr("cz")
            A.put_dst(corrz, cz[:, None].expand(cz.shape[0], self.R))
        elif kind == B2A_CORR:
            # the z64 mask r of a B2A and its correction: the 64 fresh GF(2)
            # masks composed into one word, minus the z64 mask's value
            bits = _parity8(A.take(st["mask2"], "bits")).reshape(-1, 64, self.R)
            m = A.take(inp["tapez"], "tape")
            if mode == VERIFY_ONL:
                corr = A.take(inp["coz"], "corr")
            else:
                corr = _compose_bits(bits) - _recon_sum(m)
            A.put_stream(st, "prez", "pre_rows", _word_bytes(corr))
            put(m, corr)
        elif kind == B2A_OUT:
            # 64 GF(2) bit reconstructions (onl2 events), composed into the
            # z64 destination: value - r, with the mask of -r
            s = A.take(st["mask2"], "bits")  # (64k, R)
            bc = A.take(st["corr2"], "bits")
            if mode == VERIFY_ONL:
                s = s ^ A.take(inp["re2"], "rec_rows")
            if mode != VERIFY_PRE:
                A.put_stream(st, "onl2", "onl_rows", s)
                bits = _parity8(s) ^ bc
            else:
                bits = bc  # junk: recon is zero in preprocess mode
            value = _compose_bits(bits.reshape(-1, 64, self.R))
            put(-A.take(maskz, "zr"), value - A.take(corrz, "zr"))
        else:
            raise ValueError(f"bad z64 kind {kind}")


def _assemble_stream(parts, n_rows: int, R: int, device) -> torch.Tensor:
    """parts: [(acc, column, vals)] in trace order.  Concatenate when the
    step-1 put windows exactly tile [0, n_rows); otherwise zeros + ordered
    put replay (same bytes either way).  Always contiguous."""
    if n_rows == 0 or not parts:
        return torch.zeros((max(n_rows, 1), R), dtype=torch.uint8, device=device)
    runs = []
    for acc, name, vals in parts:
        kind, *rest = acc.meta(name)
        if kind == "arith" and rest[1] == 1:
            runs.append((rest[0], rest[2], vals))
        elif kind == "const" and rest[1] == 1:
            runs.append((rest[0], 1, vals))
        else:
            runs = None
            break
    if runs is not None:
        runs.sort(key=lambda t: t[0])
        pos = 0
        for start, k, _ in runs:
            if start != pos:
                break
            pos += k
        if pos == n_rows:
            return torch.cat([v for _, _, v in runs]).contiguous()
    buf = torch.zeros((n_rows, R), dtype=torch.uint8, device=device)
    for acc, name, vals in parts:
        acc.put(buf, name, vals)
    return buf


class _Acc:
    """Per-(level, kind) column accessor: constant / arithmetic index
    columns become broadcasts and (strided) slices, the rest gathers."""

    def __init__(self, ex: Executor, li: int, key: int):
        self.ex = ex
        self.pre = f"{li}.{key}."
        #: no later gate reads this column's dst values -> skip arena puts
        self.dead_dst = ex._dead.get((li, key), False)

    def meta(self, name: str) -> tuple:
        return self.ex.meta[self.pre + name]

    def arr(self, name: str) -> torch.Tensor:
        return self.ex.tables[self.pre + name]

    def take(self, src: torch.Tensor, name: str) -> torch.Tensor:
        return take(src, self.meta(name), self.ex.tables.get(self.pre + name))

    def take_tape_pair(self, tape: torch.Tensor, name_a: str, name_b: str):
        """The MUL tape pair: when tape_ab is the stride-2 run a0, a0+2, ...
        and tape_new the run a0+1, a0+3, ..., two strided views of the one
        tape; otherwise two takes."""
        ma, mb = self.meta(name_a), self.meta(name_b)
        if (ma[0] == "arith" and mb[0] == "arith" and ma[2] == 2 and mb[2] == 2
                and mb[1] == ma[1] + 1 and ma[3] == mb[3]):
            a0, k = ma[1], ma[3]
            return tape[a0::2][:k], tape[a0 + 1 :: 2][:k]
        return self.take(tape, name_a), self.take(tape, name_b)

    def put_stream(self, st, buf_name: str, name: str, vals) -> None:
        """Deferred stream write, assembled once per call
        (_assemble_stream)."""
        st["pending"][buf_name].append((self, name, vals))

    def put_dst(self, buf: torch.Tensor, vals: torch.Tensor) -> None:
        """In-place arena write at the dst column, skipped when the column
        is dead."""
        if not self.dead_dst:
            self.put(buf, "dst", vals)

    def put(self, buf: torch.Tensor, name: str, vals: torch.Tensor) -> None:
        kind, *rest = self.meta(name)
        if vals.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr():
            # a view of other rows of the same arena (ADDC/SUBC copy the
            # mask through): torch refuses copies within one storage
            vals = vals.clone()
        if kind == "const":
            v, k = rest
            if k != 1:
                raise ValueError("duplicate scatter rows")
            buf[v : v + 1] = vals
        elif kind == "arith":
            start, step, k = rest
            buf[start : start + (k - 1) * step + 1 : step] = vals
        else:
            buf.index_copy_(0, self.arr(name), vals.contiguous())
