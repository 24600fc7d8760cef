"""Levelized batched KKW execution of the GF(2) kinds in PyTorch.

Port of reverie_tpu/backend/tpu.py (`Executor`, `_gf2_kind`, `_Acc`,
`_classify`, `_assemble_stream`, `_parity8`, `_expand`, `_dead_dst_columns`,
`_arena_rows`).  Every gate of a level runs as one vector op over all
repetitions:

  mask arena : (V, R) uint8 -- byte r = the 8 player bits of rep r
               (bit 7-p = player p, the reference byte layout)
  corr arena : (V, R) uint8 -- 0/1 per rep
  tape       : (m2, R) uint8 -- the AES-CTR mask tape (aes_tape.py)

Transcript rows land at their compile-time offsets in the (stream_len, R)
onl2 / pre2 streams, so each column is byte-identical to the reference's
sequential absorption.  Index columns that are constant or arithmetic runs
become broadcasts and (strided) slices; the rest are device int64 gathers.

PyTorch runs eagerly, and the arenas are updated in place: within a level
every kind reads values of earlier levels only and writes fresh SSA values,
so no read sees a write of its own level.

Scope: GF(2) kinds in the levelized executor.  Z64 and B2A kinds, streaming
carries and the scan executor for deep circuits are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from reverie_tpu.circuit.compile import (
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
    CompiledCircuit,
)

PROVER = 0
VERIFY_ONL = 1
VERIFY_PRE = 2

#: depth beyond which reverie_tpu switches to its scan executor
SCAN_DEPTH_THRESHOLD = 128


def check_supported(cc: CompiledCircuit) -> None:
    """Raise NotImplementedError for what this slice does not run."""
    z64 = cc.mz > 0 or any(key // N_KINDS != GF2
                           for table in cc.levels for key in table)
    if z64:
        raise NotImplementedError(
            "reverie_tpu_torch runs GF(2) circuits only: Z64 and B2A gates "
            "are ROADMAP Queue 1 item 7")
    if cc.depth > SCAN_DEPTH_THRESHOLD:
        raise NotImplementedError(
            f"circuit depth {cc.depth} > {SCAN_DEPTH_THRESHOLD}: the scan "
            "executor for deep circuits is ROADMAP Queue 1 item 9")


def _parity8(x: torch.Tensor) -> torch.Tensor:
    t = x ^ (x >> 4)
    t = t ^ (t >> 2)
    t = t ^ (t >> 1)
    return t & 1


def _expand(c: torch.Tensor) -> torch.Tensor:
    """0/1 uint8 -> 0x00/0xFF (the hash byte form)."""
    return torch.zeros_like(c) - c


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


def tables_to_device(cc: CompiledCircuit, device: torch.device
                     ) -> Tuple[Dict[str, tuple], Dict[str, torch.Tensor]]:
    """Lower the compiled index columns once: `meta[name]` is
    ('const', v, k) | ('arith', start, step, k) | ('gather', None, k) and
    `tables[name]` holds the device int64 index tensor of every 'gather'
    column and the 0/1 uint8 constant bits ('cbit').  Names are
    '<level>.<key>.<column>'."""
    meta: Dict[str, tuple] = {}
    tables: Dict[str, torch.Tensor] = {}
    for li, table in enumerate(cc.levels):
        for key, cols in table.items():
            pre = f"{li}.{key}."
            for name, arr in cols.items():
                if name == "const":
                    cbit = (np.asarray(arr) & 1).astype(np.uint8)
                    tables[pre + "cbit"] = torch.from_numpy(cbit).to(device)
                    continue
                col = np.asarray(arr, np.int64)
                m = _classify(col)
                meta[pre + name] = m + (len(col),)
                if m[0] == "gather":
                    tables[pre + name] = torch.from_numpy(col).to(device)
    return meta, tables


def _dead_dst_columns(cc: CompiledCircuit) -> Dict[tuple, bool]:
    """(level, key) -> True when no later gate reads the column's dst
    values: their arena writes are skipped (transcripts are unchanged)."""
    read = np.zeros(cc.n_vals2 + 1, bool)
    for table in cc.levels:
        for cols in table.values():
            for nm in ("a", "b"):
                if nm in cols:
                    read[np.asarray(cols[nm], np.int64)] = True
    return {
        (li, key): not bool(read[np.asarray(cols["dst"], np.int64)].any())
        for li, table in enumerate(cc.levels)
        for key, cols in table.items()
        if "dst" in cols
    }


def _arena_rows(cc: CompiledCircuit, dead: Dict[tuple, bool]) -> int:
    """1 + the highest arena row any gate reads or (live) writes."""
    hi = 0
    for li, table in enumerate(cc.levels):
        for key, cols in table.items():
            names = ["a", "b"] + ([] if dead.get((li, key), False) else ["dst"])
            for nm in names:
                if nm in cols and len(cols[nm]):
                    hi = max(hi, int(np.max(cols[nm])))
    return min(cc.n_vals2, hi + 1)


class Executor:
    """Eager executor for one compiled GF(2) circuit in one role.

    Call with an input dict: 'tape' (m2, R) uint8, plus 'wit2' (n_wit2, R)
    in PROVER mode, or 'in2', 'co2', 're2' (rows, R) in VERIFY_ONL mode.
    Returns {'onl2': (onl2, R), 'pre2': (pre2, R) uint8, 'fail': (R,)
    bool}."""

    def __init__(self, cc: CompiledCircuit, mode: int, total_reps: int,
                 device: torch.device):
        check_supported(cc)
        self.cc = cc
        self.mode = mode
        self.R = total_reps
        self.device = device
        self.meta, self.tables = tables_to_device(cc, device)
        self._dead = _dead_dst_columns(cc)
        self._rows = _arena_rows(cc, self._dead)

    def __call__(self, inp: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        cc, R = self.cc, self.R
        z = dict(dtype=torch.uint8, device=self.device)
        st = dict(
            mask2=torch.zeros((self._rows, R), **z),
            corr2=torch.zeros((self._rows, R), **z),
            fail=torch.zeros((R,), dtype=torch.bool, device=self.device),
            pending={"onl2": [], "pre2": []},
        )
        for li, table in enumerate(cc.levels):
            for key in sorted(table):
                self._gf2_kind(st, inp, key % N_KINDS, _Acc(self, li, key))
        out = {"fail": st["fail"]}
        for name, n_rows in (("onl2", cc.onl2), ("pre2", cc.pre2)):
            out[name] = _assemble_stream(st["pending"][name], n_rows, R,
                                         self.device)
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
