"""Wave executor for deep circuits (SHA-256: 5,198 levels).

Port of reverie_tpu/backend/tpu_scan.py: `default_wave_width` (:96),
`ScanExecutor` (:120) and the bodies of its `lax.scan`,
`_scan_trace_fast2` (:247) for pure-GF(2) circuits and `_scan_trace`
(:374-804) for circuits with Z_2^64 and B2A gates.  The gates are packed
into uniform, NOP-padded waves of W GF(2) slots and, where the circuit has
z64 gates, Wz z64 slots (circuit/compile.py `build_waves`); every operand
of a slot is produced in an earlier wave, so the slots of one wave are
independent and the waves run in order.  Where reverie_tpu compiles the
whole scan into one device program per role, the port runs it as one
launch per executor call (`wave_run`): of the CUDA kernel W1
`csrc/scan_gf2.cu` for pure-GF(2) circuits, of W2 `csrc/scan_z64.cu` for
the others, which runs both halves of each wave between the same barriers
on W1's GF(2) slot code (`csrc/scan_core.cuh`).  On the CPU the plain
version `wave_ref` (`wave_gf2_ref` for GF(2) tables) applies one wave at a
time with torch ops: a wave's z64 slots, which read the GF(2) values of
earlier waves, then its GF(2) slots, as `_scan_trace`'s body orders them
(:691-706).

Before either runs, `allocate_waves` renumbers the tables' SSA values into
slots, per domain, by linear scan over their live intervals (SHA-256:
2,410 slots for 135,203 values): a B2A slot's 64 `bits` are reads of GF(2)
values, and a B2A_OUT's `zr` a read of a z64 value.  The kernels keep a
block's live values in shared memory and spill the longest-lived to global
arenas only past it; `launch_plan` picks the block width and the waves
staged at once from the live sets and R, and `pack_table` words the GF(2)
table for the kernel.  The z64 table (`zwave_table`: one row of int32
words a slot, its event rows as bases, the host checking that they are
runs, and its B2A bits as a row of a bits table) is worded for W2 by
`pack_ztable`: the input words each chunk of waves reads, listed for the
kernel to stage ahead of its waves.  A `WaveProgram` holds the result,
once per circuit, width and role (`circuit_program`); the plain version
runs the slot tables.

The segment carries of streaming (tpu_scan.py:128-227): values 1..k of a
domain start from the inputs 'carry_mask2' and 'carry_corr2' ((k, R)
uint8), 'carry_maskz' ((k, 8, R) int64) and 'carry_corrz' ((k, R) int64),
loaded into their slots before wave 0, and the carry-out values are stored
to the outputs of those names after the last wave.

Left out, as layouts of the TPU rather than the contract: the fast2
wave-contiguous renumbering and its u16 mask|corr arena (row scatters cost
~17 us on the TPU), the stacked per-wave outputs with their post-scan
inverse gather, the lo/hi u32 pairs of the z64 arenas (the port's are
int64), `zkinds`, `optimization_barrier` and REVERIE_SCAN_UNROLL.  The
contract is the output streams, `fail` and the carries.

The executor keeps the call contract of the levelized `Executor`: inputs
'tape' (m2, R) uint8 and 'tapez' (mz, 8, R) int64, plus 'wit2' (n_wit2, R)
uint8 and 'witz' (n_witz, R) int64 in PROVER mode, or 'in2', 'co2', 're2'
(rows, R) uint8 and 'inz', 'coz' (rows, R), 'rez' (rows, 8, R) int64 in
VERIFY_ONL mode; outputs 'onl2', 'pre2', 'onlz', 'prez' (max(rows, 1), R)
uint8 and 'fail' (R,) bool.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import heapq
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import _build
from ..roofline import SMS
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
    Z_SUB,
    CompiledCircuit,
    _NOP,
    WaveTable,
    build_waves,
)
from .executor import (
    PROVER,
    VERIFY_ONL,
    VERIFY_PRE,
    _compose_bits,
    _expand,
    _parity8,
    _share_bytes,
    _word_bytes,
    stream_bytes,
)

#: kernel launches made by `wave_run` (CUDA tensors only): of W1
#: (csrc/scan_gf2.cu) and of W2 (csrc/scan_z64.cu)
LAUNCHES = 0
LAUNCHES_Z64 = 0

#: int32 columns of one slot of a packed wave table (`wave_table`); xin is
#: the witness row (PROVER) or the input record (VERIFY_ONL)
SLOT_COLS = ("op", "dst", "a", "b", "t0", "t1", "xin", "rec", "corr", "onl", "pre", "cbit")
_OP, _DST, _A, _B, _T0, _T1, _XIN, _REC, _CORR, _ONL, _PRE, _CBIT = range(len(SLOT_COLS))

#: int32 words of one z64 slot (`zwave_table`), the W2 kernel's form: b is
#: the z64 mask r (`zr`) of a B2A_OUT; bits the slot's row of the bits table
#: (B2A); xin the witness row (PROVER INPUT) or the input record (VERIFY_ONL
#: INPUT); onl, pre, brec and bonl the first rows of the slot's events;
#: clo, chi the constant's words
ZSLOT_COLS = ("op", "dst", "a", "b", "bits", "t0", "t1", "xin", "rec", "corr", "onl", "pre",
              "clo", "chi", "brec", "bonl")
(_ZOP, _ZDST, _ZA, _ZB, _ZBITS, _ZT0, _ZT1, _ZXIN, _ZREC, _ZCORR, _ZONL, _ZPRE, _ZCLO, _ZCHI,
 _ZBREC, _ZBONL) = range(len(ZSLOT_COLS))
#: bytes of one live z64 value a rep: 8 players' mask words and the
#: correction word
ZBYTES = 72
#: int32 words of one packed z64 slot (pack_ztable): op | dst << 8, a, b,
#: its first staged word | its bits row << 16 (both counted from its
#: chunk's first), onl (bonl for a B2A_OUT), pre, the constant's lo and hi
#: words (csrc/scan_z64.cu `decode`)
ZPACKED_WORDS = 8
#: the sources of W2's staged words: (words a field takes, its row of the
#: source for word p): the tapez rows of a slot's tape row t (t * 8 + p),
#: its xinz or coz row, its rez rows (rec * 8 + p) and the 64 re2 bytes of a
#: B2A_OUT's bit records from brec on, eight rows a word of each rep
_ZSOURCES = {0: (8, lambda v, p: 8 * v + p), 1: (1, lambda v, p: v), 2: (1, lambda v, p: v),
             3: (8, lambda v, p: 8 * v + p), 4: (8, lambda v, p: v + 8 * p)}


def default_wave_width(cc: CompiledCircuit) -> int:
    """Adapt the wave width to the mean level occupancy: the next power of
    two at least the mean number of gates per level, from 8 up to 256."""
    n_gates = sum(
        len(next(iter(cols.values())))
        for lvl in cc.levels
        for cols in lvl.values()
    )
    mean = max(1, n_gates // max(1, cc.depth))
    wave_width = 8
    while wave_width < min(256, mean):
        wave_width *= 2
    return wave_width


def waves(cc: CompiledCircuit, wave_width: int = 0) -> WaveTable:
    """build_waves(cc, W), built once per circuit and width and kept on the
    circuit (it takes seconds on SHA-256, and every executor and footprint
    of one circuit shares it); W = 0 takes default_wave_width."""
    return circuit_waves(cc, wave_width).waves


def wave_table(wv: WaveTable, mode: int) -> np.ndarray:
    """The GF(2) slots of the waves as one (n_waves, W, 12) int32 array in
    SLOT_COLS order, the form `allocate_slots`, `wave_program` and
    `wave_gf2_ref` read.  A table with z64 slots has its z64 side in
    `zwave_table`."""
    xin = wv.wit if mode == PROVER else wv.inrec if mode == VERIFY_ONL else np.zeros_like(wv.op)
    cols = {"xin": xin, **{k: getattr(wv, k) for k in SLOT_COLS if k != "xin"}}
    return np.ascontiguousarray(np.stack([cols[k] for k in SLOT_COLS], axis=-1), dtype=np.int32)


#: z64 kinds' events: (WaveTable column, rows of the run from its first)
_ZRUNS = {G_MUL: (("zonl", 64), ("zpre", 8)), G_ASSERT: (("zonl", 64),),
          G_INPUT: (("zonl", 8),), B2A_CORR: (("zpre", 8),),
          B2A_OUT: (("brec", 64), ("bonl", 64))}
_ZBASE = {"zonl": _ZONL, "zpre": _ZPRE, "brec": _ZBREC, "bonl": _ZBONL}


def zwave_table(wv: WaveTable, mode: int) -> Tuple[np.ndarray, np.ndarray]:
    """The z64 slots of the waves -> (ztable (n_waves, Wz, 16) int32 in
    ZSLOT_COLS order, bits (n_b2a, 64) int32): a B2A slot's GF(2) values are
    row `bits` of the second array, in the order of the slots.  An event
    column (zonl, zpre, brec, bonl) becomes the first row of its run, the
    rows past the run being build_waves' trash; raises ValueError where a
    column is not a run.  Raises ValueError on a pure-GF(2) table."""
    if not wv.has_z64:
        raise ValueError("zwave_table: the waves have no z64 slots")
    op = wv.zop.astype(np.int64)
    t = np.zeros(op.shape + (len(ZSLOT_COLS),), dtype=np.int64)
    for col, src in ((_ZOP, wv.zop), (_ZDST, wv.zdst), (_ZA, wv.za), (_ZT0, wv.zt0),
                     (_ZT1, wv.zt1), (_ZREC, wv.zrec), (_ZCORR, wv.zcorr)):
        t[..., col] = src
    t[..., _ZB] = np.where(op == B2A_OUT, wv.zzr, wv.zb)
    xin = wv.zwit if mode == PROVER else wv.zinrec if mode == VERIFY_ONL else None
    if xin is not None:
        t[..., _ZXIN] = np.where(op == G_INPUT, xin, 0)
    t[..., _ZCLO] = wv.zclo.astype(np.uint32).view(np.int32)
    t[..., _ZCHI] = wv.zchi.astype(np.uint32).view(np.int32)
    for kind, runs in _ZRUNS.items():
        sel = op == kind
        for name, n in runs:
            rows = getattr(wv, name)[sel][:, :n].astype(np.int64)
            if not np.array_equal(rows, rows[:, :1] + np.arange(n)):
                raise ValueError(f"zwave_table: a {name} column of kind {kind} is not a run")
            t[..., _ZBASE[name]][sel] = rows[:, 0]
    b2a = np.isin(op, (B2A_CORR, B2A_OUT))
    t[..., _ZBITS][b2a] = np.arange(int(b2a.sum()))
    bits = np.asarray(wv.bbits)[b2a].reshape(-1, 64)
    return t.astype(np.int32), np.ascontiguousarray(bits, dtype=np.int32)


#: gate kinds that read operand a, and operand b (the others carry 0 there)
_READS_A = (G_ADD, G_ADDC, G_SUBC, G_MULC, G_MUL, G_ASSERT)
_READS_B = (G_ADD, G_MUL)

#: dynamic shared memory one block may take on sm_90 (the H100's 227 KB),
#: an SM's shared memory (228 KB), and what the runtime keeps of it for
#: each resident block (1 KB)
SMEM_PER_BLOCK = 232_448
SMEM_PER_SM = 233_472
SMEM_RESERVED = 1_024
#: waves the wave kernel stages in shared memory at once (a chunk), most
#: first.  A block holds two chunks of packed slots (PACKED_WORDS int32
#: each), two chunks of input fields (one int32 each) and one chunk of the
#: fields' bytes (one a rep)
CHUNKS = (32, 16, 8, 4)
#: W2's chunks: also 2 and 1, for the staged words of wide z64 waves (one
#: wave of build_waves' widest, 64 MULs, stages 102,400 bytes online at 8
#: reps a block)
ZCHUNKS = CHUNKS + (2, 1)
#: int32 words of one packed slot (pack_table): head (op | cbit << 7 |
#: dst << 8), a, b, onl, pre, its first input field, ma | mb << 16 and
#: kind | sub << 2 | k << 8 (csrc/scan_gf2.cu `decode`)
PACKED_WORDS = 8
#: what a slot does after its wave's barrier (csrc/scan_gf2.cu), 0 for
#: nothing: (A & ma) ^ (B & mb) ^ k, a MUL, an ASSERT_ZERO
_LINEAR, _MUL, _ASSERT = 1, 2, 3
#: the input bytes each gate kind reads, in order, by role: (source,
#: column) with sources 0 tape, 1 xin (wit2 or in2), 2 re2, 3 co2
_FIELDS = {
    PROVER: {G_RANDOM: ((0, _T0),), G_INPUT: ((0, _T0), (1, _XIN)),
             G_MUL: ((0, _T0), (0, _T1))},
    VERIFY_ONL: {G_RANDOM: ((0, _T0),), G_INPUT: ((0, _T0), (1, _XIN)),
                 G_MUL: ((0, _T0), (0, _T1), (2, _REC), (3, _CORR)), G_ASSERT: ((2, _REC),)},
    VERIFY_PRE: {G_RANDOM: ((0, _T0),), G_INPUT: ((0, _T0),), G_MUL: ((0, _T0), (0, _T1))},
}
#: reps (lanes) one block may own, most first, and the block's most threads
#: (W1; W2's blocks take at most MAX_THREADS_Z64, so that a thread may hold
#: 128 registers)
REPS_PER_BLOCK = (32, 16, 8)
MAX_THREADS = 1024
MAX_THREADS_Z64 = 512
#: slots a packed head can name (dst takes its top 24 bits)
MAX_SLOTS = 1 << 24


#: z64 kinds that read operand a, and operand b (B2A_OUT's b is zr)
_ZREADS_A = (G_ADD, Z_SUB, G_ADDC, G_SUBC, G_MULC, G_MUL, G_ASSERT)
_ZREADS_B = (G_ADD, Z_SUB, G_MUL, B2A_OUT)
_B2A = (B2A_CORR, B2A_OUT)
#: the staged words each z64 kind reads, in order, by role: (source,
#: zwave_table column) with _ZSOURCES' sources 0 tapez, 1 xinz (witz or
#: inz), 2 coz, 3 rez, 4 re2 (csrc/scan_z64.cu `exec`: a MUL's t0 words at
#: 0-7, t1 at 8-15, rez at 16-23, coz at 24)
_ZFIELDS = {
    PROVER: {G_INPUT: ((0, _ZT0), (1, _ZXIN)), G_RANDOM: ((0, _ZT0),),
             B2A_CORR: ((0, _ZT0),), G_MUL: ((0, _ZT0), (0, _ZT1))},
    VERIFY_ONL: {G_INPUT: ((0, _ZT0), (1, _ZXIN)), G_RANDOM: ((0, _ZT0),),
                 B2A_CORR: ((0, _ZT0), (2, _ZCORR)),
                 G_MUL: ((0, _ZT0), (0, _ZT1), (3, _ZREC), (2, _ZCORR)),
                 G_ASSERT: ((3, _ZREC),), B2A_OUT: ((4, _ZBREC),)},
    VERIFY_PRE: {G_INPUT: ((0, _ZT0),), G_RANDOM: ((0, _ZT0),), B2A_CORR: ((0, _ZT0),),
                 G_MUL: ((0, _ZT0), (0, _ZT1))},
}


@dataclasses.dataclass(frozen=True)
class Carry:
    """The segment carries of one executor: the first `n_in` values of the
    GF(2) domain (1..n_in) start from the segment before, and the values
    `out` are carried to the segments after; `n_inz`, `outz` the same for
    the z64 domain."""

    n_in: int = 0
    out: Tuple[int, ...] = ()
    n_inz: int = 0
    outz: Tuple[int, ...] = ()

    @staticmethod
    def of(carry_in: int = 0, carry_out_vals=None, carry_inz: int = 0,
           carry_outz_vals=None) -> "Carry":
        def vals(v):
            return () if v is None else tuple(int(x) for x in np.asarray(v).reshape(-1))
        return Carry(int(carry_in), vals(carry_out_vals), int(carry_inz), vals(carry_outz_vals))


NO_CARRY = Carry()


def _gf2_io(table: np.ndarray):
    """(wave, value) pairs of a GF(2) slot table's writes and reads."""
    t = np.asarray(table)
    op, dst, a, b = (t[..., c].astype(np.int64) for c in (_OP, _DST, _A, _B))
    wave = np.broadcast_to(np.arange(t.shape[0], dtype=np.int64)[:, None], op.shape)
    writes = (op != _NOP) & (op != G_ASSERT)
    ra, rb = np.isin(op, _READS_A), np.isin(op, _READS_B)
    return ((wave[writes], dst[writes]),
            (np.concatenate([wave[ra], wave[rb]]), np.concatenate([a[ra], b[rb]])))


def _z64_io(ztable: np.ndarray, bits: np.ndarray):
    """(wave, value) pairs of a z64 slot table's z64 writes and reads, and
    its reads of GF(2) values (a B2A slot's 64 bits)."""
    t = np.asarray(ztable)
    op, dst, a, b, row = (t[..., c].astype(np.int64) for c in (_ZOP, _ZDST, _ZA, _ZB, _ZBITS))
    wave = np.broadcast_to(np.arange(t.shape[0], dtype=np.int64)[:, None], op.shape)
    writes = (op != _NOP) & (op != G_ASSERT)
    ra, rb, rbits = np.isin(op, _ZREADS_A), np.isin(op, _ZREADS_B), np.isin(op, _B2A)
    bits = np.asarray(bits, dtype=np.int64).reshape(-1, 64)
    return ((wave[writes], dst[writes]),
            (np.concatenate([wave[ra], wave[rb]]), np.concatenate([a[ra], b[rb]])),
            (np.repeat(wave[rbits], 64), bits[row[rbits]].reshape(-1)))


def _intervals(n_waves: int, writes, reads, n_in: int = 0, out=()):
    """Per value of one domain: the wave that writes it and the last wave
    that reads it (its writing wave if none does), -1 for values no slot
    writes; value 0, the zero, is not written.  Carried-in values 1..n_in
    are written before wave 0 (first 0) and carried-out values read after
    the last wave.  -> (first, last) int64 arrays over the values."""
    (ww, wv), (rw, rv) = writes, reads
    out = np.asarray(out, dtype=np.int64)
    n = int(max(wv.max(initial=0), rv.max(initial=0), n_in, out.max(initial=0))) + 1
    if np.bincount(wv, minlength=n).max(initial=0) > 1:
        raise ValueError("allocate_slots: a value is written twice (the table is not SSA)")
    first = np.full(n, -1, dtype=np.int64)
    first[wv] = ww
    if n_in:
        if (first[1 : n_in + 1] >= 0).any():
            raise ValueError("allocate_slots: a carried-in value is written again")
        first[1 : n_in + 1] = 0
    last = first.copy()
    np.maximum.at(last, rv, rw)
    last[out] = np.maximum(last[out], n_waves - 1)
    first[0] = last[0] = -1
    return first, last


def live_intervals(table: np.ndarray):
    """Per SSA value of a GF(2) wave table (wave_table layout): the wave
    that writes it and the last wave that reads it (its writing wave if
    none does), -1 for values no slot writes; value 0, the zero, is not
    written.  -> (first, last) int64 arrays over the values."""
    return _intervals(np.asarray(table).shape[0], *_gf2_io(table))


def _domain_intervals(table, ztable=None, bits=None, carry: Carry = NO_CARRY):
    """(first, last) of the GF(2) values and, with a z64 table, of the z64
    values (else None), over both domains' reads and the carries."""
    n_waves = np.asarray(table).shape[0]
    w2, r2 = _gf2_io(table)
    if ztable is None:
        return _intervals(n_waves, w2, r2, carry.n_in, carry.out), None
    wz, rz, rbits = _z64_io(ztable, bits)
    r2 = tuple(np.concatenate([x, y]) for x, y in zip(r2, rbits))
    return (_intervals(n_waves, w2, r2, carry.n_in, carry.out),
            _intervals(n_waves, wz, rz, carry.n_inz, carry.outz))


def _live_counts(first: np.ndarray, last: np.ndarray, vals: np.ndarray, n_waves: int):
    count = np.zeros(n_waves + 1, dtype=np.int64)
    np.add.at(count, first[vals], 1)
    np.add.at(count, last[vals] + 1, -1)
    return np.cumsum(count)[:n_waves]


def _live(first: np.ndarray, last: np.ndarray, n_waves: int) -> int:
    vals = np.nonzero(first >= 0)[0]
    return 1 + int(_live_counts(first, last, vals, n_waves).max(initial=0))


def live_set(table: np.ndarray) -> int:
    """The most values live at once over the waves of a GF(2) table, value
    0 included: the slots allocate_slots needs without spilling."""
    return _live(*live_intervals(table), np.asarray(table).shape[0])


def live_sets(table, ztable=None, bits=None, carry: Carry = NO_CARRY) -> Tuple[int, int]:
    """(GF(2) live set, z64 live set or 0 without a z64 table), each value
    0 included, over both domains' reads and the carries."""
    n_waves = np.asarray(table).shape[0]
    iv2, ivz = _domain_intervals(table, ztable, bits, carry)
    return _live(*iv2, n_waves), 0 if ivz is None else _live(*ivz, n_waves)


def _linear_scan(vals: np.ndarray, first: np.ndarray, last: np.ndarray,
                 slot: np.ndarray, base: int) -> int:
    """Give each value of `vals` the lowest slot from `base` up that no
    value live in its waves holds; a slot whose value was last read in wave
    l is taken again from wave l + 1 on.  -> the slots used."""
    order = vals[np.argsort(first[vals], kind="stable")]
    free: list = []
    busy: list = []  # (last wave, slot)
    top = base
    for v in order.tolist():
        f = first[v]
        while busy and busy[0][0] < f:
            heapq.heappush(free, heapq.heappop(busy)[1])
        if free:
            s = heapq.heappop(free)
        else:
            s, top = top, top + 1
        slot[v] = s
        heapq.heappush(busy, (int(last[v]), s))
    return top - base


def _allocate(first: np.ndarray, last: np.ndarray, n_waves: int, capacity: int):
    """One domain's slots -> (slot per value, n_shared, n_spill): value 0
    keeps slot 0; where more values are live at once than `capacity`
    holds, the longest-lived spill, first to last, until the rest fit."""
    if capacity < 1:
        raise ValueError("allocate_slots: capacity must hold slot 0")
    vals = np.nonzero(first >= 0)[0]
    count = _live_counts(first, last, vals, n_waves)
    room = capacity - 1
    spill = np.zeros(first.shape, dtype=bool)
    over = int((count > room).sum())
    if over:
        span = last[vals] - first[vals]
        for v in vals[np.lexsort((first[vals], -span))].tolist():
            lo, hi = first[v], last[v] + 1
            seg = count[lo:hi]
            if seg.max() > room:
                spill[v] = True
                over -= int((seg == room + 1).sum())
                seg -= 1
                if not over:
                    break
    slot = np.zeros(first.shape, dtype=np.int64)
    n_shared = 1 + _linear_scan(vals[~spill[vals]], first, last, slot, 1)
    n_spill = _linear_scan(vals[spill[vals]], first, last, slot, 0)
    slot[spill] += n_shared
    if n_shared + n_spill >= MAX_SLOTS:
        raise ValueError(f"allocate_slots: {n_shared + n_spill} slots, the wave kernel "
                         f"names at most {MAX_SLOTS - 1}")
    return slot, n_shared, n_spill


@dataclasses.dataclass
class Slots:
    """Slot tables of the waves (allocate_waves): the GF(2) table with its
    slots in shared memory and spilled; the z64 table and the bits table
    (GF(2) slots) with the z64 slots, or None; and the slots of the
    carried-in values (cin: values 1..k) and carried-out ones, per domain."""

    table: np.ndarray
    n_shared: int
    n_spill: int
    ztable: Optional[np.ndarray] = None
    bits: Optional[np.ndarray] = None
    n_sharedz: int = 0
    n_spillz: int = 0
    cin: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int32))
    cout: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int32))
    cinz: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int32))
    coutz: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int32))


def allocate_waves(table: np.ndarray, capacity: int, ztable: Optional[np.ndarray] = None,
                   bits: Optional[np.ndarray] = None, capacityz: int = 1,
                   carry: Carry = NO_CARRY) -> Slots:
    """Rewrite the SSA value numbers of the wave tables (dst, a, b of
    wave_table's layout; dst, a, b and the bits of zwave_table's) into slot
    numbers, per domain (allocate_slots' rule), with the reads of both
    domains: a B2A slot's bits read GF(2) values.  Slots that write nothing
    point at the domain's trash row (n_shared + n_spill), and operands a
    gate does not read at slot 0.  wave_ref runs the result with n_vals =
    n_shared + n_spill per domain and gives the streams it gives on the
    SSA tables."""
    t = np.array(table, dtype=np.int32, copy=True)
    n_waves = t.shape[0]
    iv2, ivz = _domain_intervals(t, ztable, bits, carry)
    slot, n_shared, n_spill = _allocate(*iv2, n_waves, capacity)
    op = t[..., _OP]
    writes = (op != _NOP) & (op != G_ASSERT)
    t[..., _DST] = np.where(writes, slot[np.where(writes, t[..., _DST], 0)], n_shared + n_spill)
    for col, kinds in ((_A, _READS_A), (_B, _READS_B)):
        reads = np.isin(op, kinds)
        t[..., col] = np.where(reads, slot[np.where(reads, t[..., col], 0)], 0)
    out = Slots(t, n_shared, n_spill,
                cin=slot[1 : carry.n_in + 1].astype(np.int32),
                cout=slot[np.asarray(carry.out, dtype=np.int64)].astype(np.int32))
    if ztable is None:
        return out
    zt = np.array(ztable, dtype=np.int32, copy=True)
    zslot, out.n_sharedz, out.n_spillz = _allocate(*ivz, n_waves, capacityz)
    zop = zt[..., _ZOP]
    writes = (zop != _NOP) & (zop != G_ASSERT)
    trash = out.n_sharedz + out.n_spillz
    zt[..., _ZDST] = np.where(writes, zslot[np.where(writes, zt[..., _ZDST], 0)], trash)
    for col, kinds in ((_ZA, _ZREADS_A), (_ZB, _ZREADS_B)):
        reads = np.isin(zop, kinds)
        zt[..., col] = np.where(reads, zslot[np.where(reads, zt[..., col], 0)], 0)
    out.ztable = zt
    out.bits = slot[np.asarray(bits, dtype=np.int64)].astype(np.int32).reshape(-1, 64)
    out.cinz = zslot[1 : carry.n_inz + 1].astype(np.int32)
    out.coutz = zslot[np.asarray(carry.outz, dtype=np.int64)].astype(np.int32)
    return out


def allocate_slots(table: np.ndarray, capacity: int):
    """Rewrite the SSA value numbers of a GF(2) wave table (dst, a, b of
    wave_table's layout) into slot numbers -> (table', n_shared, n_spill).

    Linear scan over the live intervals (live_intervals): a value holds its
    slot from the wave that writes it through the last wave that reads it,
    and a slot freed in wave l is taken again from wave l + 1 on, so no
    wave reads and writes one slot.  Value 0, the zero, keeps slot 0.
    Slots 0 .. n_shared - 1 (at most `capacity`) are the wave kernel's
    shared memory; where more values are live at once, the longest-lived
    are spilled, first to last, until the rest fit, and take slots
    n_shared .. n_shared + n_spill - 1 of a global arena.  Slots that write
    nothing (NOP, ASSERT_ZERO) point at n_shared + n_spill, the plain
    version's trash row, and operands a gate does not read at slot 0.
    wave_gf2_ref runs table' with n_vals = n_shared + n_spill and gives the
    streams it gives on `table`."""
    out = allocate_waves(table, capacity)
    return out.table, out.n_shared, out.n_spill


def _field_counts(op: np.ndarray, mode: int) -> np.ndarray:
    """Input fields each slot reads in `mode` (_FIELDS)."""
    n = np.zeros(op.shape, dtype=np.int64)
    for kind, fields in _FIELDS[mode].items():
        n[op == kind] = len(fields)
    return n


def _most_per_chunk(per_wave: np.ndarray, chunk: int) -> int:
    """The largest sum of `chunk` consecutive entries of per_wave, from 0
    on (0 for none)."""
    n_chunks = -(-len(per_wave) // chunk)
    per_chunk = np.add.reduceat(per_wave, np.arange(n_chunks) * chunk) if len(per_wave) else [0]
    return int(np.max(per_chunk))


def chunk_fields(table: np.ndarray, chunk: int) -> int:
    """The most input fields of any `chunk` consecutive waves of `table`
    (from wave 0 on) in the role that reads most (VERIFY_ONL): the rows
    of a block's staged fields."""
    per_wave = _field_counts(np.asarray(table)[..., _OP], VERIFY_ONL).sum(axis=1)
    return max(1, _most_per_chunk(per_wave, chunk))


def _zfield_counts(op: np.ndarray, mode: int) -> np.ndarray:
    """Staged words each z64 slot reads in `mode` (_ZFIELDS)."""
    n = np.zeros(op.shape, dtype=np.int64)
    for kind, fields in _ZFIELDS[mode].items():
        n[op == kind] = sum(_ZSOURCES[src][0] for src, _ in fields)
    return n


def chunk_zwords(ztable: np.ndarray, mode: int, chunk: int) -> int:
    """The most staged z64 words (_ZFIELDS) of any `chunk` consecutive
    waves of a z64 table (zwave_table) in `mode`, from wave 0 on: W2 stages
    that many words for each rep of a block."""
    per_wave = _zfield_counts(np.asarray(ztable)[..., _ZOP], mode).sum(axis=1)
    return _most_per_chunk(per_wave, chunk)


def chunk_zbits(ztable: np.ndarray, chunk: int) -> int:
    """The most B2A slots (rows of the bits table) of any `chunk`
    consecutive waves of a z64 table, from wave 0 on."""
    per_wave = np.isin(np.asarray(ztable)[..., _ZOP], _B2A).sum(axis=1)
    return _most_per_chunk(per_wave, chunk)


@dataclasses.dataclass(frozen=True)
class WavePlan:
    """How the wave kernel covers R lanes: `reps` consecutive lanes per
    block, `chunk` waves staged in shared memory at once (at most
    `fields` input fields a chunk), `k` GF(2) slots of a wave per thread
    over `threads_y` rows of threads, and the GF(2) and z64 slots a block
    can hold in shared memory (`capacity`, `capacityz`; 0 for a pure-GF(2)
    table); with z64 slots (`Wz` a wave), the most staged z64 words and
    B2A bits rows of a chunk (`zwords`, `zbits`: chunk_zwords,
    chunk_zbits) and the threads W2 gives a (rep, z64 slot) (`zlanes`, 8
    or 1, each taking 8 / zlanes of the players)."""

    reps: int
    chunk: int
    fields: int
    k: int
    threads_y: int
    capacity: int
    capacityz: int = 0
    Wz: int = 0
    zwords: int = 0
    zbits: int = 0
    zlanes: int = 0


def staged_bytes(reps: int, W: int, chunk: int, fields: int, Wz: int = 0, zwords: int = 0,
                 zbits: int = 0) -> int:
    """Shared memory of a block that is not slots: two chunks of packed
    slots and of input fields, one chunk of the fields' bytes, and 32 fail
    flags; with Wz z64 slots a wave, W2's staged chunk in front of them
    (csrc/scan_z64.cu zstage_bytes): two chunks of packed z64 slots, one
    chunk's `zwords` staged words (8 bytes a rep), two chunks of `zbits`
    bits rows (256 bytes each) and of their fields (4 bytes each, a
    multiple of 4)."""
    z = (2 * chunk * Wz * ZPACKED_WORDS * 4 + zwords * reps * 8 + 2 * zbits * 256
         + 2 * -(-zwords // 4) * 4 * 4)
    return z + 2 * chunk * W * PACKED_WORDS * 4 + 2 * fields * 4 + fields * reps + 32


def slot_capacity(reps: int, W: int, chunk: int, fields: int) -> int:
    """Slots of `reps` lanes (2 bytes each) that fit a block's shared memory
    beside its staged waves (staged_bytes)."""
    return (SMEM_PER_BLOCK - staged_bytes(reps, W, chunk, fields)) // (2 * reps)


def launch_plan(n_live: int, table: np.ndarray, R: int = 0, reps: int = 0,
                n_livez: int = 0, Wz: int = 0, ztable: Optional[np.ndarray] = None,
                mode: int = VERIFY_ONL) -> WavePlan:
    """The wave kernel's plan at R lanes for a GF(2) wave table whose live
    set is n_live slots (live_set) and, with Wz z64 slots a wave, a z64
    live set of n_livez slots of ZBYTES a rep, and W2 staging the z64
    table's (`ztable`, zwave_table) input words of a chunk in `mode`
    (chunk_zwords) beside its slots and bits rows.  Where the blocks of 8
    reps fit the card at once (R <= 8 x SMS), 8 reps a block: its barrier
    and its waves have the fewest warps.  Past that, the widest block of
    REPS_PER_BLOCK that holds both live sets: each SM then runs the fewest
    rounds of the chain.  The chunk is the longest of CHUNKS (W2: ZCHUNKS)
    that fits beside them, so that its staging is paid the fewest times;
    where none fits, 8 reps and chunks of 4 (W2: shorter where its staged
    words need it), the z64 slots taking at most half the room (the rest
    spill).  `reps` forces the block width.  Each thread takes k of a
    wave's GF(2) slots, the fewest (a power of two, at most 4) that keep
    the block within MAX_THREADS.  With z64 slots (W2: blocks of at most
    MAX_THREADS_Z64, in whole warps, and one GF(2) slot a thread, so that a
    thread holds its work in 128 registers) each (rep, z64 slot) takes
    `zlanes` threads: 8, one a player, where the blocks fit the card at
    once, else 1; and past that W2's chunk is the longest whose blocks
    share the SMs' shared memory in the fewest rounds over R (its staged
    words grow with reps x chunk; at R = 0 the longest that fits).  Raises
    ValueError where the staged waves leave a block no room for slots, or a
    thread more GF(2) slots than it may take."""
    W = np.asarray(table).shape[1]
    most, kmax = (MAX_THREADS_Z64, 1) if Wz else (MAX_THREADS, 4)
    chunks = ZCHUNKS if Wz else CHUNKS
    fields = {c: chunk_fields(table, c) for c in chunks}
    zstaged = {c: (0, 0) for c in chunks}
    if Wz and ztable is not None:
        zstaged = {c: (chunk_zwords(ztable, mode, c), chunk_zbits(ztable, c)) for c in chunks}
    one_round = 0 < R <= 8 * SMS
    widths = (reps,) if reps else (REPS_PER_BLOCK[::-1] if one_round else REPS_PER_BLOCK)
    zlanes = (8 if one_round else 1) if Wz else 0

    def room(p: int, c: int) -> int:
        return SMEM_PER_BLOCK - staged_bytes(p, W, c, fields[c], Wz, *zstaged[c])

    def rounds(pc: Tuple[int, int]) -> int:
        """Rounds of the blocks over the card's shared memory at R lanes."""
        p, c = pc
        smem = SMEM_PER_BLOCK - room(p, c) + p * (2 * n_live + ZBYTES * n_livez)
        return -(-(-(-R // p)) // (SMS * (SMEM_PER_SM // (smem + SMEM_RESERVED))))

    fits = [(p, c) for p in widths for c in chunks
            if room(p, c) >= p * (2 * n_live + ZBYTES * n_livez)
            and p // 4 * -(-W // kmax) <= most]
    if fits and Wz and not one_round:  # the widest block's chunk of fewest rounds
        reps, chunk = min((f for f in fits if f[0] == fits[0][0]), key=rounds)
    elif fits:
        reps, chunk = fits[0]
    else:  # spilled: the longest chunk of 4 waves or fewer with room for 2 + 1 slots
        reps = reps or REPS_PER_BLOCK[-1]
        short = [c for c in chunks if c <= CHUNKS[-1]]
        chunk = next((c for c in short if room(reps, c) >= reps * (4 + ZBYTES * (Wz > 0))),
                     short[-1])
    if reps not in REPS_PER_BLOCK:
        raise ValueError(f"launch_plan: reps per block must be one of {REPS_PER_BLOCK}")
    free = room(reps, chunk)
    capz = 0
    if Wz:  # both live sets where they fit, else half the room for z64 slots
        capz = n_livez if fits else min(n_livez, max(1, free // 2 // (ZBYTES * reps)))
    capacity = (free - ZBYTES * reps * capz) // (2 * reps)
    if capacity < 2:
        raise ValueError(f"launch_plan: {chunk} waves of {W} slots leave no shared memory "
                         f"for slots")
    k = 1
    while reps // 4 * -(-W // k) > most:
        k *= 2
    if k > kmax:
        raise ValueError(f"launch_plan: a wave of {W} slots needs {k} slots a thread (at "
                         f"most {kmax})")
    threads_y = -(-W // k)
    if Wz:  # rows for zlanes threads a (rep, z64 slot) up to MAX_THREADS_Z64, in warps
        per = 32 // (reps // 4)
        threads_y = -(-max(threads_y, min(4 * zlanes * Wz, most // (reps // 4))) // per) * per
    return WavePlan(reps, chunk, fields[chunk], k, threads_y, capacity, capz, Wz,
                    *zstaged[chunk], zlanes)


def pack_table(table: np.ndarray, mode: int, chunk: int):
    """A slot-allocated wave table (allocate_slots) in the wave kernel's
    form for one role -> (slots (n_waves, W, PACKED_WORDS) int32, fields
    (n_fields,) int32, chunk_off (n_chunks + 1,) int32).  A slot's input fields
    (_FIELDS) are consecutive entries of `fields` from its word 5 on, each
    source << 30 | row, and chunk c's fields are chunk_off[c] ..
    chunk_off[c + 1] - 1.  Words 6 and 7 hold what the kernel's decode
    needs before the barrier: the linear gates' operand masks and constant
    (out = (A & ma) ^ (B & mb) ^ k), what kind of work follows the barrier
    and whether k takes the first input byte (sub 1) or is an INPUT's
    (sub 2)."""
    t = np.asarray(table, dtype=np.int64)
    n_waves, W = t.shape[:2]
    flat = t.reshape(-1, t.shape[2])
    op = flat[:, _OP]
    count = _field_counts(op, mode)
    first = np.cumsum(count) - count
    fields = np.zeros(int(count.sum()), dtype=np.int64)
    for kind, cols in _FIELDS[mode].items():
        idx = np.nonzero(op == kind)[0]
        for i, (src, col) in enumerate(cols):
            if idx.size and flat[idx, col].max() >= 1 << 30:
                raise ValueError("pack_table: an input row past 2**30")
            fields[first[idx] + i] = (src << 30) | flat[idx, col]
    cbit = flat[:, _CBIT] & 1
    head = (op & 0x7F) | (cbit << 7) | (flat[:, _DST] << 8)
    kind, sub, masks, k = (np.zeros_like(op) for _ in range(4))
    linear = np.isin(op, (G_ADD, G_ADDC, G_SUBC, G_MULC, G_RANDOM, G_CONST, G_INPUT))
    kind[linear], kind[op == G_MUL] = _LINEAR, _MUL
    if mode != VERIFY_PRE:
        kind[op == G_ASSERT] = _ASSERT
    masks[op == G_ADD] = 0xFFFF | 0xFFFF << 16
    masks[np.isin(op, (G_ADDC, G_SUBC))] = 0xFFFF
    masks[op == G_MULC] = np.where(cbit[op == G_MULC] == 1, 0x01FF, 0)
    k[np.isin(op, (G_ADDC, G_SUBC, G_CONST))] = cbit[np.isin(op, (G_ADDC, G_SUBC, G_CONST))] << 8
    sub[op == G_RANDOM] = 1
    if mode == VERIFY_ONL:
        sub[op == G_ASSERT] = 1
    sub[op == G_INPUT] = 2
    words = np.stack([head, flat[:, _A], flat[:, _B], flat[:, _ONL], flat[:, _PRE],
                      np.where(count > 0, first, 0), masks, kind | sub << 2 | k << 8], axis=-1)
    slots = np.ascontiguousarray(words.astype(np.uint32).view(np.int32)).reshape(
        n_waves, W, PACKED_WORDS)
    starts = first.reshape(n_waves, W)[:, 0] if n_waves else np.zeros(0, dtype=np.int64)
    chunk_off = np.append(starts[::chunk], len(fields)).astype(np.int32)
    return slots, fields.astype(np.uint32).view(np.int32), chunk_off


def pack_ztable(ztable: np.ndarray, mode: int, chunk: int):
    """A slot-allocated z64 table (allocate_waves' ztable) in W2's form for
    one role -> (zslots (n_waves, Wz, ZPACKED_WORDS) int32, zfields
    (n_fields,) int32, zchunk_off (n_chunks + 1, 2) int32).  A slot's staged
    words (_ZFIELDS, _ZSOURCES) are consecutive entries of `zfields`, each
    source << 29 | row; chunk c's are zchunk_off[c, 0] .. zchunk_off[c + 1,
    0] - 1, and its B2A slots' rows of the bits table zchunk_off[c, 1] ..
    zchunk_off[c + 1, 1] - 1.  A slot's word 3 holds its first staged word
    and its bits row, each counted from its chunk's first; words 4 and 5 its
    event rows (a B2A_OUT's onl2 rows in word 4).  Raises ValueError where
    a row passes 2**29, a chunk 2**16 words or bits rows, or the B2A slots'
    bits rows are not in the order of the slots."""
    t = np.asarray(ztable, dtype=np.int64)
    n_waves, Wz = t.shape[:2]
    flat = t.reshape(-1, t.shape[2])
    op = flat[:, _ZOP]
    count = _zfield_counts(op, mode)
    first = np.cumsum(count) - count
    fields = np.zeros(int(count.sum()), dtype=np.int64)
    for kind, parts in _ZFIELDS[mode].items():
        idx = np.nonzero(op == kind)[0]
        at = first[idx]
        for src, col in parts:
            width, row = _ZSOURCES[src]
            v = flat[idx, col]
            for p in range(width):
                r = row(v, p)
                if r.size and (r.min() < 0 or r.max() >= 1 << 29):
                    raise ValueError("pack_ztable: an input row past 2**29")
                fields[at + p] = (src << 29) | r
            at = at + width
    b2a = np.isin(op, _B2A)
    brow = np.where(b2a, flat[:, _ZBITS], 0)
    if not np.array_equal(brow[b2a], np.arange(int(b2a.sum()))):
        raise ValueError("pack_ztable: the bits rows are not in the order of the B2A slots")
    # per slot, its chunk's first field and bits row
    wave_start = np.arange(0, n_waves * Wz, Wz)
    n_b2a = np.cumsum(b2a) - b2a
    starts = np.stack([first[wave_start[::chunk]], n_b2a[wave_start[::chunk]]], axis=-1) \
        if n_waves else np.zeros((0, 2), dtype=np.int64)
    chunk_off = np.concatenate([starts, [[len(fields), int(b2a.sum())]]]).astype(np.int32)
    base = np.repeat(starts, chunk * Wz, axis=0)[: n_waves * Wz]
    rel_f = np.where(count > 0, first - base[:, 0], 0)
    rel_b = np.where(b2a, brow - base[:, 1], 0)
    if n_waves and (rel_f.max() >= 1 << 16 or rel_b.max() >= 1 << 16):
        raise ValueError("pack_ztable: a chunk of more than 2**16 staged words or bits rows")
    onl = np.where(op == B2A_OUT, flat[:, _ZBONL], flat[:, _ZONL])
    head = (op & 0xFF) | (flat[:, _ZDST] << 8)
    words = np.stack([head, flat[:, _ZA], flat[:, _ZB], rel_f | rel_b << 16, onl,
                      flat[:, _ZPRE], flat[:, _ZCLO], flat[:, _ZCHI]], axis=-1)
    zslots = np.ascontiguousarray(words.astype(np.uint32).view(np.int32)).reshape(
        n_waves, Wz, ZPACKED_WORDS)
    return zslots, fields.astype(np.uint32).view(np.int32), chunk_off


@dataclasses.dataclass
class WaveProgram:
    """One role's waves, ready for `wave_run`: the slot-allocated GF(2)
    table (for the plain version, on the CPU), its packed slots, input
    fields and chunk offsets (pack_table) on the device (None on the CPU),
    the GF(2) slots in shared memory and spilled, and the launch plan; for
    a circuit with z64 gates, the z64 table and the bits table (on the CPU,
    for the plain version), and `zdev` on the device: the packed z64 slots,
    their staged words' fields and chunk offsets (pack_ztable) and the bits
    table; the z64 slots in shared memory and spilled; and the carried
    slots (`carry`: cin, cout, cinz, coutz as int32 tensors on the
    program's device)."""

    table: torch.Tensor
    slots: Optional[torch.Tensor]
    fields: Optional[torch.Tensor]
    chunk_off: Optional[torch.Tensor]
    n_shared: int
    n_spill: int
    plan: WavePlan
    ztable: Optional[torch.Tensor] = None
    bits: Optional[torch.Tensor] = None
    zdev: Optional[Tuple[torch.Tensor, ...]] = None
    n_sharedz: int = 0
    n_spillz: int = 0
    carry: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    @property
    def n_vals(self) -> int:
        """Rows of the plain version's GF(2) arena (its trash row is the
        next)."""
        return self.n_shared + self.n_spill

    @property
    def n_valsz(self) -> int:
        """Rows of the plain version's z64 arena (its trash row is the
        next)."""
        return self.n_sharedz + self.n_spillz

    @property
    def has_z64(self) -> bool:
        return self.ztable is not None

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of one block: the staged waves of both
        domains and the fail flags (staged_bytes) and the shared slots of
        both domains."""
        p = self.plan
        return (staged_bytes(p.reps, self.table.shape[1], p.chunk, p.fields, p.Wz, p.zwords,
                             p.zbits)
                + 2 * self.n_shared * p.reps + ZBYTES * self.n_sharedz * p.reps)


def wave_program(table: np.ndarray, mode: int, device: torch.device, R: int = 0,
                 capacity: int = 0, reps: int = 0, plan: Optional[WavePlan] = None,
                 slots=None, ztable: Optional[np.ndarray] = None,
                 bits: Optional[np.ndarray] = None, capacityz: int = 0,
                 carry: Carry = NO_CARRY) -> WaveProgram:
    """A WaveProgram of SSA wave tables (wave_table layout, and with z64
    slots zwave_table's pair `ztable`, `bits`) in one role at R lanes: the
    launch plan from the live sets and R (`reps` as launch_plan's), or
    `plan`; the slots from allocate_waves at the plan's capacities (or
    `capacity`, `capacityz`, smaller, to force spills), or `slots`, a Slots
    (or a GF(2) (table', n_shared, n_spill)) already allocated for them."""
    table = np.asarray(table)
    if table.ndim != 3 or table.shape[2] != len(SLOT_COLS):
        raise ValueError(f"wave_program: the table must be (n_waves, W, {len(SLOT_COLS)})")
    Wz = 0
    if ztable is not None:
        ztable = np.asarray(ztable)
        if (ztable.ndim != 3 or ztable.shape[2] != len(ZSLOT_COLS)
                or ztable.shape[0] != table.shape[0]):
            raise ValueError(f"wave_program: the z64 table must be (n_waves, Wz, "
                             f"{len(ZSLOT_COLS)})")
        Wz = ztable.shape[1]
    if plan is None:
        n_live, n_livez = live_sets(table, ztable, bits, carry)
        plan = launch_plan(n_live, table, R, reps, n_livez, Wz, ztable, mode)
    cap = min(capacity, plan.capacity) if capacity > 0 else plan.capacity
    capz = min(capacityz, plan.capacityz) if capacityz > 0 else plan.capacityz
    if slots is None:
        slots = allocate_waves(table, cap, ztable, bits, capz, carry)
    elif not isinstance(slots, Slots):
        slots = Slots(*slots)
    if slots.n_shared > plan.capacity or slots.n_sharedz > plan.capacityz:
        raise ValueError(f"wave_program: {slots.n_shared} / {slots.n_sharedz} shared slots "
                         f"above the plan's {plan.capacity} / {plan.capacityz}")
    packed = (None,) * 3
    if device.type == "cuda":
        packed = tuple(torch.from_numpy(a).to(device)
                       for a in pack_table(slots.table, mode, plan.chunk))
    prog = WaveProgram(torch.from_numpy(slots.table), *packed, slots.n_shared, slots.n_spill,
                       plan)
    if slots.ztable is not None:
        prog.ztable = torch.from_numpy(slots.ztable)
        prog.bits = torch.from_numpy(slots.bits)
        prog.n_sharedz, prog.n_spillz = slots.n_sharedz, slots.n_spillz
        if device.type == "cuda":
            zslots, zfields, zoff = pack_ztable(slots.ztable, mode, plan.chunk)
            most = np.diff(zoff, axis=0).max(axis=0, initial=0)
            if plan.Wz != zslots.shape[1] or most[0] > plan.zwords or most[1] > plan.zbits:
                raise ValueError(f"wave_program: the plan stages {plan.zwords} z64 words and "
                                 f"{plan.zbits} bits rows a chunk of {plan.Wz} slots a wave, "
                                 f"the table needs {most[0]} and {most[1]} of {zslots.shape[1]}")
            prog.zdev = tuple(torch.from_numpy(a).to(device)
                              for a in (zslots, zfields, zoff, slots.bits))
    prog.carry = {k: torch.from_numpy(np.asarray(getattr(slots, k), dtype=np.int32)).to(device)
                  for k in ("cin", "cout", "cinz", "coutz")}
    return prog


@dataclasses.dataclass
class CircuitWaves:
    """What the wave executor derives once per circuit and wave width, kept
    on the circuit (`CompiledCircuit.wave_tables`): build_waves' table and,
    on first use, its PROVER tables (wave_table, zwave_table), live sets and
    input fields, the launch plans (a GF(2) plan depends on R only through
    R <= 8 x SMS, a z64 one on its rounds of blocks and its role; footprints
    ask for one at every batch width) and the slot
    allocations by capacities and carries (a SHA-256 table takes about a
    second)."""

    waves: WaveTable
    plans: Dict[tuple, WavePlan] = dataclasses.field(default_factory=dict)
    slots: Dict[tuple, Slots] = dataclasses.field(default_factory=dict)
    lives: Dict[Carry, Tuple[int, int]] = dataclasses.field(default_factory=dict)

    @functools.cached_property
    def table(self) -> np.ndarray:
        return wave_table(self.waves, PROVER)

    @functools.cached_property
    def ztables(self) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        """zwave_table's (ztable, bits) in PROVER's layout, or (None, None)."""
        return zwave_table(self.waves, PROVER) if self.waves.has_z64 else (None, None)

    @property
    def Wz(self) -> int:
        return self.waves.zop.shape[1] if self.waves.has_z64 else 0

    def live(self, carry: Carry = NO_CARRY) -> Tuple[int, int]:
        """live_sets of the PROVER tables with `carry`."""
        if carry not in self.lives:
            self.lives[carry] = live_sets(self.table, *self.ztables, carry)
        return self.lives[carry]

    @property
    def n_live(self) -> int:
        return self.live()[0]

    @functools.cached_property
    def n_fields(self) -> int:
        """Input fields of the packed PROVER table."""
        return int(_field_counts(self.waves.op, PROVER).sum())

    def plan(self, R: int = 0, reps: int = 0, carry: Carry = NO_CARRY,
             mode: int = PROVER) -> WavePlan:
        """launch_plan at R lanes in `mode` (W2 stages a role's own input
        words; `reps` forces the block width, uncached)."""
        n_live, n_livez = self.live(carry)
        args = (n_livez, self.Wz, self.ztables[0], mode)
        if reps:
            return launch_plan(n_live, self.table, R, reps, *args)
        key = (R, carry, mode) if self.Wz else (0 < R <= 8 * SMS, carry)
        if key not in self.plans:
            self.plans[key] = launch_plan(n_live, self.table, R, 0, *args)
        return self.plans[key]

    def allocation(self, capacity: int, capacityz: int = 0,
                   carry: Carry = NO_CARRY) -> Slots:
        """allocate_waves of the PROVER tables at the capacities; every role
        shares it (only the xin columns differ between them)."""
        key = (capacity, capacityz, carry)
        if key not in self.slots:
            self.slots[key] = allocate_waves(self.table, capacity, *self.ztables,
                                             max(capacityz, 1), carry)
        return self.slots[key]


def circuit_waves(cc: CompiledCircuit, wave_width: int = 0) -> CircuitWaves:
    """cc's CircuitWaves at width W, made once and kept on the circuit; W =
    0 takes default_wave_width, whose record is also kept under 0."""
    rec = cc.wave_tables.get(wave_width)
    if rec is None:
        W = wave_width if wave_width > 0 else default_wave_width(cc)
        rec = cc.wave_tables.get(W) or CircuitWaves(build_waves(cc, W))
        cc.wave_tables[W] = cc.wave_tables[wave_width] = rec
    return rec


def circuit_program(cc: CompiledCircuit, mode: int, device: torch.device, R: int = 0,
                    wave_width: int = 0, reps: int = 0, capacity: int = 0,
                    capacityz: int = 0, carry: Carry = NO_CARRY) -> WaveProgram:
    """The WaveProgram of cc's waves (`waves`) in one role at R lanes
    (`reps` as launch_plan's; `capacity`, `capacityz` below the plan's force
    spills) with the segment carries `carry`, its slots shared by every
    role and every plan whose shared memory holds them."""
    rec = circuit_waves(cc, wave_width)
    plan = rec.plan(R, reps, carry, mode)
    cap = min(capacity, plan.capacity) if capacity > 0 else plan.capacity
    capz = min(capacityz, plan.capacityz) if capacityz > 0 else plan.capacityz
    alloc = rec.allocation(cap, capz, carry)
    table = wave_table(rec.waves, mode)
    table[..., [_DST, _A, _B]] = alloc.table[..., [_DST, _A, _B]]
    slots = dataclasses.replace(alloc, table=table)
    if rec.waves.has_z64:
        ztable = alloc.ztable.copy()
        ztable[..., _ZXIN] = zwave_table(rec.waves, mode)[0][..., _ZXIN]
        slots.ztable = ztable
    return wave_program(table, mode, device, R, plan=plan, slots=slots)


def table_bytes(cc: CompiledCircuit, R: int = 0) -> int:
    """Bytes of the packed PROVER wave program at R lanes on the device
    (the default width): its GF(2) slots, input fields and chunk offsets
    (pack_table) and its packed z64 slots, their staged words' fields and
    chunk offsets (pack_ztable) and the bits table."""
    rec = circuit_waves(cc)
    n_waves, W = rec.waves.op.shape
    n_chunks = -(-n_waves // rec.plan(R).chunk)
    ztable, bits = rec.ztables
    zbytes = 0
    if ztable is not None:
        n_zfields = int(_zfield_counts(ztable[..., _ZOP], PROVER).sum())
        zbytes = 4 * (ztable[..., 0].size * ZPACKED_WORDS + n_zfields + 2 * (n_chunks + 1)) \
            + bits.nbytes
    return 4 * (n_waves * W * PACKED_WORDS + rec.n_fields + n_chunks + 1) + zbytes


def spill_rows(cc: CompiledCircuit, R: int = 0) -> int:
    """Rows of the wave kernel's global GF(2) spill arena for cc at R lanes
    (0 when the live set fits shared memory, as SHA-256's does)."""
    rec = circuit_waves(cc)
    plan = rec.plan(R)
    return rec.allocation(plan.capacity, plan.capacityz).n_spill


def zspill_rows(cc: CompiledCircuit, R: int = 0) -> int:
    """Rows of W2's global z64 spill arena for cc at R lanes (0 when the z64
    live set fits shared memory or cc has no z64 gates)."""
    rec = circuit_waves(cc)
    plan = rec.plan(R)
    return rec.allocation(plan.capacity, plan.capacityz).n_spillz


def prover_bytes(cc: CompiledCircuit, R: int) -> int:
    """Device bytes a PROVER run at R lanes holds at its peak, the wave
    tables apart (table_bytes): the inputs tape (m2, R) and wit2 (n_wit2, R)
    uint8, tapez (mz, 8, R) and witz (n_witz, R) int64; the kernel's spill
    arenas, GF(2) (spill_rows, R) int16 (mask | corr << 8; one row when
    nothing spills: the live values sit in shared memory) and, with z64
    gates, z64 (zspill_rows, 9, R) int64 (one row at least); the four
    streams (executor.stream_bytes) and fail (R,)."""
    n_spill = spill_rows(cc, R)
    zspill = ZBYTES * max(zspill_rows(cc, R), 1) * R if circuit_waves(cc).waves.has_z64 else 0
    return ((cc.m2 + cc.n_wit2) * R + 8 * R * (8 * cc.mz + cc.n_witz)
            + 8 * max(n_spill, 1) * -(-R // 4) + zspill + stream_bytes(cc, R) + R)


class WaveOut(NamedTuple):
    """What a run of the waves returns: the four streams ((max(rows, 1), R)
    uint8), fail (R,) bool, and the carried-out rows ((0, R) and the like
    without carries)."""

    onl2: torch.Tensor
    pre2: torch.Tensor
    fail: torch.Tensor
    onlz: torch.Tensor
    prez: torch.Tensor
    carry_mask2: torch.Tensor
    carry_corr2: torch.Tensor
    carry_maskz: torch.Tensor
    carry_corrz: torch.Tensor


def _rows(src: Optional[torch.Tensor], R: int, device, lead=(),
          dtype=torch.uint8) -> torch.Tensor:
    """src, or one zero row where a mode does not read it (the gathers of
    slots that ignore it still need a row)."""
    if src is None or src.shape[0] == 0:
        return torch.zeros((1, *lead, R), dtype=dtype, device=device)
    return src


def _stream(buf: torch.Tensor, n: int) -> torch.Tensor:
    """The first n rows of a stream buffer (its last row is the trash row
    of build_waves), or one zero row for an empty stream."""
    return buf[:n] if n else torch.zeros_like(buf[:1])


def _gf2_wave(st: dict, c: torch.Tensor, mode: int, tape, xin, co2, re2) -> None:
    """One wave of GF(2) slots (c: the wave's columns, (12, W) int64) on the
    plain version's state, as `_scan_trace_fast2`'s body (tpu_scan.py
    :280-348)."""
    mask, corr = st["mask2"], st["corr2"]
    zero = torch.zeros((), dtype=torch.uint8, device=mask.device)
    op = c[_OP][:, None]
    a_m, a_c = mask.index_select(0, c[_A]), corr.index_select(0, c[_A])
    b_m, b_c = mask.index_select(0, c[_B]), corr.index_select(0, c[_B])
    t0, t1 = tape.index_select(0, c[_T0]), tape.index_select(0, c[_T1])
    cbit = c[_CBIT][:, None].to(torch.uint8)

    if mode == VERIFY_ONL:
        delta = co2.index_select(0, c[_CORR])
        msg = re2.index_select(0, c[_REC])
    else:
        delta = (_parity8(a_m) & _parity8(b_m)) ^ _parity8(t0)
    s = (b_m & _expand(a_c)) ^ (a_m & _expand(b_c)) ^ t0 ^ t1
    s_assert = a_m
    if mode == VERIFY_ONL:
        s, s_assert = s ^ msg, s_assert ^ msg
    recon = _parity8(s) ^ delta if mode != VERIFY_PRE else torch.zeros_like(s)
    mul_corr = recon ^ (a_c & b_c)
    if mode == PROVER:
        in_c = xin.index_select(0, c[_XIN]) ^ _parity8(t0)
    elif mode == VERIFY_ONL:
        in_c = xin.index_select(0, c[_XIN])
    else:
        in_c = torch.zeros_like(a_c)
    if mode != VERIFY_PRE:
        a_nonzero = (_parity8(s_assert) ^ a_c) != 0
        st["fail"] |= ((op == G_ASSERT) & a_nonzero).any(dim=0)

    is_mul, is_input = op == G_MUL, op == G_INPUT
    is_addc = (op == G_ADDC) | (op == G_SUBC)
    mask_new = torch.where(is_mul, t1, torch.where(
        is_input | (op == G_RANDOM), t0, torch.where(
            op == G_ADD, a_m ^ b_m, torch.where(
                is_addc, a_m, torch.where(op == G_MULC, a_m & _expand(cbit), zero)))))
    corr_new = torch.where(is_mul, mul_corr, torch.where(
        is_input, in_c, torch.where(
            op == G_ADD, a_c ^ b_c, torch.where(
                is_addc, a_c ^ cbit, torch.where(
                    op == G_MULC, a_c & cbit, torch.where(op == G_CONST, cbit, zero))))))
    mask.index_copy_(0, c[_DST], mask_new)
    corr.index_copy_(0, c[_DST], corr_new)
    if mode != VERIFY_PRE:
        st["onl2"].index_copy_(0, c[_ONL], torch.where(is_mul, s, torch.where(
            op == G_ASSERT, s_assert, torch.where(is_input, _expand(in_c), zero))))
    st["pre2"].index_copy_(0, c[_PRE], _expand(delta))


def _z64_wave(st: dict, c: torch.Tensor, kinds: frozenset, bits: torch.Tensor, mode: int,
              inp: dict) -> None:
    """One wave of z64 slots (c: the wave's columns, (16, Wz) int64) on the
    plain version's state, as `_scan_trace`'s `z64_slots` (tpu_scan.py
    :430-689) with int64 arithmetic, which wraps mod 2^64: each slot
    computes the gate families of the wave (`kinds`, its opcodes; as
    `_scan_trace` skips those absent from the circuit, a skipped family's
    select could never be taken) and selects by opcode.  A B2A slot reads
    the GF(2) values of earlier waves through its row of `bits`."""
    maskz, corrz = st["maskz"], st["corrz"]
    op = c[_ZOP]
    op2, op3 = op[:, None], op[:, None, None]
    Wz, R, dev = op.shape[0], maskz.shape[2], op.device
    tapez, xinz, coz, rez, re2 = (inp[k] for k in ("tapez", "xinz", "coz", "rez", "re2"))
    has = kinds.intersection
    am, ac = maskz.index_select(0, c[_ZA]), corrz.index_select(0, c[_ZA])  # (Wz, 8, R), (Wz, R)
    if has((G_ADD, Z_SUB, G_MUL, B2A_OUT)):  # b, or B2A_OUT's zr
        bm, bc = maskz.index_select(0, c[_ZB]), corrz.index_select(0, c[_ZB])
    if has((G_INPUT, G_RANDOM, B2A_CORR, G_MUL)):
        t0 = tapez.index_select(0, c[_ZT0])
        r0 = t0.sum(dim=1)
    k = ((c[_ZCHI] << 32) | (c[_ZCLO] & 0xFFFF_FFFF))[:, None]
    if mode == VERIFY_ONL:
        rz = rez.index_select(0, c[_ZREC])
        dco = coz.index_select(0, c[_ZCORR])
    mask_sel, corr_sel, pre_sel = [], [], []
    if G_INPUT in kinds:
        if mode == PROVER:
            in_c = xinz.index_select(0, c[_ZXIN]) - r0
        elif mode == VERIFY_ONL:
            in_c = xinz.index_select(0, c[_ZXIN])
        else:
            in_c = torch.zeros_like(ac)
        mask_sel.append((G_INPUT, t0))
        corr_sel.append((G_INPUT, in_c))
    sa = am + rz if mode == VERIFY_ONL else am
    if G_MUL in kinds:
        t1 = tapez.index_select(0, c[_ZT1])
        d = dco if mode == VERIFY_ONL else am.sum(dim=1) * bm.sum(dim=1) - r0
        s = bm * ac[:, None] + am * bc[:, None] + t0 - t1
        if mode == VERIFY_ONL:
            s = s + rz
        re = torch.zeros_like(d) if mode == VERIFY_PRE else s.sum(dim=1) + d
        mask_sel.append((G_MUL, t1))
        corr_sel.append((G_MUL, re + ac * bc))
        pre_sel.append((G_MUL, d))
    if G_ASSERT in kinds and mode != VERIFY_PRE:
        bad = (sa.sum(dim=1) + ac) != 0
        st["fail"] |= ((op2 == G_ASSERT) & bad).any(dim=0)
    if has((B2A_CORR, B2A_OUT)):  # the 64 GF(2) values of each slot's row of bits
        rows = bits.index_select(0, c[_ZBITS]).reshape(-1)
        bm2 = st["mask2"].index_select(0, rows).reshape(Wz, 64, R)
    if B2A_CORR in kinds:
        bcc = dco if mode == VERIFY_ONL else _compose_bits(_parity8(bm2)) - r0
        mask_sel.append((B2A_CORR, t0))
        corr_sel.append((B2A_CORR, bcc))
        pre_sel.append((B2A_CORR, bcc))
    if B2A_OUT in kinds:
        bc2 = st["corr2"].index_select(0, rows).reshape(Wz, 64, R)
        sb = bm2
        if mode == VERIFY_ONL:
            brec = torch.where(op2 == B2A_OUT, c[_ZBREC][:, None] + torch.arange(64, device=dev),
                               0)
            sb = bm2 ^ re2.index_select(0, brec.reshape(-1)).reshape(bm2.shape)
        ob = bc2 if mode == VERIFY_PRE else _parity8(sb) ^ bc2
        mask_sel.append((B2A_OUT, -bm))
        corr_sel.append((B2A_OUT, _compose_bits(ob) - bc))
    if G_RANDOM in kinds:
        mask_sel.append((G_RANDOM, t0))
    if G_ADD in kinds:
        mask_sel.append((G_ADD, am + bm))
        corr_sel.append((G_ADD, ac + bc))
    if Z_SUB in kinds:
        mask_sel.append((Z_SUB, am - bm))
        corr_sel.append((Z_SUB, ac - bc))
    mask_sel += [(kind, am) for kind in kinds & {G_ADDC, G_SUBC}]
    if G_ADDC in kinds:
        corr_sel.append((G_ADDC, ac + k))
    if G_SUBC in kinds:
        corr_sel.append((G_SUBC, ac - k))
    if G_MULC in kinds:
        mask_sel.append((G_MULC, am * k[:, :, None]))
        corr_sel.append((G_MULC, ac * k))
    if G_CONST in kinds:
        corr_sel.append((G_CONST, k.expand_as(ac)))
    mask_new, corr_new = torch.zeros_like(am), torch.zeros_like(ac)
    for kind, v in mask_sel:
        mask_new = torch.where(op3 == kind, v, mask_new)
    for kind, v in corr_sel:
        corr_new = torch.where(op2 == kind, v, corr_new)
    maskz.index_copy_(0, c[_ZDST], mask_new)
    corrz.index_copy_(0, c[_ZDST], corr_new)

    # events, each at its run of rows: prez (MUL delta, B2A_CORR
    # correction), onlz (MUL and ASSERT_ZERO shares, INPUT corrections) and
    # onl2 (B2A_OUT's 64 bit reconstructions)
    run = torch.arange(64, device=dev)
    for kind, v in pre_sel:
        keep = (op == kind)[:, None].expand(Wz, 8)
        st["prez"].index_copy_(0, (c[_ZPRE][:, None] + run[:8]).expand(Wz, 8)[keep],
                               _word_bytes(v).reshape(Wz, 8, R)[keep])
    if mode == VERIFY_PRE:
        return
    for kind, v, n in ((G_MUL, s if G_MUL in kinds else None, 64), (G_ASSERT, sa, 64),
                       (G_INPUT, in_c if G_INPUT in kinds else None, 8)):
        if kind in kinds:
            keep = (op == kind)[:, None] & (run < n)
            ev = (_word_bytes(v).reshape(Wz, 8, R) if kind == G_INPUT
                  else _share_bytes(v).reshape(Wz, 64, R))
            st["onlz"].index_copy_(0, (c[_ZONL][:, None] + run)[keep], ev[keep[:, :ev.shape[1]]])
    if B2A_OUT in kinds:
        keep = (op == B2A_OUT)[:, None].expand(Wz, 64)
        st["onl2"].index_copy_(0, (c[_ZBONL][:, None] + run)[keep], sb[keep])


def wave_ref(table: torch.Tensor, mode: int, tape: torch.Tensor, xin: Optional[torch.Tensor],
             co2: Optional[torch.Tensor], re2: Optional[torch.Tensor], n_vals: int,
             n_onl: int, n_pre: int, ztable: Optional[torch.Tensor] = None,
             bits: Optional[torch.Tensor] = None, n_valsz: int = 0,
             tapez: Optional[torch.Tensor] = None, xinz: Optional[torch.Tensor] = None,
             coz: Optional[torch.Tensor] = None, rez: Optional[torch.Tensor] = None,
             n_onlz: int = 0, n_prez: int = 0, carry: Optional[Dict[str, torch.Tensor]] = None,
             carry_mask2: Optional[torch.Tensor] = None,
             carry_corr2: Optional[torch.Tensor] = None,
             carry_maskz: Optional[torch.Tensor] = None,
             carry_corrz: Optional[torch.Tensor] = None) -> WaveOut:
    """Plain PyTorch version of the wave kernels: the waves of `table`
    (wave_table) and, with z64 slots, of `ztable` and `bits` (zwave_table)
    one at a time, a wave's z64 slots (which read GF(2) values of earlier
    waves) before its GF(2) slots, as `_scan_trace`'s body (tpu_scan.py
    :691-781).  tape (m2, R) uint8; xin wit2 (PROVER) or in2 (VERIFY_ONL);
    co2, re2 (VERIFY_ONL); tapez (mz, 8, R) int64; xinz witz (PROVER) or
    inz (VERIFY_ONL), coz (rows, R) and rez (rows, 8, R) int64 (VERIFY_ONL).
    carry: the slots 'cin', 'cout', 'cinz', 'coutz' (int32) of the carried
    values, the carried-in rows coming as carry_mask2 ... carry_corrz.
    NOP slots and unused fields write the trash rows build_waves points them
    at (arena rows n_vals and n_valsz, stream rows n_onl, n_pre, n_onlz,
    n_prez), which are cut off."""
    R, dev = tape.shape[1], tape.device
    u8 = dict(dtype=torch.uint8, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    carry = carry or {}
    st = dict(mask2=torch.zeros((n_vals + 1, R), **u8), corr2=torch.zeros((n_vals + 1, R), **u8),
              onl2=torch.zeros((n_onl + 1, R), **u8), pre2=torch.zeros((n_pre + 1, R), **u8),
              fail=torch.zeros((R,), dtype=torch.bool, device=dev))
    has_z = ztable is not None
    if has_z:
        st.update(maskz=torch.zeros((n_valsz + 1, 8, R), **i64),
                  corrz=torch.zeros((n_valsz + 1, R), **i64),
                  onlz=torch.zeros((n_onlz + 1, R), **u8), prez=torch.zeros((n_prez + 1, R), **u8))
    for names, slots, rows in ((("mask2", "corr2"), "cin", (carry_mask2, carry_corr2)),
                               (("maskz", "corrz"), "cinz", (carry_maskz, carry_corrz))):
        idx = carry.get(slots)
        if idx is not None and len(idx):
            for name, r in zip(names, rows):
                st[name][idx.to(dev, torch.int64)] = r
    tape, xin, co2, re2 = (_rows(x, R, dev) for x in (tape, xin, co2, re2))
    zin = dict(tapez=_rows(tapez, R, dev, (8,), torch.int64), xinz=_rows(xinz, R, dev, (), torch.int64),
               coz=_rows(coz, R, dev, (), torch.int64), rez=_rows(rez, R, dev, (8,), torch.int64),
               re2=re2)
    cols = table.to(dev, torch.int64).permute(0, 2, 1).contiguous()  # (n_waves, 12, W)
    zcols = ztable.to(dev, torch.int64).permute(0, 2, 1).contiguous() if has_z else None
    if has_z:  # a row for the gathers of slots that are not B2A
        bits = bits.to(dev, torch.int64) if len(bits) else torch.zeros((1, 64), **i64)
    # a wave's NOP slots write only trash rows: a half with no other slot
    # is skipped
    live = (table[..., _OP] != _NOP).any(dim=1).tolist()
    zkinds = ([frozenset(np.unique(w).tolist()) - {_NOP}
               for w in ztable[..., _ZOP].cpu().numpy()] if has_z else None)
    for w in range(cols.shape[0]):
        if has_z and zkinds[w]:
            _z64_wave(st, zcols[w], zkinds[w], bits, mode, zin)
        if live[w]:
            _gf2_wave(st, cols[w], mode, tape, xin, co2, re2)

    def out_rows(names, slots, lead):
        idx = carry.get(slots)
        if idx is None or not len(idx) or names[0] not in st:
            dt = torch.int64 if lead is not None else torch.uint8
            return (torch.zeros((0, *(lead or ()), R), dtype=dt, device=dev),
                    torch.zeros((0, R), dtype=dt, device=dev))
        idx = idx.to(dev, torch.int64)
        return tuple(st[n].index_select(0, idx) for n in names)

    empty = torch.zeros((1, R), **u8)
    return WaveOut(_stream(st["onl2"], n_onl), _stream(st["pre2"], n_pre), st["fail"],
                   _stream(st["onlz"], n_onlz) if has_z else empty,
                   _stream(st["prez"], n_prez) if has_z else empty.clone(),
                   *out_rows(("mask2", "corr2"), "cout", None),
                   *out_rows(("maskz", "corrz"), "coutz", (8,)))


def wave_gf2_ref(table: torch.Tensor, mode: int, tape: torch.Tensor,
                 xin: Optional[torch.Tensor], co2: Optional[torch.Tensor],
                 re2: Optional[torch.Tensor], n_vals: int, n_onl: int, n_pre: int):
    """wave_ref of a pure-GF(2) table -> (onl2, pre2, fail)."""
    return tuple(wave_ref(table, mode, tape, xin, co2, re2, n_vals, n_onl, n_pre)[:3])


def wave_plain(prog: WaveProgram, mode: int, tape: torch.Tensor, xin: Optional[torch.Tensor],
               co2: Optional[torch.Tensor], re2: Optional[torch.Tensor], n_onl: int, n_pre: int,
               tapez: Optional[torch.Tensor] = None, xinz: Optional[torch.Tensor] = None,
               coz: Optional[torch.Tensor] = None, rez: Optional[torch.Tensor] = None,
               n_onlz: int = 0, n_prez: int = 0, carry_mask2: Optional[torch.Tensor] = None,
               carry_corr2: Optional[torch.Tensor] = None,
               carry_maskz: Optional[torch.Tensor] = None,
               carry_corrz: Optional[torch.Tensor] = None) -> WaveOut:
    """wave_ref on `prog`'s slot tables with wave_run's arguments, on the
    inputs' device: the plain version wave_run takes for CPU tensors."""
    return wave_ref(prog.table, mode, tape, xin, co2, re2, prog.n_vals, n_onl, n_pre,
                    prog.ztable, prog.bits, prog.n_valsz, tapez, xinz, coz, rez, n_onlz, n_prez,
                    prog.carry, carry_mask2, carry_corr2, carry_maskz, carry_corrz)


def _check_rows(name: str, t: Optional[torch.Tensor], R: int, device, dtype=torch.uint8,
                lead=()) -> None:
    if t is None:
        return
    if (t.device != device or t.dtype != dtype or t.dim() != 2 + len(lead)
            or tuple(t.shape[1:]) != (*lead, R) or not t.is_contiguous()):
        raise ValueError(f"wave_run: {name} must be a contiguous {dtype} (rows, "
                         f"{', '.join(map(str, (*lead, R)))}) tensor on {device}")


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _args(prog: WaveProgram, mode: int, R: int, tape, xin, co2, re2, spill, onl, pre, fail,
          stream: int, carry_in, carry_out) -> list:
    """The GF(2) half of a launch's arguments, as int64 words
    (csrc/scan_core.cuh `launch_args`): the packed table, the plan, the
    inputs, the spill arena and the outputs, and the GF(2) carries (slots,
    count, mask rows, corr rows, in then out)."""
    p = prog.plan
    cin, cout = prog.carry.get("cin"), prog.carry.get("cout")
    return [prog.slots.data_ptr(), prog.fields.data_ptr(), prog.chunk_off.data_ptr(),
            prog.slots.shape[0], prog.slots.shape[1], mode, R, prog.n_shared, p.reps, p.k,
            p.chunk, p.fields, p.threads_y, _ptr(tape), _ptr(xin), _ptr(co2), _ptr(re2),
            spill.data_ptr(), onl.data_ptr(), pre.data_ptr(), fail.data_ptr(), stream,
            _ptr(cin), 0 if cin is None else len(cin), *map(_ptr, carry_in),
            _ptr(cout), 0 if cout is None else len(cout), *map(_ptr, carry_out)]


def wave_run(prog: WaveProgram, mode: int, tape: torch.Tensor, xin: Optional[torch.Tensor],
             co2: Optional[torch.Tensor], re2: Optional[torch.Tensor], n_onl: int, n_pre: int,
             tapez: Optional[torch.Tensor] = None, xinz: Optional[torch.Tensor] = None,
             coz: Optional[torch.Tensor] = None, rez: Optional[torch.Tensor] = None,
             n_onlz: int = 0, n_prez: int = 0, carry_mask2: Optional[torch.Tensor] = None,
             carry_corr2: Optional[torch.Tensor] = None,
             carry_maskz: Optional[torch.Tensor] = None,
             carry_corrz: Optional[torch.Tensor] = None) -> WaveOut:
    """The waves of `prog` over R = tape.shape[1] lanes -> WaveOut (its
    first three: onl2 (max(n_onl, 1), R) uint8, pre2 (max(n_pre, 1), R)
    uint8, fail (R,) bool).  The z64 inputs (tapez, xinz: witz or inz, coz,
    rez) and sizes (n_onlz, n_prez) serve a program with z64 slots, the
    carried-in rows one with carries (prog.carry).  CPU tensors take the
    plain version on the slot tables; CUDA tensors launch, once for every
    wave, csrc/scan_gf2.cu (W1) for a pure-GF(2) program or
    csrc/scan_z64.cu (W2) for one with z64 slots, with the live values in
    shared memory and spill arenas of their own."""
    global LAUNCHES, LAUNCHES_Z64
    dev = tape.device
    if mode not in (PROVER, VERIFY_ONL, VERIFY_PRE):
        raise ValueError(f"wave_run: bad mode {mode}")
    R = tape.shape[1]
    has_z = prog.has_z64
    if has_z and tapez is None:
        raise ValueError("wave_run: a program with z64 slots needs tapez")
    for name, rows in (("cin", (carry_mask2, carry_corr2)), ("cinz", (carry_maskz, carry_corrz))):
        n = len(prog.carry.get(name, ()))
        if n and any(r is None or r.shape[0] != n for r in rows):
            raise ValueError(f"wave_run: the program carries {n} rows in ({name})")
    if dev.type == "cpu":
        return wave_plain(prog, mode, tape, xin, co2, re2, n_onl, n_pre, tapez, xinz, coz, rez,
                          n_onlz, n_prez, carry_mask2, carry_corr2, carry_maskz, carry_corrz)
    if dev.type != "cuda":
        raise ValueError(f"wave_run: unsupported device {dev}")
    if prog.slots is None or prog.slots.device != dev or (has_z and prog.zdev is None):
        raise ValueError(f"wave_run: the program's packed table is not on {dev}")
    for name, t in (("tape", tape), ("xin", xin), ("co2", co2), ("re2", re2),
                    ("carry_mask2", carry_mask2), ("carry_corr2", carry_corr2)):
        _check_rows(name, t, R, dev)
    for name, t, lead in (("tapez", tapez, (8,)), ("xinz", xinz, ()), ("coz", coz, ()),
                          ("rez", rez, (8,)), ("carry_maskz", carry_maskz, (8,)),
                          ("carry_corrz", carry_corrz, ())):
        _check_rows(name, t, R, dev, torch.int64, lead)
    u8 = dict(dtype=torch.uint8, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    nc = (len(prog.carry["cout"]), len(prog.carry["coutz"]))
    out = WaveOut(torch.zeros((max(n_onl, 1), R), **u8), torch.zeros((max(n_pre, 1), R), **u8),
                  torch.zeros((R,), dtype=torch.bool, device=dev),
                  torch.zeros((max(n_onlz, 1) if has_z else 1, R), **u8),
                  torch.zeros((max(n_prez, 1) if has_z else 1, R), **u8),
                  torch.zeros((nc[0], R), **u8), torch.zeros((nc[0], R), **u8),
                  torch.zeros((nc[1], 8, R), **i64), torch.zeros((nc[1], R), **i64))
    if R == 0:
        return out
    spill = torch.empty((max(prog.n_spill, 1), 4 * -(-R // 4)), dtype=torch.int16, device=dev)
    lib = _build.kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    words = _args(prog, mode, R, tape, xin, co2, re2, spill, out.onl2, out.pre2, out.fail,
                  stream, (carry_mask2, carry_corr2), (out.carry_mask2, out.carry_corr2))
    if not has_z:
        words = np.asarray(words, dtype=np.int64)  # alive through the call
        with torch.cuda.device(dev):  # the C side plans for the current device
            rc = lib.reverie_scan_gf2(words.ctypes.data)
        _build.check(rc, "scan_gf2 kernel")
        LAUNCHES += 1
        return out
    spillz = torch.empty((max(prog.n_spillz, 1), 9, R), **i64)
    zs, zf, zo, zb = prog.zdev
    p = prog.plan
    words += [zs.data_ptr(), zs.shape[1], _ptr(zf), zo.data_ptr(), _ptr(zb), prog.n_sharedz,
              p.zwords, p.zbits, p.zlanes, _ptr(tapez), _ptr(xinz), _ptr(coz), _ptr(rez),
              spillz.data_ptr(), out.onlz.data_ptr(), out.prez.data_ptr(),
              _ptr(prog.carry["cinz"]), len(prog.carry["cinz"]), _ptr(carry_maskz),
              _ptr(carry_corrz), _ptr(prog.carry["coutz"]), nc[1], out.carry_maskz.data_ptr(),
              out.carry_corrz.data_ptr()]
    words = np.asarray(words, dtype=np.int64)  # alive through the call
    with torch.cuda.device(dev):
        rc = lib.reverie_scan_z64(words.ctypes.data)
    _build.check(rc, "scan_z64 kernel")
    LAUNCHES_Z64 += 1
    return out


def _plan_words(prog: WaveProgram, mode: int, R: int) -> np.ndarray:
    """A launch's int64 words (`wave_run`) with its sizes and plan, every
    pointer 0."""
    p = prog.plan
    words = [0, 0, 0, prog.table.shape[0], prog.table.shape[1], mode, R, prog.n_shared, p.reps,
             p.k, p.chunk, p.fields, p.threads_y] + [0] * 17
    if prog.has_z64:
        words += [0, prog.ztable.shape[1], 0, 0, 0, prog.n_sharedz, p.zwords, p.zbits,
                  p.zlanes] + [0] * 15
    return np.asarray(words, dtype=np.int64)


def resident_blocks(prog: WaveProgram, mode: int, R: int) -> int:
    """Blocks of `prog`'s launch at R lanes that one SM holds at once (the
    CUDA occupancy calculator, with the kernel's shared memory allowed as
    for a launch); needs the card."""
    out = ctypes.c_int(0)
    fn = _build.kernels().reverie_scan_z64_plan if prog.has_z64 else \
        _build.kernels().reverie_scan_gf2_plan
    words = _plan_words(prog, mode, R)  # alive through the call
    _build.check(fn(words.ctypes.data, ctypes.addressof(out)), "scan plan")
    return out.value


def kernel_smem_bytes(prog: WaveProgram, mode: int, R: int) -> int:
    """W2's own count of the dynamic shared memory of a block of `prog`'s
    launch at R lanes (csrc/scan_z64.cu z_smem_bytes and the GF(2) half's),
    which `prog.smem_bytes` must equal; needs the built kernels."""
    out = ctypes.c_longlong(0)
    words = _plan_words(prog, mode, R)  # alive through the call
    _build.check(_build.kernels().reverie_scan_z64_smem(words.ctypes.data,
                                                        ctypes.addressof(out)), "scan smem")
    return out.value


class ScanExecutor:
    """Wave executor for one compiled circuit in one role, with the call
    contract of the levelized `Executor`, its segment carries included
    (carry_in, carry_out_vals and the z64 twins: the inputs and outputs
    'carry_mask2', 'carry_corr2', 'carry_maskz', 'carry_corrz').  The slots
    are allocated once per circuit, width and carries and the packed tables
    go to the device once, here; each call is one `wave_run` (one kernel
    launch on CUDA)."""

    def __init__(self, cc: CompiledCircuit, mode: int, total_reps: int,
                 device: torch.device, wave_width: int = 0, carry_in: int = 0,
                 carry_out_vals=None, carry_inz: int = 0, carry_outz_vals=None):
        self.cc = cc
        self.mode = mode
        self.R = total_reps
        self.device = device
        self.carry = Carry.of(carry_in, carry_out_vals, carry_inz, carry_outz_vals)
        self.waves = waves(cc, wave_width)
        self.program = circuit_program(cc, mode, device, total_reps, wave_width,
                                       carry=self.carry)

    @property
    def table(self) -> torch.Tensor:
        """The slot-allocated GF(2) table (wave_table layout) of the plain
        version."""
        return self.program.table

    def __call__(self, inp: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        cc, R, mode = self.cc, self.R, self.mode
        tape = inp["tape"]
        if tape.shape[1] != R:
            raise ValueError(f"ScanExecutor: the tape has {tape.shape[1]} lanes, not {R}")
        onl = mode == VERIFY_ONL
        xin = inp.get("wit2") if mode == PROVER else inp.get("in2") if onl else None
        xinz = inp.get("witz") if mode == PROVER else inp.get("inz") if onl else None
        c = self.carry
        out = wave_run(
            self.program, mode, tape, xin, inp.get("co2") if onl else None,
            inp.get("re2") if onl else None, cc.onl2, cc.pre2,
            inp.get("tapez") if self.program.has_z64 else None, xinz,
            inp.get("coz") if onl else None, inp.get("rez") if onl else None, cc.onlz, cc.prez,
            *(inp.get(k) if c.n_in else None for k in ("carry_mask2", "carry_corr2")),
            *(inp.get(k) if c.n_inz else None for k in ("carry_maskz", "carry_corrz")))
        res = {"onl2": out.onl2, "pre2": out.pre2, "onlz": out.onlz, "prez": out.prez,
               "fail": out.fail}
        if c.out:
            res.update(carry_mask2=out.carry_mask2, carry_corr2=out.carry_corr2)
        if c.outz:
            res.update(carry_maskz=out.carry_maskz, carry_corrz=out.carry_corrz)
        return res
