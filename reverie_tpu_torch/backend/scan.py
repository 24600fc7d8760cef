"""Wave executor for deep GF(2) circuits (SHA-256: 5,198 levels).

Port of reverie_tpu/backend/tpu_scan.py for pure-GF(2) circuits:
`default_wave_width` (:96), `ScanExecutor` (:120) and the body of its
`lax.scan`, `_scan_trace_fast2` (:247).  The gates are packed into uniform,
NOP-padded waves of W slots (circuit/compile.py `build_waves`); every
operand of a slot is produced in an earlier wave, so the slots of one wave
are independent and the waves run in order.  Where reverie_tpu compiles the
whole scan into one device program per role, the port runs it as one launch
of the CUDA kernel `csrc/scan_gf2.cu` per executor call (`wave_run`); on the
CPU the plain version `wave_gf2_ref` applies one wave at a time with torch
ops.

Before either runs, `allocate_slots` renumbers the table's SSA values into
slots by linear scan over their live intervals (SHA-256: 2,410 slots for
135,203 values), so that the kernel keeps a block's live values in shared
memory and spills the longest-lived to a global arena only past it;
`launch_plan` picks the block width and the waves staged at once from the
live set and R, and `pack_table` words the table for the kernel.  A
`WaveProgram` holds the result, once per circuit, width and role
(`circuit_program`); the plain version runs its slot table unchanged.

Left out, as layouts of the TPU rather than the contract: the fast2
wave-contiguous renumbering and its u16 mask|corr arena (row scatters cost
~17 us on the TPU), the stacked per-wave outputs with their post-scan
inverse gather, `optimization_barrier` and REVERIE_SCAN_UNROLL.  The
contract is the output streams and `fail`.  Also left out until their
slices: the z64 and B2A slots of `_scan_trace` (:374-804) and the segment
carries of streaming; a `WaveTable` with z64 columns raises ValueError.

The executor keeps the call contract of the levelized `Executor`: inputs
'tape' (m2, R) uint8, plus 'wit2' (n_wit2, R) in PROVER mode or 'in2',
'co2', 're2' in VERIFY_ONL mode; outputs 'onl2', 'pre2' (max(rows, 1), R)
uint8, empty 'onlz' and 'prez' (1, R) and 'fail' (R,) bool.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import heapq
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import _build
from ..roofline import SMS
from ..circuit.compile import (
    G_ADD,
    G_ADDC,
    G_ASSERT,
    G_CONST,
    G_INPUT,
    G_MUL,
    G_MULC,
    G_RANDOM,
    G_SUBC,
    CompiledCircuit,
    _NOP,
    WaveTable,
    build_waves,
)
from .executor import PROVER, VERIFY_ONL, VERIFY_PRE, _expand, _parity8, stream_bytes

#: kernel launches made by `wave_run` (CUDA tensors only)
LAUNCHES = 0

#: int32 columns of one slot of a packed wave table (`wave_table`); xin is
#: the witness row (PROVER) or the input record (VERIFY_ONL)
SLOT_COLS = ("op", "dst", "a", "b", "t0", "t1", "xin", "rec", "corr", "onl", "pre", "cbit")
_OP, _DST, _A, _B, _T0, _T1, _XIN, _REC, _CORR, _ONL, _PRE, _CBIT = range(len(SLOT_COLS))


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
    """The waves as one (n_waves, W, 12) int32 array of slots in SLOT_COLS
    order, the form `allocate_slots`, `wave_program` and `wave_gf2_ref`
    read.  Raises ValueError on a table with z64 slots."""
    if wv.has_z64:
        raise ValueError("the wave executor runs pure GF(2) circuits; this one has "
                         "z64 or B2A gates (they run on the levelized Executor)")
    xin = wv.wit if mode == PROVER else wv.inrec if mode == VERIFY_ONL else np.zeros_like(wv.op)
    cols = {"xin": xin, **{k: getattr(wv, k) for k in SLOT_COLS if k != "xin"}}
    return np.ascontiguousarray(np.stack([cols[k] for k in SLOT_COLS], axis=-1), dtype=np.int32)


#: gate kinds that read operand a, and operand b (the others carry 0 there)
_READS_A = (G_ADD, G_ADDC, G_SUBC, G_MULC, G_MUL, G_ASSERT)
_READS_B = (G_ADD, G_MUL)

#: dynamic shared memory one block may take on sm_90 (the H100's 227 KB)
SMEM_PER_BLOCK = 232_448
#: waves the wave kernel stages in shared memory at once (a chunk), most
#: first.  A block holds two chunks of packed slots (PACKED_WORDS int32
#: each), two chunks of input fields (one int32 each) and one chunk of the
#: fields' bytes (one a rep)
CHUNKS = (32, 16, 8, 4)
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
REPS_PER_BLOCK = (32, 16, 8)
MAX_THREADS = 1024
#: slots a packed head can name (dst takes its top 24 bits)
MAX_SLOTS = 1 << 24


def live_intervals(table: np.ndarray):
    """Per SSA value of a wave table (wave_table layout): the wave that
    writes it and the last wave that reads it (its writing wave if none
    does), -1 for values no slot writes; value 0, the zero, is not written.
    -> (first, last) int64 arrays over the values."""
    t = np.asarray(table)
    n_waves = t.shape[0]
    op, dst, a, b = (t[..., c].astype(np.int64) for c in (_OP, _DST, _A, _B))
    wave = np.broadcast_to(np.arange(n_waves, dtype=np.int64)[:, None], op.shape)
    writes = (op != _NOP) & (op != G_ASSERT)
    reads_a, reads_b = np.isin(op, _READS_A), np.isin(op, _READS_B)
    n = int(max(dst[writes].max(initial=0), a[reads_a].max(initial=0),
                b[reads_b].max(initial=0))) + 1
    if np.bincount(dst[writes], minlength=n).max(initial=0) > 1:
        raise ValueError("allocate_slots: a value is written twice (the table is not SSA)")
    first = np.full(n, -1, dtype=np.int64)
    first[dst[writes]] = wave[writes]
    last = first.copy()
    np.maximum.at(last, a[reads_a], wave[reads_a])
    np.maximum.at(last, b[reads_b], wave[reads_b])
    first[0] = last[0] = -1
    return first, last


def _live_counts(first: np.ndarray, last: np.ndarray, vals: np.ndarray, n_waves: int):
    count = np.zeros(n_waves + 1, dtype=np.int64)
    np.add.at(count, first[vals], 1)
    np.add.at(count, last[vals] + 1, -1)
    return np.cumsum(count)[:n_waves]


def live_set(table: np.ndarray) -> int:
    """The most values live at once over the waves of `table`, value 0
    included: the slots allocate_slots needs without spilling."""
    first, last = live_intervals(table)
    vals = np.nonzero(first >= 0)[0]
    return 1 + int(_live_counts(first, last, vals, np.asarray(table).shape[0]).max(initial=0))


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


def allocate_slots(table: np.ndarray, capacity: int):
    """Rewrite the SSA value numbers of a wave table (dst, a, b of
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
    if capacity < 1:
        raise ValueError("allocate_slots: capacity must hold slot 0")
    t = np.array(table, dtype=np.int32, copy=True)
    n_waves = t.shape[0]
    first, last = live_intervals(t)
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
    op = t[..., _OP]
    writes = (op != _NOP) & (op != G_ASSERT)
    trash = n_shared + n_spill
    t[..., _DST] = np.where(writes, slot[np.where(writes, t[..., _DST], 0)], trash)
    for col, kinds in ((_A, _READS_A), (_B, _READS_B)):
        reads = np.isin(op, kinds)
        t[..., col] = np.where(reads, slot[np.where(reads, t[..., col], 0)], 0)
    return t, n_shared, n_spill


def _field_counts(op: np.ndarray, mode: int) -> np.ndarray:
    """Input fields each slot reads in `mode` (_FIELDS)."""
    n = np.zeros(op.shape, dtype=np.int64)
    for kind, fields in _FIELDS[mode].items():
        n[op == kind] = len(fields)
    return n


def chunk_fields(table: np.ndarray, chunk: int) -> int:
    """The most input fields of any `chunk` consecutive waves of `table`
    (from wave 0 on) in the role that reads most (VERIFY_ONL): the rows
    of a block's staged fields."""
    per_wave = _field_counts(np.asarray(table)[..., _OP], VERIFY_ONL).sum(axis=1)
    n_chunks = -(-len(per_wave) // chunk)
    per_chunk = np.add.reduceat(per_wave, np.arange(n_chunks) * chunk) if len(per_wave) else [0]
    return max(1, int(np.max(per_chunk)))


@dataclasses.dataclass(frozen=True)
class WavePlan:
    """How the wave kernel covers R lanes: `reps` consecutive lanes per
    block, `chunk` waves staged in shared memory at once (at most
    `fields` input fields a chunk), `k` slots of a wave per thread over
    `threads_y` slot threads, and the slots a block can hold in shared
    memory (`capacity`)."""

    reps: int
    chunk: int
    fields: int
    k: int
    threads_y: int
    capacity: int


def staged_bytes(reps: int, W: int, chunk: int, fields: int) -> int:
    """Shared memory of a block that is not slots: two chunks of packed
    slots and of input fields, one chunk of the fields' bytes, and 32 fail
    flags."""
    return 2 * chunk * W * PACKED_WORDS * 4 + 2 * fields * 4 + fields * reps + 32


def slot_capacity(reps: int, W: int, chunk: int, fields: int) -> int:
    """Slots of `reps` lanes (2 bytes each) that fit a block's shared memory
    beside its staged waves (staged_bytes)."""
    return (SMEM_PER_BLOCK - staged_bytes(reps, W, chunk, fields)) // (2 * reps)


def launch_plan(n_live: int, table: np.ndarray, R: int = 0, reps: int = 0) -> WavePlan:
    """The wave kernel's plan at R lanes for a wave table whose live set is
    n_live slots (live_set).  Where the blocks of 8 reps fit the card at
    once (R <= 8 x SMS), 8 reps a block: its barrier and its waves have the
    fewest warps.  Past that, the widest block of REPS_PER_BLOCK that holds
    the live set: each SM then runs the fewest rounds of the chain.  The
    chunk is the longest of CHUNKS that fits beside the live set, so that
    its staging is paid the fewest times; where none fits, 8 reps and
    chunks of 4 (the most slots; the rest spill).  `reps` forces the block
    width.  Each thread takes k of a wave's slots, the fewest (a power of
    two, at most 4) that keep the block within MAX_THREADS.  Raises
    ValueError where the staged waves leave a block no room for slots."""
    W = np.asarray(table).shape[1]
    fields = {c: chunk_fields(table, c) for c in CHUNKS}
    widths = (reps,) if reps else (REPS_PER_BLOCK[::-1] if 0 < R <= 8 * SMS else REPS_PER_BLOCK)
    fits = [(p, c) for p in widths for c in fields
            if slot_capacity(p, W, c, fields[c]) >= n_live and p // 4 * -(-W // 4) <= MAX_THREADS]
    reps, chunk = fits[0] if fits else (reps or REPS_PER_BLOCK[-1], CHUNKS[-1])
    if reps not in REPS_PER_BLOCK:
        raise ValueError(f"launch_plan: reps per block must be one of {REPS_PER_BLOCK}")
    capacity = slot_capacity(reps, W, chunk, fields[chunk])
    if capacity < 2:
        raise ValueError(f"launch_plan: {chunk} waves of {W} slots leave no shared memory "
                         f"for slots")
    k = 1
    while reps // 4 * -(-W // k) > MAX_THREADS:
        k *= 2
    if k > 4:
        raise ValueError(f"launch_plan: a wave of {W} slots needs {k} slots a thread (at "
                         f"most 4)")
    return WavePlan(reps, chunk, fields[chunk], k, -(-W // k), capacity)


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


@dataclasses.dataclass
class WaveProgram:
    """One role's waves, ready for `wave_run`: the slot-allocated table
    (for the plain version, on the CPU), its packed slots, input fields and
    chunk offsets (pack_table) on the device (None on the CPU), the slots
    in shared memory and spilled, and the launch plan."""

    table: torch.Tensor
    slots: Optional[torch.Tensor]
    fields: Optional[torch.Tensor]
    chunk_off: Optional[torch.Tensor]
    n_shared: int
    n_spill: int
    plan: WavePlan

    @property
    def n_vals(self) -> int:
        """Rows of the plain version's arena (its trash row is the next)."""
        return self.n_shared + self.n_spill

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of one block: the staged waves and fail
        flags (staged_bytes) and the shared slots."""
        p = self.plan
        return (staged_bytes(p.reps, self.table.shape[1], p.chunk, p.fields)
                + 2 * self.n_shared * p.reps)


def wave_program(table: np.ndarray, mode: int, device: torch.device, R: int = 0,
                 capacity: int = 0, reps: int = 0, plan: Optional[WavePlan] = None,
                 slots=None) -> WaveProgram:
    """A WaveProgram of an SSA wave table (wave_table layout) in one role at
    R lanes: the launch plan from its live set and R (`reps` as
    launch_plan's), or `plan`; the slots from allocate_slots at the plan's
    capacity (or `capacity`, smaller, to force spills), or `slots`, a
    (table', n_shared, n_spill) already allocated for that capacity."""
    table = np.asarray(table)
    if table.ndim != 3 or table.shape[2] != len(SLOT_COLS):
        raise ValueError(f"wave_program: the table must be (n_waves, W, {len(SLOT_COLS)})")
    if plan is None:
        plan = launch_plan(live_set(table), table, R, reps)
    cap = min(capacity, plan.capacity) if capacity > 0 else plan.capacity
    if slots is None:
        slots = allocate_slots(table, cap)
    t, n_shared, n_spill = slots
    if n_shared > plan.capacity:
        raise ValueError(f"wave_program: {n_shared} shared slots above the plan's "
                         f"{plan.capacity}")
    packed = (None,) * 3
    if device.type == "cuda":
        packed = tuple(torch.from_numpy(a).to(device) for a in pack_table(t, mode, plan.chunk))
    return WaveProgram(torch.from_numpy(t), *packed, n_shared, n_spill, plan)


@dataclasses.dataclass
class CircuitWaves:
    """What the wave executor derives once per circuit and wave width, kept
    on the circuit (`CompiledCircuit.wave_tables`): build_waves' table and,
    on first use, its PROVER table (wave_table), live set and input fields,
    the launch plans (a plan depends on R only through R <= 8 x SMS, and
    footprints ask for one at every batch width) and the slot allocations
    by capacity (a SHA-256 table takes about a second)."""

    waves: WaveTable
    plans: Dict[bool, WavePlan] = dataclasses.field(default_factory=dict)
    slots: Dict[int, Tuple[np.ndarray, int, int]] = dataclasses.field(default_factory=dict)

    @functools.cached_property
    def table(self) -> np.ndarray:
        return wave_table(self.waves, PROVER)

    @functools.cached_property
    def n_live(self) -> int:
        return live_set(self.table)

    @functools.cached_property
    def n_fields(self) -> int:
        """Input fields of the packed PROVER table."""
        return int(_field_counts(self.waves.op, PROVER).sum())

    def plan(self, R: int = 0, reps: int = 0) -> WavePlan:
        """launch_plan at R lanes (`reps` forces the block width, uncached)."""
        if reps:
            return launch_plan(self.n_live, self.table, R, reps)
        key = 0 < R <= 8 * SMS
        if key not in self.plans:
            self.plans[key] = launch_plan(self.n_live, self.table, R)
        return self.plans[key]

    def allocation(self, capacity: int) -> Tuple[np.ndarray, int, int]:
        """allocate_slots of the PROVER table at `capacity`; every role
        shares it (only the xin column differs between them)."""
        if capacity not in self.slots:
            self.slots[capacity] = allocate_slots(self.table, capacity)
        return self.slots[capacity]


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
                    wave_width: int = 0, reps: int = 0) -> WaveProgram:
    """The WaveProgram of cc's waves (`waves`) in one role at R lanes
    (`reps` as launch_plan's), its slots shared by every role and every
    plan whose shared memory holds them."""
    rec = circuit_waves(cc, wave_width)
    plan = rec.plan(R, reps)
    t, n_shared, n_spill = rec.allocation(plan.capacity)
    table = wave_table(rec.waves, mode)
    table[..., [_DST, _A, _B]] = t[..., [_DST, _A, _B]]
    return wave_program(table, mode, device, R, plan=plan, slots=(table, n_shared, n_spill))


def table_bytes(cc: CompiledCircuit, R: int = 0) -> int:
    """Bytes of the packed PROVER wave program at R lanes on the device
    (the default width): its slots, input fields and chunk offsets
    (pack_table)."""
    rec = circuit_waves(cc)
    n_waves, W = rec.waves.op.shape
    chunk = rec.plan(R).chunk
    return 4 * (n_waves * W * PACKED_WORDS + rec.n_fields + -(-n_waves // chunk) + 1)


def spill_rows(cc: CompiledCircuit, R: int = 0) -> int:
    """Rows of the wave kernel's global spill arena for cc at R lanes (0
    when its live set fits shared memory, as SHA-256's does)."""
    rec = circuit_waves(cc)
    return rec.allocation(rec.plan(R).capacity)[2]


def prover_bytes(cc: CompiledCircuit, R: int) -> int:
    """Device bytes a PROVER run at R lanes holds at its peak, the wave
    table apart (table_bytes): the inputs tape (m2, R) and wit2 (n_wit2, R)
    uint8 (tapez and witz have no rows); the kernel's spill arena,
    (spill_rows, R) int16 (mask | corr << 8; one row when nothing spills:
    the live values sit in shared memory); the four streams
    (executor.stream_bytes) and fail (R,)."""
    return ((cc.m2 + cc.n_wit2) * R + 8 * max(spill_rows(cc, R), 1) * -(-R // 4)
            + stream_bytes(cc, R) + R)


def _rows(src: Optional[torch.Tensor], R: int, device) -> torch.Tensor:
    """src, or one zero row where a mode does not read it (the gathers of
    slots that ignore it still need a row)."""
    if src is None or src.shape[0] == 0:
        return torch.zeros((1, R), dtype=torch.uint8, device=device)
    return src


def _stream(buf: torch.Tensor, n: int) -> torch.Tensor:
    """The first n rows of a stream buffer (its last row is the trash row
    of build_waves), or one zero row for an empty stream."""
    return buf[:n] if n else torch.zeros_like(buf[:1])


def wave_gf2_ref(table: torch.Tensor, mode: int, tape: torch.Tensor,
                 xin: Optional[torch.Tensor], co2: Optional[torch.Tensor],
                 re2: Optional[torch.Tensor], n_vals: int, n_onl: int, n_pre: int):
    """Plain PyTorch version of the wave kernel: the waves of `table`
    (wave_table) one at a time, each slot computing every gate family and
    selecting by opcode as `_scan_trace_fast2`'s body does (tpu_scan.py
    :280-348).  tape (m2, R) uint8; xin wit2 (PROVER) or in2 (VERIFY_ONL);
    co2, re2 (VERIFY_ONL).  NOP slots and unused fields write the trash
    rows build_waves points them at (arena row n_vals, stream rows n_onl and
    n_pre), which are cut off.  -> (onl2, pre2, fail) as the kernel
    returns them."""
    R, dev = tape.shape[1], tape.device
    u8 = dict(dtype=torch.uint8, device=dev)
    mask = torch.zeros((n_vals + 1, R), **u8)
    corr = torch.zeros((n_vals + 1, R), **u8)
    onl = torch.zeros((n_onl + 1, R), **u8)
    pre = torch.zeros((n_pre + 1, R), **u8)
    fail = torch.zeros((R,), dtype=torch.bool, device=dev)
    tape, xin, co2, re2 = (_rows(x, R, dev) for x in (tape, xin, co2, re2))
    zero = torch.zeros((), **u8)
    cols = table.to(torch.int64).permute(0, 2, 1).contiguous()  # (n_waves, 12, W)
    for c in cols:
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
            fail |= ((op == G_ASSERT) & a_nonzero).any(dim=0)

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
            onl.index_copy_(0, c[_ONL], torch.where(is_mul, s, torch.where(
                op == G_ASSERT, s_assert, torch.where(is_input, _expand(in_c), zero))))
        pre.index_copy_(0, c[_PRE], _expand(delta))
    return _stream(onl, n_onl), _stream(pre, n_pre), fail


def _check_rows(name: str, t: Optional[torch.Tensor], R: int, device) -> None:
    if t is None:
        return
    if (t.device != device or t.dtype != torch.uint8 or t.dim() != 2
            or t.shape[1] != R or not t.is_contiguous()):
        raise ValueError(f"wave_run: {name} must be a contiguous uint8 (rows, {R}) "
                         f"tensor on {device}")


def wave_run(prog: WaveProgram, mode: int, tape: torch.Tensor, xin: Optional[torch.Tensor],
             co2: Optional[torch.Tensor], re2: Optional[torch.Tensor], n_onl: int, n_pre: int):
    """The waves of `prog` over R = tape.shape[1] lanes -> (onl2
    (max(n_onl, 1), R) uint8, pre2 (max(n_pre, 1), R) uint8, fail (R,)
    bool).  CPU tensors take the plain version on the slot-allocated table;
    CUDA tensors launch csrc/scan_gf2.cu once, for every wave, with the
    live values in shared memory and a (n_spill, R) int16 spill arena of
    its own."""
    global LAUNCHES
    dev = tape.device
    if mode not in (PROVER, VERIFY_ONL, VERIFY_PRE):
        raise ValueError(f"wave_run: bad mode {mode}")
    if dev.type == "cpu":
        return wave_gf2_ref(prog.table, mode, tape, xin, co2, re2, prog.n_vals, n_onl, n_pre)
    if dev.type != "cuda":
        raise ValueError(f"wave_run: unsupported device {dev}")
    if prog.slots is None or prog.slots.device != dev:
        raise ValueError(f"wave_run: the program's packed table is not on {dev}")
    R = tape.shape[1]
    for name, t in (("tape", tape), ("xin", xin), ("co2", co2), ("re2", re2)):
        _check_rows(name, t, R, dev)
    u8 = dict(dtype=torch.uint8, device=dev)
    onl = torch.zeros((max(n_onl, 1), R), **u8)
    pre = torch.zeros((max(n_pre, 1), R), **u8)
    fail = torch.zeros((R,), dtype=torch.bool, device=dev)
    if R == 0:
        return onl, pre, fail
    spill = torch.empty((max(prog.n_spill, 1), 4 * -(-R // 4)), dtype=torch.int16, device=dev)
    lib = _build.kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()

    n_waves, Wp = prog.slots.shape[0], prog.slots.shape[1]
    p = prog.plan
    rc = lib.reverie_scan_gf2(prog.slots.data_ptr(), prog.fields.data_ptr(),
                              prog.chunk_off.data_ptr(), n_waves, Wp, mode, R, prog.n_shared,
                              p.reps, p.k, p.chunk, p.fields, tape.data_ptr(), ptr(xin),
                              ptr(co2), ptr(re2), spill.data_ptr(), onl.data_ptr(),
                              pre.data_ptr(), fail.data_ptr(), stream)
    _build.check(rc, "scan_gf2 kernel")
    LAUNCHES += 1
    return onl, pre, fail


def resident_blocks(prog: WaveProgram, mode: int, R: int) -> int:
    """Blocks of `prog`'s launch at R lanes that one SM holds at once (the
    CUDA occupancy calculator, with the kernel's shared memory allowed as
    for a launch); needs the card."""
    out = ctypes.c_int(0)
    rc = _build.kernels().reverie_scan_gf2_plan(
        mode, prog.slots.shape[1], prog.n_shared, prog.plan.reps, prog.plan.k, prog.plan.chunk,
        prog.plan.fields, R,
        ctypes.addressof(out))
    _build.check(rc, "scan_gf2 plan")
    return out.value


class ScanExecutor:
    """Wave executor for one compiled pure-GF(2) circuit in one role, with
    the call contract of the levelized `Executor`.  The slots are allocated
    once per circuit and width and the packed table goes to the device
    once, here; each call is one `wave_run` (one kernel launch on CUDA)."""

    def __init__(self, cc: CompiledCircuit, mode: int, total_reps: int,
                 device: torch.device, wave_width: int = 0):
        self.cc = cc
        self.mode = mode
        self.R = total_reps
        self.device = device
        self.waves = waves(cc, wave_width)
        self.program = circuit_program(cc, mode, device, total_reps, wave_width)

    @property
    def table(self) -> torch.Tensor:
        """The slot-allocated table (wave_table layout) of the plain version."""
        return self.program.table

    def __call__(self, inp: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        cc, R, mode = self.cc, self.R, self.mode
        tape = inp["tape"]
        if tape.shape[1] != R:
            raise ValueError(f"ScanExecutor: the tape has {tape.shape[1]} lanes, not {R}")
        xin = inp.get("wit2") if mode == PROVER else inp.get("in2") if mode == VERIFY_ONL else None
        onl2, pre2, fail = wave_run(
            self.program, mode, tape, xin,
            inp.get("co2") if mode == VERIFY_ONL else None,
            inp.get("re2") if mode == VERIFY_ONL else None,
            cc.onl2, cc.pre2)
        empty = torch.zeros((1, R), dtype=torch.uint8, device=tape.device)
        return {"onl2": onl2, "pre2": pre2, "onlz": empty, "prez": empty.clone(),
                "fail": fail}
