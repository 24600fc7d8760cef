"""Wave executor for deep GF(2) circuits (SHA-256: 5,198 levels).

Port of reverie_tpu/backend/tpu_scan.py for pure-GF(2) circuits:
`default_wave_width` (:96), `ScanExecutor` (:120) and the body of its
`lax.scan`, `_scan_trace_fast2` (:247).  The gates are packed into uniform,
NOP-padded waves of W slots (circuit/compile.py `build_waves`); every
operand of a slot is produced in an earlier wave, so the slots of one wave
are independent and the waves run in order.  Where reverie_tpu compiles the
whole scan into one device program per role, the port runs it as one launch
of the CUDA kernel `csrc/scan_gf2.cu` per executor call (`wave_gf2`); on the
CPU the plain version `wave_gf2_ref` applies one wave at a time with torch
ops.  Both take the same packed table (`wave_table`).

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

from typing import Dict, Optional

import numpy as np
import torch

from .. import _build
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
    WaveTable,
    build_waves,
)
from .executor import PROVER, VERIFY_ONL, VERIFY_PRE, _expand, _parity8, stream_bytes

#: kernel launches made by `wave_gf2` (CUDA tensors only)
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
    W = wave_width if wave_width > 0 else default_wave_width(cc)
    if W not in cc.wave_tables:
        cc.wave_tables[W] = build_waves(cc, W)
    return cc.wave_tables[W]


def wave_table(wv: WaveTable, mode: int) -> np.ndarray:
    """The waves as one (n_waves, W, 12) int32 array of slots in SLOT_COLS
    order, the form both `wave_gf2` and `wave_gf2_ref` read.  Raises
    ValueError on a table with z64 slots."""
    if wv.has_z64:
        raise ValueError("the wave executor runs pure GF(2) circuits; this one has "
                         "z64 or B2A gates (they run on the levelized Executor)")
    xin = wv.wit if mode == PROVER else wv.inrec if mode == VERIFY_ONL else np.zeros_like(wv.op)
    cols = {"xin": xin, **{k: getattr(wv, k) for k in SLOT_COLS if k != "xin"}}
    return np.ascontiguousarray(np.stack([cols[k] for k in SLOT_COLS], axis=-1), dtype=np.int32)


def table_bytes(cc: CompiledCircuit) -> int:
    """Bytes of the packed wave table on the device (the default width)."""
    return waves(cc).op.size * len(SLOT_COLS) * 4


def prover_bytes(cc: CompiledCircuit, R: int) -> int:
    """Device bytes a PROVER run at R lanes holds at its peak, the wave
    table apart (table_bytes): the inputs tape (m2, R) and wit2 (n_wit2, R)
    uint8 (tapez and witz have no rows); the kernel's arena, (n_vals2, R)
    int16 (mask | corr << 8); the four streams (executor.stream_bytes) and
    fail (R,)."""
    return (cc.m2 + cc.n_wit2 + 2 * cc.n_vals2) * R + stream_bytes(cc, R) + R


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
        raise ValueError(f"wave_gf2: {name} must be a contiguous uint8 (rows, {R}) "
                         f"tensor on {device}")


def wave_gf2(table: torch.Tensor, mode: int, tape: torch.Tensor,
             xin: Optional[torch.Tensor], co2: Optional[torch.Tensor],
             re2: Optional[torch.Tensor], n_vals: int, n_onl: int, n_pre: int):
    """The waves of `table` over R = tape.shape[1] lanes -> (onl2
    (max(n_onl, 1), R) uint8, pre2 (max(n_pre, 1), R) uint8, fail (R,)
    bool).  CPU tensors take the plain version; CUDA tensors launch
    csrc/scan_gf2.cu once, for every wave, with an (n_vals, R) int16 arena
    of its own."""
    global LAUNCHES
    dev = tape.device
    if dev.type == "cpu":
        return wave_gf2_ref(table, mode, tape, xin, co2, re2, n_vals, n_onl, n_pre)
    if dev.type != "cuda":
        raise ValueError(f"wave_gf2: unsupported device {dev}")
    if mode not in (PROVER, VERIFY_ONL, VERIFY_PRE):
        raise ValueError(f"wave_gf2: bad mode {mode}")
    if (table.device != dev or table.dtype != torch.int32 or table.dim() != 3
            or table.shape[2] != len(SLOT_COLS) or not table.is_contiguous()):
        raise ValueError(f"wave_gf2: table must be a contiguous int32 "
                         f"(n_waves, W, {len(SLOT_COLS)}) tensor on {dev}")
    R = tape.shape[1]
    for name, t in (("tape", tape), ("xin", xin), ("co2", co2), ("re2", re2)):
        _check_rows(name, t, R, dev)
    if n_vals < 1:
        raise ValueError("wave_gf2: n_vals must be at least 1 (value 0 is the zero)")
    u8 = dict(dtype=torch.uint8, device=dev)
    onl = torch.zeros((max(n_onl, 1), R), **u8)
    pre = torch.zeros((max(n_pre, 1), R), **u8)
    fail = torch.zeros((R,), dtype=torch.bool, device=dev)
    if R == 0:
        return onl, pre, fail
    arena = torch.empty((n_vals, R), dtype=torch.int16, device=dev)
    lib = _build.kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()

    n_waves, W = table.shape[0], table.shape[1]
    rc = lib.reverie_scan_gf2(table.data_ptr(), n_waves, W, mode, R, tape.data_ptr(),
                              ptr(xin), ptr(co2), ptr(re2), arena.data_ptr(),
                              onl.data_ptr(), pre.data_ptr(), fail.data_ptr(), stream)
    _build.check(rc, "scan_gf2 kernel")
    LAUNCHES += 1
    return onl, pre, fail


class ScanExecutor:
    """Wave executor for one compiled pure-GF(2) circuit in one role, with
    the call contract of the levelized `Executor`.  The packed wave table
    goes to the device once, here; each call is one `wave_gf2` (one kernel
    launch on CUDA)."""

    def __init__(self, cc: CompiledCircuit, mode: int, total_reps: int,
                 device: torch.device, wave_width: int = 0):
        self.cc = cc
        self.mode = mode
        self.R = total_reps
        self.device = device
        self.waves = waves(cc, wave_width)
        self.table = torch.from_numpy(wave_table(self.waves, mode)).to(device)

    def __call__(self, inp: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        cc, R, mode = self.cc, self.R, self.mode
        tape = inp["tape"]
        if tape.shape[1] != R:
            raise ValueError(f"ScanExecutor: the tape has {tape.shape[1]} lanes, not {R}")
        xin = inp.get("wit2") if mode == PROVER else inp.get("in2") if mode == VERIFY_ONL else None
        onl2, pre2, fail = wave_gf2(
            self.table, mode, tape, xin,
            inp.get("co2") if mode == VERIFY_ONL else None,
            inp.get("re2") if mode == VERIFY_ONL else None,
            cc.n_vals2, cc.onl2, cc.pre2)
        empty = torch.zeros((1, R), dtype=torch.uint8, device=tape.device)
        return {"onl2": onl2, "pre2": pre2, "onlz": empty, "prez": empty.clone(),
                "fail": fail}
