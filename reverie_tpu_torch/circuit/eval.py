"""Cleartext evaluation of composite programs; the port's copy of
reverie_tpu/circuit/eval.py.

Replacement for `mcircuit::evaluate_composite_program` (used by the reference
CLI `oneshot` mode, main.rs:129) plus a variant that records AssertZero
results instead of raising -- used for witness validation and as the truth
oracle for gate-semantics unit tests (reference src/interpreter/single.rs
tests compare MPC wire values against cleartext evaluation).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .ir import CombineOp, Gate, Kind, Op, largest_wires

_U64 = np.uint64


def evaluate_composite_program(
    program: Sequence[CombineOp],
    bool_witness: Sequence[bool],
    arith_witness: Sequence[int],
    check_assertions: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Evaluate `program` in cleartext.

    Returns (z64_wires, gf2_wires) final wire arenas.  Raises AssertionError
    on a failed AssertZero when `check_assertions` (mirrors the reference
    prover's abort-on-invalid-witness, transcript/prover.rs:221-228).
    """
    z64_count, gf2_count = largest_wires(program)
    gf2 = np.zeros(gf2_count, dtype=np.uint8)
    z64 = np.zeros(z64_count, dtype=_U64)
    bool_it = iter(bool_witness)
    arith_it = iter(arith_witness)

    for op in program:
        if op.kind == Kind.GF2:
            _step_gf2(gf2, op.gate, bool_it, check_assertions)
        elif op.kind == Kind.Z64:
            _step_z64(z64, op.gate, arith_it, check_assertions)
        elif op.kind == Kind.B2A:
            # bool->arith: compose 64 bits little-endian from gf2 wires
            # (reference combine.rs:132-219; bit i of the value is wire src+i)
            val = _U64(0)
            for i in range(64):
                val |= _U64(int(gf2[op.b + i]) & 1) << _U64(i)
            z64[op.a] = val
        # SizeHint: arena already sized by largest_wires
    return z64, gf2


def _step_gf2(w: np.ndarray, g: Gate, wit, check: bool) -> None:
    op = g.op
    if op == Op.INPUT:
        w[g.dst] = 1 if next(wit) else 0
    elif op == Op.ADD:
        w[g.dst] = w[g.src1] ^ w[g.src2]
    elif op == Op.SUB:
        w[g.dst] = w[g.src1] ^ w[g.src2]
    elif op == Op.MUL:
        w[g.dst] = w[g.src1] & w[g.src2]
    elif op == Op.ADDC:
        w[g.dst] = w[g.src1] ^ (g.const & 1)
    elif op == Op.SUBC:
        w[g.dst] = w[g.src1] ^ (g.const & 1)
    elif op == Op.MULC:
        w[g.dst] = w[g.src1] & (g.const & 1)
    elif op == Op.ASSERT_ZERO:
        if check and w[g.src1] != 0:
            raise AssertionError(f"AssertZero failed on gf2 wire {g.src1}")
    elif op == Op.RANDOM:
        w[g.dst] = 0  # cleartext eval has no randomness; mirrors Random->mask-only
    elif op == Op.CONST:
        w[g.dst] = g.const & 1
    else:
        raise ValueError(f"unknown gf2 op {op}")


def _step_z64(w: np.ndarray, g: Gate, wit, check: bool) -> None:
    op = g.op
    if op == Op.INPUT:
        w[g.dst] = _U64(next(wit))
    elif op == Op.ADD:
        w[g.dst] = w[g.src1] + w[g.src2]
    elif op == Op.SUB:
        w[g.dst] = w[g.src1] - w[g.src2]
    elif op == Op.MUL:
        w[g.dst] = w[g.src1] * w[g.src2]
    elif op == Op.ADDC:
        w[g.dst] = w[g.src1] + _U64(g.const)
    elif op == Op.SUBC:
        w[g.dst] = w[g.src1] - _U64(g.const)
    elif op == Op.MULC:
        w[g.dst] = w[g.src1] * _U64(g.const)
    elif op == Op.ASSERT_ZERO:
        if check and w[g.src1] != 0:
            raise AssertionError(f"AssertZero failed on z64 wire {g.src1}")
    elif op == Op.RANDOM:
        w[g.dst] = 0
    elif op == Op.CONST:
        w[g.dst] = _U64(g.const)
    else:
        raise ValueError(f"unknown z64 op {op}")
