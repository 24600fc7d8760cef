"""Circuit intermediate representation.

The port's copy of reverie_tpu/circuit/ir.py (the object form: `Op`,
`Kind`, `Gate`, `CombineOp`; and `largest_wires`).  A program is a list of
`CombineOp`s, each either a single-domain gate (GF2 over bits, Z64 over the
2^64 ring), a bool->arith conversion (`B2A`), or a wire-arena `SizeHint`
(reference src/interpreter/combine.rs:120-220 for consumed variants).

Opcode numbering follows the `mcircuit::Operation` enum declaration order so
that bincode program files (enum tag = variant index, u32 LE) round-trip.
These classes are the port's own: a program built with reverie_tpu's
classes crosses over as bincode bytes (`load_program(dumps_program(p))`).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Sequence, Tuple, Union


class Op(enum.IntEnum):
    """Single-domain gate opcodes (mcircuit `Operation<T>` variant order)."""

    INPUT = 0  # Input(dst)
    RANDOM = 1  # Random(dst)
    ADD = 2  # Add(dst, a, b)
    ADDC = 3  # AddConst(dst, src, c)
    SUB = 4  # Sub(dst, a, b)
    SUBC = 5  # SubConst(dst, src, c)
    MUL = 6  # Mul(dst, a, b)
    MULC = 7  # MulConst(dst, src, c)
    ASSERT_ZERO = 8  # AssertZero(src)
    CONST = 9  # Const(dst, c)


# Opcodes with two wire sources.
TWO_SRC_OPS = frozenset({Op.ADD, Op.SUB, Op.MUL})
# Opcodes with one wire source (plus maybe a const).
ONE_SRC_OPS = frozenset({Op.ADDC, Op.SUBC, Op.MULC})


class Kind(enum.IntEnum):
    """`CombineOperation` variant order (mcircuit)."""

    GF2 = 0  # GF2(Operation<bool>)
    Z64 = 1  # Z64(Operation<u64>)
    B2A = 2  # B2A(dst_z64, src_gf2)
    SIZE_HINT = 3  # SizeHint(z64_cells, gf2_cells)


@dataclasses.dataclass(frozen=True)
class Gate:
    """A single-domain gate."""

    op: Op
    dst: int = 0
    src1: int = 0
    src2: int = 0
    const: int = 0  # for GF2 gates: 0/1; for Z64: u64


@dataclasses.dataclass(frozen=True)
class CombineOp:
    """A composite-circuit instruction."""

    kind: Kind
    gate: Union[Gate, None] = None  # for GF2/Z64 kinds
    a: int = 0  # B2A dst_z64 / SizeHint z64_cells
    b: int = 0  # B2A src_gf2 / SizeHint gf2_cells

    @staticmethod
    def gf2(gate: Gate) -> "CombineOp":
        return CombineOp(Kind.GF2, gate=gate)

    @staticmethod
    def z64(gate: Gate) -> "CombineOp":
        return CombineOp(Kind.Z64, gate=gate)

    @staticmethod
    def b2a(dst_z64: int, src_gf2: int) -> "CombineOp":
        return CombineOp(Kind.B2A, a=dst_z64, b=src_gf2)

    @staticmethod
    def size_hint(z64_cells: int, gf2_cells: int) -> "CombineOp":
        return CombineOp(Kind.SIZE_HINT, a=z64_cells, b=gf2_cells)


Program = List[CombineOp]


# ---------------------------------------------------------------------------
# Wire counting (mcircuit `largest_wires`, used at reference main.rs:73,107)
# ---------------------------------------------------------------------------


def largest_wires(program: Sequence[CombineOp]) -> Tuple[int, int]:
    """Return (z64_wire_count, gf2_wire_count): 1 + the largest wire index
    touched in each domain, also honouring SizeHint rows."""
    z64_hi = 0
    gf2_hi = 0
    for op in program:
        if op.kind == Kind.GF2:
            g = op.gate
            hi = _gate_max_wire(g)
            gf2_hi = max(gf2_hi, hi + 1)
        elif op.kind == Kind.Z64:
            g = op.gate
            hi = _gate_max_wire(g)
            z64_hi = max(z64_hi, hi + 1)
        elif op.kind == Kind.B2A:
            z64_hi = max(z64_hi, op.a + 1)
            gf2_hi = max(gf2_hi, op.b + 64)
        elif op.kind == Kind.SIZE_HINT:
            z64_hi = max(z64_hi, op.a)
            gf2_hi = max(gf2_hi, op.b)
    return z64_hi, gf2_hi


def _gate_max_wire(g: Gate) -> int:
    # Convention: AssertZero(src) stores its single operand in `src1`.
    if g.op == Op.ASSERT_ZERO:
        return g.src1
    hi = g.dst
    if g.op in TWO_SRC_OPS:
        hi = max(hi, g.src1, g.src2)
    elif g.op in ONE_SRC_OPS:
        hi = max(hi, g.src1)
    return hi
