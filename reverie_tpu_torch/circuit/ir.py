"""Circuit intermediate representation.

The port's copy of reverie_tpu/circuit/ir.py (the object form: `Op`,
`Kind`, `Gate`, `CombineOp`).  A program is a list of `CombineOp`s, each
either a single-domain gate (GF2 over bits, Z64 over the 2^64 ring), a
bool->arith conversion (`B2A`), or a wire-arena `SizeHint` (reference
src/interpreter/combine.rs:120-220 for consumed variants).

Opcode numbering follows the `mcircuit::Operation` enum declaration order so
that bincode program files (enum tag = variant index, u32 LE) round-trip.
These classes are the port's own: a program built with reverie_tpu's
classes crosses over as bincode bytes (`load_program(dumps_program(p))`).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Union


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
