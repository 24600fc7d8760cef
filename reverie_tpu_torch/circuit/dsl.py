"""A small bit-vector circuit-builder DSL over the GF(2) gate set (the
port's copy of reverie_tpu/circuit/dsl.py).

Produces `CombineOp` programs (Input/Add=XOR/Mul=AND/AddConst/AssertZero).
Tracks constant wires and folds them so that e.g. adders with constant
operands emit no unnecessary AND gates -- keeping generated circuits close to
hand-optimized Bristol circuits.  Used to generate the SHA-256 benchmark
statement (the reference consumes pre-built Bristol files via mcircuit; we
generate circuits natively).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

from .ir import CombineOp, Gate, Op

Bit = Union[int, "Wire"]  # int 0/1 = compile-time constant


class Wire:
    __slots__ = ("idx",)

    def __init__(self, idx: int):
        self.idx = idx


class Builder:
    def __init__(self) -> None:
        self.ops: List[CombineOp] = []
        self.next_wire = 0
        self.n_inputs = 0

    # -- wire management ----------------------------------------------------
    def _fresh(self) -> int:
        w = self.next_wire
        self.next_wire += 1
        return w

    def input(self) -> Wire:
        w = self._fresh()
        self.ops.append(CombineOp.gf2(Gate(Op.INPUT, dst=w)))
        self.n_inputs += 1
        return Wire(w)

    def inputs(self, n: int) -> List[Bit]:
        return [self.input() for _ in range(n)]

    # -- gates with constant folding ----------------------------------------
    def xor(self, a: Bit, b: Bit) -> Bit:
        if isinstance(a, int) and isinstance(b, int):
            return (a ^ b) & 1
        if isinstance(a, int):
            a, b = b, a
        if isinstance(b, int):
            if b & 1 == 0:
                return a
            w = self._fresh()
            self.ops.append(CombineOp.gf2(Gate(Op.ADDC, dst=w, src1=a.idx, const=1)))
            return Wire(w)
        w = self._fresh()
        self.ops.append(CombineOp.gf2(Gate(Op.ADD, dst=w, src1=a.idx, src2=b.idx)))
        return Wire(w)

    def and_(self, a: Bit, b: Bit) -> Bit:
        if isinstance(a, int) and isinstance(b, int):
            return a & b & 1
        if isinstance(a, int):
            a, b = b, a
        if isinstance(b, int):
            return a if (b & 1) else 0
        w = self._fresh()
        self.ops.append(CombineOp.gf2(Gate(Op.MUL, dst=w, src1=a.idx, src2=b.idx)))
        return Wire(w)

    def not_(self, a: Bit) -> Bit:
        return self.xor(a, 1)

    def or_(self, a: Bit, b: Bit) -> Bit:
        # a|b = (a^b) ^ (a&b)
        return self.xor(self.xor(a, b), self.and_(a, b))

    def mux(self, sel: Bit, t: Bit, f: Bit) -> Bit:
        # sel ? t : f = f ^ sel&(t^f)
        return self.xor(f, self.and_(sel, self.xor(t, f)))

    def assert_zero(self, a: Bit) -> None:
        if isinstance(a, int):
            if a & 1:
                raise ValueError("asserting constant one")
            return
        self.ops.append(CombineOp.gf2(Gate(Op.ASSERT_ZERO, src1=a.idx)))

    def assert_equal(self, a: Bit, b: Bit) -> None:
        self.assert_zero(self.xor(a, b))

    # -- bit-vector helpers (LSB-first lists) --------------------------------
    def const_vec(self, value: int, n: int) -> List[Bit]:
        return [(value >> i) & 1 for i in range(n)]

    def input_vec(self, n: int) -> List[Bit]:
        return [self.input() for _ in range(n)]

    def xor_vec(self, a: Sequence[Bit], b: Sequence[Bit]) -> List[Bit]:
        return [self.xor(x, y) for x, y in zip(a, b)]

    def and_vec(self, a: Sequence[Bit], b: Sequence[Bit]) -> List[Bit]:
        return [self.and_(x, y) for x, y in zip(a, b)]

    def not_vec(self, a: Sequence[Bit]) -> List[Bit]:
        return [self.not_(x) for x in a]

    def rotr_vec(self, a: Sequence[Bit], n: int) -> List[Bit]:
        k = len(a)
        n %= k
        return [a[(i + n) % k] for i in range(k)]

    def shr_vec(self, a: Sequence[Bit], n: int) -> List[Bit]:
        k = len(a)
        return [a[i + n] if i + n < k else 0 for i in range(k)]

    def add_vec(self, a: Sequence[Bit], b: Sequence[Bit]) -> List[Bit]:
        """Ripple-carry addition mod 2^n (constant-folded where possible)."""
        k = len(a)
        out: List[Bit] = []
        carry: Bit = 0
        for i in range(k):
            axb = self.xor(a[i], b[i])
            out.append(self.xor(axb, carry))
            if i + 1 < k:
                # carry' = ((a^c) & (b^c)) ^ c -- one AND per bit (the same
                # full-adder identity the reference uses, combine.rs:64-77)
                ac = self.xor(a[i], carry)
                bc = self.xor(b[i], carry)
                carry = self.xor(self.and_(ac, bc), carry)
        return out

    def program(self) -> List[CombineOp]:
        return list(self.ops)
