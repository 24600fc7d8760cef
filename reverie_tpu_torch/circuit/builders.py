"""Synthetic circuit builders for tests and benchmarks (the port's copy of
reverie_tpu/circuit/builders.py)."""

from __future__ import annotations

import random
from typing import List, Tuple

from .ir import CombineOp, Gate, Op


def mul_bench_circuit(n_mul: int = 100_000) -> Tuple[List[CombineOp], List[bool], List[int]]:
    """The reference prover-bench circuit: 2 inputs + n GF2 Mul gates all on
    the same wires (reference src/proof/mod.rs:322-335)."""
    prog = [
        CombineOp.gf2(Gate(Op.INPUT, dst=0)),
        CombineOp.gf2(Gate(Op.INPUT, dst=1)),
    ]
    prog.extend(CombineOp.gf2(Gate(Op.MUL, dst=2, src1=0, src2=1)) for _ in range(n_mul))
    return prog, [True, True], [0]


def wide_and_circuit(
    n_and: int, width: int = 1024, seed: int = 0
) -> Tuple[List[CombineOp], List[bool], List[int]]:
    """A synthetic Z2 circuit with `n_and` AND gates over `width` live wires.

    Structured like realistic circuits: each AND reads two pseudo-random live
    wires and overwrites a pseudo-random destination.
    """
    rng = random.Random(seed)
    prog: List[CombineOp] = [CombineOp.size_hint(1, width)]
    wit = [bool(rng.getrandbits(1)) for _ in range(width)]
    for w in range(width):
        prog.append(CombineOp.gf2(Gate(Op.INPUT, dst=w)))
    for _ in range(n_and):
        a = rng.randrange(width)
        b = rng.randrange(width)
        d = rng.randrange(width)
        prog.append(CombineOp.gf2(Gate(Op.MUL, dst=d, src1=a, src2=b)))
    return prog, wit, [0]


def z64_mul_bench_circuit(n_mul: int = 10_000) -> Tuple[List[CombineOp], List[bool], List[int]]:
    """Arithmetic ring bench: n Z64 mul gates."""
    prog = [
        CombineOp.z64(Gate(Op.INPUT, dst=0)),
        CombineOp.z64(Gate(Op.INPUT, dst=1)),
    ]
    prog.extend(CombineOp.z64(Gate(Op.MUL, dst=2, src1=0, src2=1)) for _ in range(n_mul))
    return prog, [], [3, 5]


def mixed_b2a_circuit() -> Tuple[List[CombineOp], List[bool], List[int]]:
    """The reference round-trip test circuit (proof/mod.rs:397-427)."""
    prog: List[CombineOp] = []
    for _ in range(2, 66):
        prog.append(CombineOp.gf2(Gate(Op.INPUT, dst=1)))
    prog.append(CombineOp.b2a(0, 2))
    prog.extend(
        [
            CombineOp.gf2(Gate(Op.INPUT, dst=0)),
            CombineOp.gf2(Gate(Op.INPUT, dst=1)),
            CombineOp.gf2(Gate(Op.MUL, dst=2, src1=0, src2=1)),
            CombineOp.gf2(Gate(Op.ADD, dst=3, src1=0, src2=1)),
            CombineOp.gf2(Gate(Op.MUL, dst=2, src1=2, src2=3)),
        ]
    )
    return prog, [True] * 128, [0]
