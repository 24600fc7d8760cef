"""Synthetic circuit builders for tests and benchmarks (the port's copy of
reverie_tpu/circuit/builders.py, and the deep z64 and B2A statements of
reverie_tpu's scan-executor tests, tests/test_tpu_backend.py).

Where a program repeats an op, every position holds the one op object:
ops are frozen dataclasses, so the program equals one of fresh objects
(and so do its bincode bytes), while it costs a pointer an op to build
and hold, and the compile meets one object per run of it
(compile_native.distinct_ops)."""

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
    prog.extend([CombineOp.gf2(Gate(Op.MUL, dst=2, src1=0, src2=1))] * n_mul)
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
    prog.extend([CombineOp.z64(Gate(Op.MUL, dst=2, src1=0, src2=1))] * n_mul)
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


def z64_chain_circuit(n_mul: int = 150) -> Tuple[List[CombineOp], List[bool], List[int]]:
    """A serial z64 MUL chain n_mul + 3 levels deep (reverie_tpu's
    tests/test_tpu_backend.py test_scan_executor_deep_z64_circuit): two
    inputs, n_mul MULs each reading the one before, an ADDC, a SUB of it
    from itself and its ASSERT_ZERO."""
    z = CombineOp.z64
    prog = [z(Gate(Op.INPUT, dst=0)), z(Gate(Op.INPUT, dst=1))]
    prog += [z(Gate(Op.MUL, dst=1, src1=0, src2=1))] * n_mul
    prog += [z(Gate(Op.ADDC, dst=2, src1=1, const=5)), z(Gate(Op.SUB, dst=3, src1=2, src2=2)),
             z(Gate(Op.ASSERT_ZERO, src1=3))]
    return prog, [], [3, 5]


def deep_b2a_circuit(chain: int = 200) -> Tuple[List[CombineOp], List[bool], List[int]]:
    """mixed_b2a_circuit without its last op, then `chain` GF(2) MULs each
    reading the one before (tests/test_tpu_backend.py
    _deep_b2a_mixed_circuit): z64, B2A and GF(2) gates in one deep
    circuit."""
    prog, wit2, witz = mixed_b2a_circuit()
    prog = prog[:-1] + [CombineOp.gf2(Gate(Op.MUL, dst=2, src1=2, src2=3))] * chain
    return prog, wit2, witz


def z64_all_ops_circuit(iters: int = 200, seed: int = 5
                        ) -> Tuple[List[CombineOp], List[bool], List[int]]:
    """Every z64 gate kind on a serial accumulator `iters` levels deep, with
    three ops beside it a level and a passing ASSERT_ZERO of x - x
    (tests/test_tpu_backend.py test_scan_executor_z64_all_ops_wide)."""
    rng = random.Random(seed)
    z, width = CombineOp.z64, 6
    prog = [z(Gate(Op.INPUT, dst=w)) for w in range(width)]
    prog += [z(Gate(Op.RANDOM, dst=width)),
             z(Gate(Op.CONST, dst=width + 1, const=0xDEADBEEFCAFEF00D))]
    kinds = [Op.ADD, Op.SUB, Op.ADDC, Op.SUBC, Op.MULC, Op.MUL]
    for i in range(iters):
        k = kinds[i % len(kinds)]
        b2 = rng.randrange(width + 2)
        if k in (Op.ADDC, Op.SUBC, Op.MULC):
            prog.append(z(Gate(k, dst=0, src1=0, const=rng.getrandbits(64))))
        else:
            prog.append(z(Gate(k, dst=0, src1=0, src2=b2)))
        for _ in range(3):
            k2 = kinds[rng.randrange(len(kinds))]
            a, c = rng.randrange(1, width + 2), rng.randrange(1, width + 2)
            d = rng.randrange(1, width)
            if k2 in (Op.ADDC, Op.SUBC, Op.MULC):
                prog.append(z(Gate(k2, dst=d, src1=a, const=rng.getrandbits(64))))
            else:
                prog.append(z(Gate(k2, dst=d, src1=a, src2=c)))
    prog += [z(Gate(Op.SUB, dst=width, src1=0, src2=0)), z(Gate(Op.ASSERT_ZERO, src1=width))]
    return prog, [], [rng.getrandbits(64) for _ in range(width)]


def z64_chains_circuit(chains: int = 64, n_mul: int = 150
                       ) -> Tuple[List[CombineOp], List[bool], List[int]]:
    """`chains` serial z64 MUL chains side by side, n_mul + 3 levels deep:
    z64_chain_circuit's chain in each, so that build_waves packs `chains`
    MULs a wave (at 64, its widest z64 waves, Wz = 64)."""
    z = CombineOp.z64
    prog = [z(Gate(Op.INPUT, dst=w)) for w in range(2 * chains)]
    prog += [z(Gate(Op.MUL, dst=2 * c + 1, src1=2 * c, src2=2 * c + 1))
             for c in range(chains)] * n_mul
    prog += [z(Gate(Op.SUB, dst=2 * chains + c, src1=2 * c + 1, src2=2 * c + 1))
             for c in range(chains)]
    prog += [z(Gate(Op.ASSERT_ZERO, src1=2 * chains + c)) for c in range(chains)]
    return prog, [], [3 + c for c in range(2 * chains)]
