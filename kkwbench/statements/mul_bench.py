"""trailofbits/reverie's prover and verifier bench circuit
(src/proof/mod.rs:318-395): two GF(2) inputs and `n_mul` MUL gates, every
one on the same two wires and writing the same third (depth 1).  Frozen copy
of reverie_tpu_torch.circuit.builders.mul_bench_circuit's program."""

from __future__ import annotations

import numpy as np

from kkwbench.program import GF2, INPUT, MUL, Program, Statement


def make(args: dict, rng: np.random.Generator) -> Statement:
    n = 2 + int(args["n_mul"])
    op = np.full(n, MUL, dtype=np.uint8)
    op[:2] = INPUT
    dst = np.full(n, 2, dtype=np.int64)
    dst[:2] = (0, 1)
    src1 = np.zeros(n, dtype=np.int64)
    src2 = np.ones(n, dtype=np.int64)
    src2[:2] = 0
    prog = Program(np.full(n, GF2, dtype=np.uint8), op, dst, src1, src2,
                   np.zeros(n, dtype=np.uint64))

    def witnesses(r: np.random.Generator, count: int) -> np.ndarray:
        # any two bits satisfy the program: it asserts nothing
        return r.integers(0, 2, (count, 2), dtype=np.uint8)

    return Statement(prog, witnesses)
