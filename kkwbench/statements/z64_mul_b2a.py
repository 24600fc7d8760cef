"""Ring multiplications fed by boolean-to-arithmetic conversions: 128 GF(2)
inputs on wires 0..127, B2A of wires 0..63 to Z_2^64 wire 0 and of 64..127
to wire 1, then `n_mul` Z_2^64 MUL gates, each writing wire 2 from wires 0
and 1.  reverie's Z_2^64 MUL bench (the port's z64_mul_bench_circuit, two
Z_2^64 inputs and n MULs on them) with its two 64-bit inputs given as
witness bits and bridged by B2A, as reverie's mixed round-trip test
circuit (src/proof/mod.rs:397-427) bridges its own."""

from __future__ import annotations

import numpy as np

from kkwbench.program import B2A, GF2, INPUT, MUL, Z64, Program, Statement

N_BITS = 128


def make(args: dict, rng: np.random.Generator) -> Statement:
    n_mul = int(args["n_mul"])
    n = N_BITS + 2 + n_mul
    kind = np.full(n, Z64, dtype=np.uint8)
    kind[:N_BITS] = GF2
    kind[N_BITS:N_BITS + 2] = B2A
    op = np.full(n, MUL, dtype=np.uint8)
    op[:N_BITS] = INPUT
    op[N_BITS:N_BITS + 2] = 0
    dst = np.full(n, 2, dtype=np.int64)
    dst[:N_BITS] = np.arange(N_BITS)
    dst[N_BITS:N_BITS + 2] = (0, 1)  # the Z_2^64 wire a B2A writes
    src1 = np.zeros(n, dtype=np.int64)
    src1[N_BITS:N_BITS + 2] = (0, 64)  # the first of the 64 GF(2) wires it reads
    src2 = np.ones(n, dtype=np.int64)
    src2[:N_BITS + 2] = 0
    prog = Program(kind, op, dst, src1, src2, np.zeros(n, dtype=np.uint64))

    def witnesses(r: np.random.Generator, count: int) -> np.ndarray:
        # any 128 bits satisfy the program: it asserts nothing
        return r.integers(0, 2, (count, N_BITS), dtype=np.uint8)

    return Statement(prog, witnesses)
