"""Committed digests of reverie_tpu's NumPy golden proofs, so that the card
can hold the port's proof bytes to the golden prover without running it.

Each case is a builder of `circuit.builders`, its size, and the seeds
`np.random.RandomState(seed).randint(0, 256, (256, 16), dtype=np.uint8)`;
`length` and `sha256` are those of `reverie_tpu.proof.prove(prog, wit_gf2,
wit_z64, seeds=seeds.reshape(32, 8, 16)).to_bytes()`.  The tier-1 test
`tests/test_torch_selfcontained.py` recomputes every entry from the golden
prover on the CPU.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import numpy as np

from .circuit import builders


class ParityCase(NamedTuple):
    builder: str  # a function of circuit.builders
    n: int  # its size argument
    seed: int  # RandomState seed of the (256, 16) rep seeds
    length: int  # golden proof bytes
    sha256: str  # hex digest of the golden proof bytes


CASES = {
    "gf2_50k": ParityCase("mul_bench_circuit", 50_000, 50_000, 533_160,
                          "b5d20861ec9232cc691a18ee2ee8a23b620f96315e653880e385876880217b7e"),
    "z64_2k": ParityCase("z64_mul_bench_circuit", 2_000, 2_000, 1_313_800,
                         "e1329b4cb57ffc38f964eb6a809a62640e74d8f5c03873838593956c922295ea"),
}


def inputs(case: ParityCase):
    """(program, wit_gf2, wit_z64, seeds (256, 16) uint8) of a case."""
    prog, w2, wz = getattr(builders, case.builder)(case.n)
    seeds = np.random.RandomState(case.seed).randint(0, 256, (256, 16), dtype=np.uint8)
    return prog, w2, wz, seeds


def matches(case: ParityCase, proof_bytes: bytes) -> bool:
    return (len(proof_bytes) == case.length
            and hashlib.sha256(proof_bytes).hexdigest() == case.sha256)
