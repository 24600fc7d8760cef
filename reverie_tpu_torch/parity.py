"""Committed digests of reverie_tpu's NumPy golden proofs, so that the card
can hold the port's proof bytes to the golden prover without running it.

Each case is a builder (a function of `circuit.builders`, or `sha256_bench`
here), its arguments, and the seeds
`np.random.RandomState(seed).randint(0, 256, (256, 16), dtype=np.uint8)`;
`length` and `sha256` are those of `reverie_tpu.proof.prove(prog, wit_gf2,
wit_z64, seeds=seeds.reshape(32, 8, 16)).to_bytes()`.  The tier-1 test
`tests/test_torch_selfcontained.py` recomputes every entry from the golden
prover on the CPU.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple, Tuple

import numpy as np

from .circuit import builders
from .circuit.sha256 import block_to_witness_bits, sha256_pad_one_block, sha256_preimage_statement

#: the message of reverie_tpu's SHA-256 benchmark statement
SHA256_MESSAGE = b"reverie-tpu bench"


def sha256_bench():
    """(program, wit_gf2, wit_z64) of reverie_tpu's SHA-256 benchmark
    statement (bench.py `_sha256_batch_bench`, BASELINE configs 2 and 5):
    knowledge of a one-block message, SHA256_MESSAGE, whose SHA-256 digest
    the program asserts."""
    prog, _ = sha256_preimage_statement(hashlib.sha256(SHA256_MESSAGE).digest())
    return prog, block_to_witness_bits(sha256_pad_one_block(SHA256_MESSAGE)), []


class ParityCase(NamedTuple):
    builder: str  # a function of circuit.builders, or "sha256_bench"
    args: Tuple[int, ...]  # its arguments
    seed: int  # RandomState seed of the (256, 16) rep seeds
    length: int  # golden proof bytes
    sha256: str  # hex digest of the golden proof bytes


CASES = {
    "gf2_50k": ParityCase("mul_bench_circuit", (50_000,), 50_000, 533_160,
                          "b5d20861ec9232cc691a18ee2ee8a23b620f96315e653880e385876880217b7e"),
    "z64_2k": ParityCase("z64_mul_bench_circuit", (2_000,), 2_000, 1_313_800,
                         "e1329b4cb57ffc38f964eb6a809a62640e74d8f5c03873838593956c922295ea"),
    "sha256_1block": ParityCase("sha256_bench", (), 3, 260_840,
                                "1e69ab72cd08180ad60d4e843e5290a0475facaa7e73dfc950edd5f9e1f7e87d"),
}


def inputs(case: ParityCase):
    """(program, wit_gf2, wit_z64, seeds (256, 16) uint8) of a case."""
    make = sha256_bench if case.builder == "sha256_bench" else getattr(builders, case.builder)
    prog, w2, wz = make(*case.args)
    seeds = np.random.RandomState(case.seed).randint(0, 256, (256, 16), dtype=np.uint8)
    return prog, w2, wz, seeds


def matches(case: ParityCase, proof_bytes: bytes) -> bool:
    return (len(proof_bytes) == case.length
            and hashlib.sha256(proof_bytes).hexdigest() == case.sha256)
