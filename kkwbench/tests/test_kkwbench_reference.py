"""The plain reference proves what the port proves: byte-equal proofs at
small sizes on the CPU, which the port then accepts, and the committed
digests of reverie_tpu's golden proofs."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest

from kkwbench.program import from_rows
from kkwbench.reference import aes, kkw
from kkwbench.statements import mul_bench, sha256_preimage


def test_aes_fips197():
    key = np.frombuffer(bytes.fromhex("000102030405060708090a0b0c0d0e0f"), dtype=np.uint8)
    import torch

    rk = torch.from_numpy(aes.key_schedule(key[None]))
    block = torch.from_numpy(np.frombuffer(bytes.fromhex("00112233445566778899aabbccddeeff"),
                                           dtype=np.uint8).copy())[None, None]
    out = aes._encrypt(block, rk, torch.from_numpy(aes.SBOX)).numpy().tobytes()
    assert out.hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"


def test_blake3_against_the_port():
    import torch

    from kkwbench.reference import blake3
    from reverie_tpu_torch.crypto.hashing import blake3 as port_blake3, blake3_xof

    for n in (0, 1, 64, 65, 1023, 1024, 1025, 2048, 3073, 8192):
        data = bytes(i % 251 for i in range(n))  # the official test vectors' input
        want = port_blake3(data)
        assert blake3.hash_bytes(data) == want
        rows = torch.tensor(list(data) + [0], dtype=torch.uint8).expand(3, -1).contiguous()
        assert all(r.numpy().tobytes() == want for r in blake3.hash_rows(rows, n))
    assert blake3.xof(b"abc", 300) == blake3_xof(b"abc", 300)
    assert blake3.hash_bytes(b"").hex() == (
        "af1349b9f5f9a1a6a0404dea36dcc9499bcb25c9adc112b7cc9a93cae41f3262")


def _port_proofs(prog_rows, witnesses, seeds):
    from reverie_tpu_torch import TorchKKW
    from reverie_tpu_torch.circuit.bincode import load_program_arrays

    from kkwbench.program import to_bincode

    kkw_port = TorchKKW(load_program_arrays(to_bincode(prog_rows)), device="cpu")
    proofs = kkw_port.prove_many([(w, []) for w in witnesses], seeds)
    return kkw_port, proofs


@pytest.mark.parametrize("which", ["mul_bench_64", "sha256_preimage"])
def test_reference_equals_port(which):
    rng = np.random.default_rng([2**31 + 5, 0])
    if which == "mul_bench_64":
        st = mul_bench.make({"n_mul": 64}, rng)
        n = 3
    else:
        st = sha256_preimage.make({"key_bytes": 32}, rng)
        n = 1
    wit = st.witnesses(rng, n)
    seeds = rng.integers(0, 256, (n, 256, 16), dtype=np.uint8)
    port, proofs = _port_proofs(st.program, wit, seeds)
    got = kkw.prove(st.program, wit, seeds, "cpu")
    assert got == [p.to_bytes() for p in proofs]
    from reverie_tpu_torch.proof.container import Proof

    assert port.verify_many([Proof.from_bytes(b) for b in got]) == [True] * n


def test_reference_equals_golden_digest():
    """reverie_tpu's golden SHA-256 proof (parity.CASES, the JAX package's
    NumPy prover, committed as a digest)."""
    from reverie_tpu_torch import parity
    from kkwbench.statements.sha256_preimage import statement_rows

    case = parity.CASES["sha256_1block"]
    _, w2, _, seeds = parity.inputs(case)
    prog = from_rows(statement_rows(hashlib.sha256(parity.SHA256_MESSAGE).digest()))
    proof = kkw.prove(prog, np.array([w2], dtype=np.uint8), seeds[None], "cpu")[0]
    assert parity.matches(case, proof)


def test_control_breaks_the_proof():
    rng = np.random.default_rng(3)
    st = mul_bench.make({"n_mul": 8}, rng)
    wit, seeds = st.witnesses(rng, 1), rng.integers(0, 256, (1, 256, 16), dtype=np.uint8)
    assert kkw.prove(st.program, wit, seeds, "cpu", 256, 39) != kkw.prove(st.program, wit, seeds, "cpu")
