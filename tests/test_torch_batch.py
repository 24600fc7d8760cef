"""The port's batch and pipeline entry points (TorchKKW.prove_batch,
prove_batch_chunked, prove_many, verify_many) on the CPU: proofs byte-equal
to TpuKKW.prove_batch (JAX on the CPU) and to the port's own prove() per
seed, verdicts equal to verify(); the REVERIE_DEBUG omitted-lane checks of
the online verifier.

Every batch holds distinct witnesses and seeds per proof, so that a lane
order other than proof-major (lane p * 256 + r is rep r of proof p) shows
as different bytes."""

import copy

import numpy as np
import pytest
import torch

from reverie_tpu.backend.tpu_host import TpuKKW
from reverie_tpu.circuit import CombineOp, Gate, Op, dumps_program
from reverie_tpu.circuit.builders import (
    mixed_b2a_circuit,
    mul_bench_circuit,
    z64_mul_bench_circuit,
)
from reverie_tpu_torch import TorchKKW
from reverie_tpu_torch.backend import host
from reverie_tpu_torch.circuit import load_program
from reverie_tpu_torch.proof import Proof as TProof
from torch_threads import one_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")


def carry(prog):
    """A reverie_tpu program as the port's own, through bincode bytes."""
    return load_program(dumps_program(prog))


def batch_seeds(n, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, 256, 16), dtype=np.uint8)


def distinct_witnesses(wit2, witz, n, seed):
    """n witnesses of the shapes of (wit2, witz), random bits and words (the
    circuits below assert nothing, so every witness is valid)."""
    rng = np.random.RandomState(seed)
    return [([bool(b) for b in rng.randint(0, 2, len(wit2))],
             [int(v) for v in rng.randint(0, 2**63, len(witz), dtype=np.int64)])
            for _ in range(n)]


def deep_circuit(depth=140):
    """GF(2) only, deeper than the 128 levels past which reverie_tpu takes
    its scan executor; the port runs it levelized."""
    prog = [CombineOp.gf2(Gate(Op.INPUT, dst=0)), CombineOp.gf2(Gate(Op.INPUT, dst=1)),
            CombineOp.gf2(Gate(Op.MUL, dst=2, src1=0, src2=1))]
    prog += [CombineOp.gf2(Gate(Op.ADDC, dst=2, src1=2, const=1)) for _ in range(depth)]
    return prog, [True, True], []


CIRCUITS = {
    "mul8": lambda: mul_bench_circuit(8),
    "mixed_b2a": mixed_b2a_circuit,
    "z64_mul4": lambda: z64_mul_bench_circuit(4),
    "deep140": deep_circuit,
}


def setup(name, n, seed):
    prog, wit2, witz = CIRCUITS[name]()
    return (prog, TorchKKW(carry(prog), device=CPU),
            distinct_witnesses(wit2, witz, n, seed), batch_seeds(n, seed))


@pytest.mark.parametrize("name, n", [("mul8", 3), ("mixed_b2a", 2)])
def test_prove_batch_matches_tpu_and_prove(name, n):
    prog, port, wits, seeds = setup(name, n, 9)
    got = [p.to_bytes() for p in port.prove_batch(wits, seeds)]
    assert len(set(got)) == n
    assert got == [p.to_bytes() for p in TpuKKW(prog).prove_batch(wits, seeds=seeds)]
    for i, (w2, wz) in enumerate(wits):
        assert got[i] == port.prove(w2, wz, seeds=seeds[i]).to_bytes(), i


@pytest.mark.parametrize("name, n", [("z64_mul4", 3), ("deep140", 2)])
def test_prove_batch_matches_prove(name, n):
    _, port, wits, seeds = setup(name, n, 10)
    batch = port.prove_batch(wits, seeds)
    assert port.cc.depth > 128 or port.cc.mz > 0
    for i, (w2, wz) in enumerate(wits):
        assert batch[i].to_bytes() == port.prove(w2, wz, seeds=seeds[i]).to_bytes(), i
    assert port.verify_many(batch) == [True] * n


def test_prove_batch_chunked_ragged_matches_batch():
    _, port, wits, seeds = setup("mul8", 5, 17)
    chunked = port.prove_batch_chunked(wits, seeds, chunk=2)
    # three chunks, the last one ragged: a row per phase and chunk
    assert {"hash[0]", "hash[1]", "hash[2]", "extract_pull[2]"} <= set(port.last_timings)
    assert "hash[3]" not in port.last_timings
    assert [p.to_bytes() for p in chunked] == [
        p.to_bytes() for p in port.prove_batch(wits, seeds)]


@pytest.mark.parametrize("name", ["mul8", "mixed_b2a"])
def test_prove_many_matches_prove(name):
    _, port, wits, seeds = setup(name, 3, 11)
    proofs = port.prove_many(wits, seeds)
    assert set(port.last_timings) >= {"tape_gf2[0]", "challenge[1]", "extract_pull[2]"}
    for i, (w2, wz) in enumerate(wits):
        assert proofs[i].to_bytes() == port.prove(w2, wz, seeds=seeds[i]).to_bytes(), i
    assert set(port.last_timings) >= {"tape_gf2", "hash", "challenge", "extract_pull"}


def _flip(b: bytes, i: int, x: int) -> bytes:
    return b[:i] + bytes([b[i] ^ x]) + b[i + 1 :]


@pytest.fixture(scope="module")
def stream():
    """Good, tampered (a flipped online recon byte, a flipped comm_online
    byte), malformed (byte 40 of the proof's bytes, the first online omit,
    flipped) and truncated-format (one online opening too few) proofs."""
    _, port, wits, seeds = setup("mixed_b2a", 2, 21)
    good = port.prove_batch(wits, seeds)
    recon = copy.deepcopy(good[0])
    recon.gf2.online[0].recons = _flip(recon.gf2.online[0].recons, 0, 1)
    comm = copy.deepcopy(good[1])
    comm.z64.preprocessing[3].comm_online = _flip(comm.z64.preprocessing[3].comm_online, 0, 1)
    omit = TProof.from_bytes(_flip(good[0].to_bytes(), 40, 0xFF))
    short = copy.deepcopy(good[1])
    short.z64.online.pop()
    return port, [good[0], recon, omit, good[1], short, comm]


@pytest.mark.parametrize("strict", [True, False])
def test_verify_many_matches_verify(stream, strict):
    port, proofs = stream
    want = [port.verify(p, strict_zero_check=strict) for p in proofs]
    assert want == [True, False, False, True, False, False]
    assert port.verify_many(proofs, strict_zero_check=strict) == want
    # the malformed proofs give False in place and no phase rows
    assert "onl_tape[0]" in port.last_timings and "onl_tape[2]" not in port.last_timings


def test_invalid_witness_names_its_proof():
    prog = [CombineOp.gf2(Gate(Op.INPUT, dst=0)), CombineOp.gf2(Gate(Op.ASSERT_ZERO, src1=0))]
    port = TorchKKW(carry(prog), device=CPU)
    wits = [([False], []), ([True], []), ([False], [])]
    seeds = batch_seeds(3, 4)
    for call in (lambda: port.prove_batch(wits, seeds),
                 lambda: port.prove_many(wits, seeds),
                 lambda: port.prove_batch_chunked(wits, seeds, chunk=2)):
        with pytest.raises(AssertionError, match="witness 1 is invalid"):
            call()
    with pytest.raises(AssertionError, match="witness 2 is too short"):
        port.prove_batch(wits[:2] + [([], [])], seeds)


@pytest.mark.parametrize("method", ["prove_batch", "prove_batch_chunked", "prove_many",
                                    "verify_many"])
def test_empty_input_gives_no_proofs(method):
    port = TorchKKW(carry(mul_bench_circuit(4)[0]), device=CPU)
    assert getattr(port, method)([]) == []
    assert port.last_timings == {}


def test_prove_batch_chunked_rejects_chunk_0():
    port = TorchKKW(carry(mul_bench_circuit(4)[0]), device=CPU)
    with pytest.raises(ValueError, match="chunk"):
        port.prove_batch_chunked([], chunk=0)


# -- REVERIE_DEBUG: the online verifier's omitted lanes -----------------------


@pytest.fixture(scope="module")
def debug_case():
    _, port, wits, seeds = setup("mixed_b2a", 1, 5)
    return port, port.prove_batch(wits, seeds)[0]


def _unmasked(tape_fn):
    """A tape method that ignores the omit: the omitted player's lanes hold
    keystream."""
    def method(self, player_keys, omit=None, device=None):
        return tape_fn(self, player_keys, device=device)
    return method


@pytest.mark.parametrize("domain", ["gf2", "z64"])
def test_debug_omitted_lane_check_raises(debug_case, monkeypatch, domain):
    port, proof = debug_case
    monkeypatch.setenv("REVERIE_DEBUG", "1")
    name = "_gf2_tape" if domain == "gf2" else "_z64_tape"
    monkeypatch.setattr(TorchKKW, name, _unmasked(getattr(TorchKKW, name)))
    with pytest.raises(AssertionError, match=f"REVERIE_DEBUG: {domain} tape is nonzero"):
        port.verify(proof)
    with pytest.raises(AssertionError, match="REVERIE_DEBUG"):
        port.verify_many([proof])


def test_debug_checks_pass_a_good_proof(debug_case, monkeypatch):
    port, proof = debug_case
    monkeypatch.setenv("REVERIE_DEBUG", "1")
    calls = []
    check = host._check_omitted_lanes
    monkeypatch.setattr(host, "_check_omitted_lanes", lambda *a: calls.append(1) or check(*a))
    assert port.verify(proof) is True
    assert port.verify_many([proof, proof]) == [True, True]
    assert len(calls) == 3
    monkeypatch.delenv("REVERIE_DEBUG")
    assert port.verify(proof) is True and len(calls) == 3
