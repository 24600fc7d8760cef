"""The port's Z_2^64 and B2A prove / verify path (reverie_tpu_torch.TorchKKW
on the CPU, i.e. through the kernels' plain versions) against reverie_tpu:
proof bytes equal to TpuKKW (JAX on the CPU) and to the NumPy golden prover
on shallow circuits, equal to the golden on deep ones (B2A circuits are
~190 levels; tests/test_fuzz_differential.py already ties the golden to
TpuKKW there), the committed golden blob reproduced, and the same verdicts
as TpuKKW.verify on good, tampered and malformed proofs."""

import copy
import os

import numpy as np
import pytest
import torch

from reverie_tpu.backend.tpu_host import TpuKKW
from reverie_tpu.circuit import CombineOp, Gate, Op, load_program
from reverie_tpu.circuit.builders import mixed_b2a_circuit, z64_mul_bench_circuit
from reverie_tpu.proof import prove as golden_prove
from reverie_tpu_torch import TorchKKW
from reverie_tpu_torch.proof import Proof as TProof

from test_fuzz_differential import random_program
from test_torch_prove import MUTATIONS, _flip, as_jax_proof, carry, seeds256
from torch_threads import one_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
BIG = 2**63 - 5  # constants near 2^63: products and sums wrap mod 2^64


def z64_kinds_circuit():
    """Every z64 gate kind over a few levels, live and dead destinations,
    constants near 2^63, and satisfiable asserts (x - x, x * 0)."""
    z = CombineOp.z64
    prog = [z(Gate(Op.INPUT, dst=w)) for w in range(4)]
    prog += [
        z(Gate(Op.RANDOM, dst=4)),
        z(Gate(Op.CONST, dst=5, const=BIG)),
        z(Gate(Op.CONST, dst=6, const=2**64 - 1)),
        z(Gate(Op.ADD, dst=7, src1=0, src2=5)),
        z(Gate(Op.SUB, dst=8, src1=1, src2=4)),
        z(Gate(Op.ADDC, dst=9, src1=2, const=BIG)),
        z(Gate(Op.SUBC, dst=10, src1=3, const=2**64 - 3)),
        z(Gate(Op.MULC, dst=11, src1=7, const=BIG)),
        z(Gate(Op.MULC, dst=12, src1=8, const=0)),
        z(Gate(Op.MUL, dst=13, src1=9, src2=10)),
        z(Gate(Op.MUL, dst=14, src1=11, src2=6)),
        z(Gate(Op.MUL, dst=15, src1=13, src2=14)),
        z(Gate(Op.SUB, dst=16, src1=15, src2=15)),
        z(Gate(Op.ASSERT_ZERO, src1=12)),
        z(Gate(Op.ASSERT_ZERO, src1=16)),
        z(Gate(Op.MUL, dst=17, src1=16, src2=4)),  # dead: never read
        z(Gate(Op.ADD, dst=9, src1=13, src2=12)),  # overwrites a wire
    ]
    return prog, [], [2**64 - 1, BIG, 12345, 2**63]


def mixed_circuit():
    """GF(2) and Z_2^64 gates in one shallow program (no B2A), so both
    domains' openings are non-empty."""
    g, z = CombineOp.gf2, CombineOp.z64
    prog = [g(Gate(Op.INPUT, dst=0)), g(Gate(Op.INPUT, dst=1)),
            z(Gate(Op.INPUT, dst=0)), z(Gate(Op.INPUT, dst=1))]
    prog += [g(Gate(Op.MUL, dst=2, src1=0, src2=1)) for _ in range(12)]
    prog += [z(Gate(Op.MUL, dst=2, src1=0, src2=1)) for _ in range(6)]
    prog += [g(Gate(Op.ADD, dst=3, src1=2, src2=2)), g(Gate(Op.ASSERT_ZERO, src1=3)),
             z(Gate(Op.SUB, dst=3, src1=2, src2=2)), z(Gate(Op.ASSERT_ZERO, src1=3))]
    return prog, [True, False], [7, BIG]


SHALLOW = {
    "z64_kinds": z64_kinds_circuit,
    "z64_mul40": lambda: z64_mul_bench_circuit(40),
    "mixed": mixed_circuit,
}


@pytest.mark.parametrize("name", list(SHALLOW))
def test_shallow_proof_bytes_match_tpu_and_golden(name):
    prog, wit2, witz = SHALLOW[name]()
    s = seeds256(5)
    port = TorchKKW(carry(prog), device=CPU)
    assert port.cc.mz > 0
    proof = port.prove(wit2, witz, seeds=s)
    got = proof.to_bytes()
    assert got == golden_prove(prog, wit2, witz, seeds=s.reshape(32, 8, 16)).to_bytes()
    assert got == TpuKKW(prog).prove(wit2, witz, seeds=s).to_bytes()
    assert port.verify(proof) is True


def test_z64_assert_then_overwrite_matches_tpu():
    """A z64 wire overwritten after its ASSERT_ZERO: as in GF(2)
    (test_torch_prove.py::test_assert_then_overwrite_matches_tpu), the port
    follows TpuKKW, and reverie_tpu's NumPy golden prover emits other recon
    bytes (ROADMAP Queue 3)."""
    prog, wit2, witz = z64_kinds_circuit()
    prog = prog + [CombineOp.z64(Gate(Op.ADD, dst=16, src1=13, src2=12))]
    s = seeds256(5)
    port = TorchKKW(carry(prog), device=CPU)
    proof = port.prove(wit2, witz, seeds=s)
    assert proof.to_bytes() == TpuKKW(prog).prove(wit2, witz, seeds=s).to_bytes()
    assert port.verify(proof) is True


def test_golden_b2a_blob_reproduced():
    """tests/golden/b2a_proof.bin from b2a_seeds.bin, byte for byte."""
    with open(os.path.join(GOLDEN, "b2a_program.bin"), "rb") as f:
        prog = load_program(f.read())
    with open(os.path.join(GOLDEN, "b2a_seeds.bin"), "rb") as f:
        seeds = np.frombuffer(f.read(), dtype=np.uint8).reshape(256, 16)
    with open(os.path.join(GOLDEN, "b2a_proof.bin"), "rb") as f:
        blob = f.read()
    _, wit2, witz = mixed_b2a_circuit()
    port = TorchKKW(carry(prog), device=CPU)
    proof = port.prove(wit2, witz, seeds=seeds)
    assert proof.to_bytes() == blob
    assert port.verify(TProof.from_bytes(blob)) is True


@pytest.mark.parametrize("seed, n_gates",
                         [(11, 60), (23, 60)] + [(s, 90) for s in range(40, 52)])
def test_random_mixed_program_matches_golden(seed, n_gates):
    """tests/test_fuzz_differential.py's random mix of every GF(2), z64 and
    B2A kind (depth > 128), with its seeds: the default tier's and the
    sweep's."""
    prog, wit2, witz = random_program(seed, n_gates)
    seeds = np.random.RandomState(seed + 1).randint(0, 256, (32, 8, 16), dtype=np.uint8)
    port = TorchKKW(carry(prog), device=CPU)
    assert port.cc.depth > 128
    proof = port.prove(wit2, witz, seeds=seeds.reshape(256, 16))
    assert proof.to_bytes() == golden_prove(prog, wit2, witz, seeds=seeds).to_bytes()
    assert port.verify(proof) is True


def test_invalid_z64_witness_raises():
    prog = [CombineOp.z64(Gate(Op.INPUT, dst=0)),
            CombineOp.z64(Gate(Op.ASSERT_ZERO, src1=0))]
    port = TorchKKW(carry(prog), device=CPU)
    with pytest.raises(AssertionError, match="invalid"):
        port.prove([], [5], seeds=seeds256())
    with pytest.raises(AssertionError, match="too short"):
        port.prove([], [], seeds=seeds256())
    # witness values are taken mod 2^64: 2^64 is 0
    assert port.verify(port.prove([], [2**64], seeds=seeds256())) is True


# -- verdicts on malformed proofs of a mixed circuit ---------------------------


def _z_flipped_recons(p):
    o = p.z64.online[0]
    o.recons = _flip(o.recons, 3, 0x10)


def _z_truncated_recons(p):
    o = p.z64.online[2]
    o.recons = o.recons[:5]  # not a whole word


def _z_overlong_recons(p):
    p.z64.online[1].recons += b"\x01\x02\x03"


def _z_flipped_corrs(p):
    o = p.z64.online[4]
    o.corrs = _flip(o.corrs, 7, 0x80)


def _z_flipped_inputs(p):
    o = p.z64.online[6]
    o.inputs = _flip(o.inputs, 0, 0x01)


def _z_omit_changed(p):
    o = p.z64.online[0]
    o.omit = (o.omit + 1) % 8


def _z_online_seed(p):
    p.z64.online[3].seeds = _flip(p.z64.online[3].seeds, 17)


def _z_swapped_openings(p):
    p.z64.online[0], p.z64.online[1] = p.z64.online[1], p.z64.online[0]


def _z_empty_streams(p):
    o = p.z64.online[5]
    o.recons, o.corrs, o.inputs = b"", b"", b""


Z64_MUTATIONS = {f.__name__[3:]: f for f in (
    _z_flipped_recons, _z_truncated_recons, _z_overlong_recons,
    _z_flipped_corrs, _z_flipped_inputs, _z_omit_changed, _z_online_seed,
    _z_swapped_openings, _z_empty_streams,
)}
ALL_MUTATIONS = {**MUTATIONS, **{"z64_" + k: f for k, f in Z64_MUTATIONS.items()}}


@pytest.fixture(scope="module")
def mixed_verifiers():
    prog, wit2, witz = mixed_circuit()
    port = TorchKKW(carry(prog), device=CPU)
    proof = port.prove(wit2, witz, seeds=seeds256(9))
    return port, TpuKKW(prog), proof


@pytest.mark.parametrize("mutation", list(ALL_MUTATIONS))
def test_mixed_verdicts_match_tpu(mixed_verifiers, mutation):
    port, tpu, proof = mixed_verifiers
    bad = copy.deepcopy(proof)
    ALL_MUTATIONS[mutation](bad)
    want = tpu.verify(as_jax_proof(bad))
    got = port.verify(bad)
    assert isinstance(got, bool)
    assert got == bool(want)
    if mutation == "none":
        assert got is True
