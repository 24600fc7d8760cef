"""The port's GF(2) prove / verify slice (reverie_tpu_torch.TorchKKW on the
CPU, i.e. through the kernels' plain versions) against reverie_tpu: proof
bytes equal to TpuKKW (JAX on the CPU) and to the NumPy golden prover, and
the same verdicts as TpuKKW.verify on good, tampered and malformed proofs.
Programs built with reverie_tpu's classes reach the port as bincode bytes
(`carry`), and proofs cross as `to_bytes()` (`as_jax_proof`)."""

import copy

import numpy as np
import pytest
import torch

from reverie_tpu.backend.tpu_host import TpuKKW
from reverie_tpu.circuit import CombineOp, Gate, Op, dumps_program
from reverie_tpu.circuit.builders import (
    mixed_b2a_circuit,
    mul_bench_circuit,
    wide_and_circuit,
    z64_mul_bench_circuit,
)
from reverie_tpu.proof import Proof
from reverie_tpu.proof import prove as golden_prove
from reverie_tpu.proof import verify as golden_verify
from reverie_tpu_torch import TorchKKW
from reverie_tpu_torch.circuit import load_program
from reverie_tpu_torch.proof import Proof as TProof
from torch_threads import one_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")


def carry(prog):
    """A reverie_tpu program as the port's own, through bincode bytes."""
    return load_program(dumps_program(prog))


def as_jax_proof(proof):
    """A port proof as reverie_tpu's, through its bytes."""
    return Proof.from_bytes(proof.to_bytes())


def seeds256(seed=42):
    return np.random.RandomState(seed).randint(0, 256, size=(256, 16), dtype=np.uint8)


CIRCUITS = {
    "mul20": lambda: mul_bench_circuit(20),
    "wide_and": lambda: wide_and_circuit(80, width=32, seed=7),
}


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_proof_bytes_match_tpu_and_golden(name):
    prog, wit2, witz = CIRCUITS[name]()
    s = seeds256()
    port = TorchKKW(carry(prog), device=CPU)
    proof = port.prove(wit2, witz, seeds=s)
    got = proof.to_bytes()
    assert got == golden_prove(prog, wit2, witz, seeds=s.reshape(32, 8, 16)).to_bytes()
    assert got == TpuKKW(prog).prove(wit2, witz, seeds=s).to_bytes()
    assert port.verify(proof) is True
    assert golden_verify(as_jax_proof(proof), prog)


def random_gf2_program(seed: int, n_gates: int = 60):
    """A random well-formed GF(2) program over every gate kind: every
    source wire is already written, and each ASSERT_ZERO checks x + x on a
    wire that is never written again (see
    test_assert_then_overwrite_matches_tpu)."""
    rng = np.random.RandomState(seed)
    g = CombineOp.gf2
    prog, wit = [], []
    for w in range(3):
        prog.append(g(Gate(Op.INPUT, dst=w)))
        wit.append(bool(rng.randint(2)))
    prog += [g(Gate(Op.CONST, dst=3, const=1)), g(Gate(Op.RANDOM, dst=4))]
    n = 5
    asserted = set()
    for _ in range(n_gates):
        a, b = (int(rng.randint(n)) for _ in range(2))
        op = rng.choice(["add", "sub", "addc", "subc", "mulc", "mul", "assert",
                         "input", "random", "const"])
        dst = int(rng.randint(n + 1))  # overwrite a live wire or add one
        if dst in asserted:
            dst = n
        if op in ("add", "sub", "mul"):
            kind = {"add": Op.ADD, "sub": Op.SUB, "mul": Op.MUL}[op]
            prog.append(g(Gate(kind, dst=dst, src1=a, src2=b)))
        elif op in ("addc", "subc", "mulc"):
            kind = {"addc": Op.ADDC, "subc": Op.SUBC, "mulc": Op.MULC}[op]
            prog.append(g(Gate(kind, dst=dst, src1=a, const=int(rng.randint(2)))))
        elif op == "assert":
            prog.append(g(Gate(Op.ADD, dst=n, src1=a, src2=a)))
            prog.append(g(Gate(Op.ASSERT_ZERO, src1=n)))
            asserted.add(n)
            dst = n
        elif op == "input":
            prog.append(g(Gate(Op.INPUT, dst=dst)))
            wit.append(bool(rng.randint(2)))
        elif op == "random":
            prog.append(g(Gate(Op.RANDOM, dst=dst)))
        else:
            prog.append(g(Gate(Op.CONST, dst=dst, const=int(rng.randint(2)))))
        n = max(n, dst + 1)
    return prog, wit, []


@pytest.mark.parametrize("seed", [3, 17, 29])
def test_random_gf2_program(seed):
    """GF(2)-only counterpart of tests/test_fuzz_differential.py: arbitrary
    interleavings of every GF(2) kind prove byte-identically to the golden
    prover and verify."""
    prog, wit2, witz = random_gf2_program(seed)
    s = seeds256(seed)
    port = TorchKKW(carry(prog), device=CPU)
    proof = port.prove(wit2, witz, seeds=s)
    assert proof.to_bytes() == golden_prove(
        prog, wit2, witz, seeds=s.reshape(32, 8, 16)).to_bytes()
    assert port.verify(proof) is True


def test_assert_then_overwrite_matches_tpu():
    """A wire overwritten after its ASSERT_ZERO: the port follows TpuKKW
    (the recon event carries the asserted value's share).  reverie_tpu's
    NumPy golden prover emits a different recon bit here (ROADMAP Queue 3),
    so this case is held to TpuKKW only."""
    g = CombineOp.gf2
    prog = [
        g(Gate(Op.RANDOM, dst=2)), g(Gate(Op.SUBC, dst=4, src1=2, const=0)),
        g(Gate(Op.INPUT, dst=9)), g(Gate(Op.ADDC, dst=5, src1=4, const=0)),
        g(Gate(Op.RANDOM, dst=1)), g(Gate(Op.ADD, dst=12, src1=5, src2=5)),
        g(Gate(Op.ADD, dst=15, src1=12, src2=12)), g(Gate(Op.ASSERT_ZERO, src1=15)),
        g(Gate(Op.MUL, dst=7, src1=9, src2=1)), g(Gate(Op.ADDC, dst=15, src1=7, const=0)),
    ]
    s = seeds256(3)
    port = TorchKKW(carry(prog), device=CPU)
    proof = port.prove([True], [], seeds=s)
    assert proof.to_bytes() == TpuKKW(prog).prove([True], [], seeds=s).to_bytes()
    assert port.verify(proof) is True


def _flip(b: bytes, i: int = 0, x: int = 1) -> bytes:
    return b[:i] + bytes([b[i] ^ x]) + b[i + 1 :]


def _m_omit_out_of_range(p):
    p.gf2.online[0].omit = 9


def _m_omit_changed(p):
    o = p.gf2.online[0]
    o.omit = (o.omit + 1) % 8


def _m_truncated_recons(p):
    o = p.gf2.online[0]
    o.recons = o.recons[: len(o.recons) // 2]


def _m_flipped_recons(p):
    o = p.gf2.online[0]
    o.recons = _flip(o.recons, 0, 0xFF)


def _m_overlong_uniform(p):
    for o in p.gf2.online:
        o.recons += b"\x00\x00\x00\x00"


def _m_overlong_single(p):
    p.gf2.online[0].recons += b"\xde\xad\xbe\xef"


def _m_empty_streams(p):
    o = p.gf2.online[0]
    o.recons, o.corrs, o.inputs = b"", b"", b""


def _m_flipped_corrs(p):
    o = p.gf2.online[3]
    o.corrs = _flip(o.corrs, 0, 0x80)


def _m_flipped_inputs(p):
    o = p.gf2.online[5]
    o.inputs = _flip(o.inputs, 0, 0x40)


def _m_online_count(p):
    p.gf2.online.pop()


def _m_preprocessing_count(p):
    p.z64.preprocessing.pop()


def _m_z64_seed(p):
    p.z64.preprocessing[0].seed = _flip(p.z64.preprocessing[0].seed)


def _m_comm(p):
    p.comm = _flip(p.comm)


def _m_comm_online(p):
    c = p.gf2.preprocessing[0].comm_online
    p.gf2.preprocessing[0].comm_online = _flip(c, 5, 0x80)


def _m_z64_comm_online(p):
    c = p.z64.preprocessing[7].comm_online
    p.z64.preprocessing[7].comm_online = _flip(c, 0)


def _m_preprocessing_seed(p):
    p.gf2.preprocessing[2].seed = _flip(p.gf2.preprocessing[2].seed)


def _m_online_seed(p):
    p.gf2.online[0].seeds = _flip(p.gf2.online[0].seeds, 3)


def _m_omitted_key_garbage(p):
    for o in (p.gf2.online[0], p.z64.online[0]):
        o.seeds = _flip(o.seeds, o.omit * 16, 0xAB)


def _m_swapped_openings(p):
    p.gf2.online[0], p.gf2.online[1] = p.gf2.online[1], p.gf2.online[0]


def _m_z64_omit(p):
    p.z64.online[0].omit = 8


def _m_gf2_omit_200(p):
    p.gf2.online[0].omit = 200


def _m_none(p):
    pass


MUTATIONS = {f.__name__[3:]: f for f in (
    _m_none, _m_omit_out_of_range, _m_omit_changed, _m_truncated_recons,
    _m_flipped_recons, _m_overlong_uniform, _m_overlong_single,
    _m_empty_streams, _m_flipped_corrs, _m_flipped_inputs, _m_online_count,
    _m_preprocessing_count, _m_z64_seed, _m_comm, _m_comm_online,
    _m_z64_comm_online, _m_preprocessing_seed, _m_online_seed,
    _m_omitted_key_garbage, _m_swapped_openings, _m_z64_omit, _m_gf2_omit_200,
)}


@pytest.fixture(scope="module")
def verifiers():
    prog, wit2, witz = mul_bench_circuit(20)
    port = TorchKKW(carry(prog), device=CPU)
    proof = port.prove(wit2, witz, seeds=seeds256(7))
    return port, TpuKKW(prog), proof


@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_verdicts_match_tpu(verifiers, mutation):
    port, tpu, proof = verifiers
    bad = copy.deepcopy(proof)
    MUTATIONS[mutation](bad)
    want = tpu.verify(as_jax_proof(bad))
    got = port.verify(bad)
    assert isinstance(got, bool)
    assert got == bool(want)
    if mutation == "none":
        assert got is True


def test_tampered_container_bytes_rejected(verifiers):
    port, tpu, proof = verifiers
    for pos in (5, -1):
        blob = bytearray(proof.to_bytes())
        blob[pos] ^= 1
        assert port.verify(TProof.from_bytes(bytes(blob))) is False
        assert not tpu.verify(Proof.from_bytes(bytes(blob)))


def test_invalid_witness_raises():
    prog = [
        CombineOp.gf2(Gate(Op.INPUT, dst=0)),
        CombineOp.gf2(Gate(Op.ASSERT_ZERO, src1=0)),
    ]
    port = TorchKKW(carry(prog), device=CPU)
    with pytest.raises(AssertionError):
        port.prove([True], [], seeds=seeds256())
    assert port.verify(port.prove([False], [], seeds=seeds256())) is True


def _deep_circuit(depth=140):
    prog = [CombineOp.gf2(Gate(Op.INPUT, dst=0))]
    prog += [CombineOp.gf2(Gate(Op.ADDC, dst=0, src1=0, const=1)) for _ in range(depth)]
    return prog


@pytest.mark.parametrize("make", [
    lambda: z64_mul_bench_circuit(4),
    mixed_b2a_circuit,
    lambda: ([CombineOp.z64(Gate(Op.CONST, dst=0, const=3))], [], []),
    lambda: (_deep_circuit(140), [True], []),
], ids=["z64_mul4", "mixed_b2a", "z64_const", "deep140"])
def test_z64_b2a_and_deep_circuits_prove(make):
    """Z64 and B2A circuits and circuits deeper than 128 levels (which
    reverie_tpu runs on its scan executor) prove byte-equal to the NumPy
    golden prover on the levelized executor, and verify."""
    prog, wit2, witz = make()
    s = seeds256(11)
    port = TorchKKW(carry(prog), device=CPU)
    proof = port.prove(wit2, witz, seeds=s)
    assert proof.to_bytes() == golden_prove(
        prog, wit2, witz, seeds=s.reshape(32, 8, 16)).to_bytes()
    assert port.verify(proof) is True


def test_mesh_raises():
    """mesh= takes the port's own parallel.Mesh: any other object, a
    reverie_tpu (jax) mesh among them, raises TypeError."""
    from reverie_tpu.parallel import make_mesh as jax_make_mesh

    for mesh in (object(), jax_make_mesh(2)):
        with pytest.raises(TypeError, match="parallel Mesh"):
            TorchKKW(carry(mul_bench_circuit(4)[0]), device=CPU, mesh=mesh)
