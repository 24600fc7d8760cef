"""reverie_tpu_torch stands on its own: it imports neither jax nor
reverie_tpu, and its copies of the circuit compiler, bincode, builders,
proof container, challenge, protocol parameters and host crypto equal
reverie_tpu's.  Programs and proofs cross between the packages as bytes.
The committed parity digests are recomputed from reverie_tpu's NumPy golden
prover."""

import dataclasses
import hashlib
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import reverie_tpu.circuit as jcircuit
import reverie_tpu.circuit.builders as jbuilders
import reverie_tpu.circuit.sha256 as jsha256
import reverie_tpu.crypto as jcrypto
import reverie_tpu.params as jparams
import reverie_tpu.proof as jproof
from reverie_tpu.circuit.compile import compile_program as j_compile

import reverie_tpu_torch.circuit as tcircuit
import reverie_tpu_torch.circuit.builders as tbuilders
import reverie_tpu_torch.crypto as tcrypto
import reverie_tpu_torch.params as tparams
import reverie_tpu_torch.proof as tproof
from reverie_tpu_torch import TorchKKW, parity
from reverie_tpu_torch.circuit.compile import compile_program as t_compile

from test_fuzz_differential import random_program
from torch_threads import one_thread  # noqa: F401  (autouse)

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"


def carry(prog):
    """A reverie_tpu program as the port's, through bincode bytes."""
    return tcircuit.load_program(jcircuit.dumps_program(prog))


PROGRAMS = {
    "mul1000": lambda: jbuilders.mul_bench_circuit(1000)[0],
    "z64_mul200": lambda: jbuilders.z64_mul_bench_circuit(200)[0],
    "wide_and": lambda: jbuilders.wide_and_circuit(60, width=24, seed=3)[0],
    "b2a_golden": lambda: jcircuit.load_program((GOLDEN / "b2a_program.bin").read_bytes()),
    **{f"fuzz{s}": (lambda s=s, n=n: random_program(s, n)[0])
       for s, n in [(11, 60), (23, 60)] + [(s, 90) for s in range(40, 52)]},
}


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_compile_program_matches_reverie_tpu(name):
    """Every CompiledCircuit field, level table, column and dtype."""
    prog = PROGRAMS[name]()
    want = j_compile(prog)
    got = t_compile(carry(prog))
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "levels":
            assert len(a) == len(b)
            for la, lb in zip(a, b):
                assert la.keys() == lb.keys()
                for key in lb:
                    assert la[key].keys() == lb[key].keys()
                    for col in lb[key]:
                        assert la[key][col].dtype == lb[key][col].dtype, (key, col)
                        np.testing.assert_array_equal(la[key][col], lb[key][col])
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert got.depth == want.depth


@pytest.mark.parametrize("name", ["mul1000", "z64_mul200", "b2a_golden", "fuzz11"])
def test_bincode_round_trip_matches_reverie_tpu(name):
    blob = jcircuit.dumps_program(PROGRAMS[name]())
    prog = tcircuit.load_program(blob)
    assert all(type(op) is tcircuit.CombineOp for op in prog)
    assert tcircuit.dumps_program(prog) == blob
    with pytest.raises(ValueError, match="trailing"):
        tcircuit.load_program(blob + b"\x00")


@pytest.mark.parametrize("builder, args", [
    ("mul_bench_circuit", (30,)), ("wide_and_circuit", (40, 16, 5)),
    ("z64_mul_bench_circuit", (12,)), ("mixed_b2a_circuit", ()),
])
def test_builders_match_reverie_tpu(builder, args):
    jp, jw2, jwz = getattr(jbuilders, builder)(*args)
    tp, tw2, twz = getattr(tbuilders, builder)(*args)
    assert tcircuit.dumps_program(tp) == jcircuit.dumps_program(jp)
    assert (tw2, twz) == (jw2, jwz)


def test_params_match_reverie_tpu():
    assert dataclasses.asdict(tparams.DEFAULT_PARAMS) == dataclasses.asdict(jparams.DEFAULT_PARAMS)
    assert tparams.DEFAULT_PARAMS.preprocessing_reps == jparams.DEFAULT_PARAMS.preprocessing_reps
    for name in ("PLAYERS", "PACKED", "BATCH_SIZE", "ONLINE_REPS", "TOTAL_REPS",
                 "PREPROCESSING_REPS", "PACKED_REPS", "KEY_SIZE", "HASH_SIZE"):
        assert getattr(tparams, name) == getattr(jparams, name), name
    with pytest.raises(ValueError):
        tparams.ProtocolParams(players=4)


def test_proof_container_round_trip_matches_reverie_tpu():
    blob = (GOLDEN / "b2a_proof.bin").read_bytes()
    got, want = tproof.Proof.from_bytes(blob), jproof.Proof.from_bytes(blob)
    assert got.to_bytes() == blob
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.gf2.check_format(40, 216) and got.z64.check_format(40, 216)
    got.gf2.online[0].omit = 8
    assert not got.gf2.check_format(40, 216)
    with pytest.raises(ValueError, match="truncated"):
        tproof.Proof.from_bytes(blob[:-1])
    with pytest.raises(ValueError, match="trailing"):
        tproof.Proof.from_bytes(blob + b"\x00")


@pytest.mark.parametrize("seed", range(4))
def test_challenge_matches_reverie_tpu(seed):
    comm = np.random.RandomState(seed).bytes(32)
    assert (tproof.challenge_to_opening(comm, tparams.DEFAULT_PARAMS)
            == jproof.challenge_to_opening(comm, jparams.DEFAULT_PARAMS))


def test_host_crypto_matches_reverie_tpu():
    rng = np.random.RandomState(1)
    seeds = rng.randint(0, 256, (37, 16), dtype=np.uint8)
    np.testing.assert_array_equal(tcrypto.expand_seeds(seeds), jcrypto.expand_seeds(seeds))
    np.testing.assert_array_equal(tcrypto.key_expand_batch(seeds),
                                  jcrypto.key_expand_batch(seeds))
    np.testing.assert_array_equal(tcrypto.keystream_batch(seeds, 64, 5),
                                  jcrypto.keystream_batch(seeds, 64, 5))
    for n in (0, 1, 63, 64, 1024, 1025, 5000):
        data = rng.bytes(n)
        assert tcrypto.blake3(data) == jcrypto.blake3(data)
        assert tcrypto.blake3_xof(data, 100) == jcrypto.blake3_xof(data, 100)
    for shape in ((5, 0), (3, 1), (7, 1024), (4, 3000)):
        rows = rng.randint(0, 256, shape, dtype=np.uint8)
        np.testing.assert_array_equal(tcrypto.blake3_many(rows), jcrypto.blake3_many(rows))
    ro_t, ro_j = tcrypto.RandomOracle("ctx", b"abc"), jcrypto.RandomOracle("ctx", b"abc")
    assert [ro_t.fill(16) for _ in range(5)] == [ro_j.fill(16) for _ in range(5)]


@pytest.mark.parametrize("name", list(parity.CASES))
def test_parity_digests_match_the_golden_prover(name):
    """The committed digest is reverie_tpu.proof.prove's, and the port's
    builders and seeds reproduce the golden's inputs."""
    case = parity.CASES[name]
    prog, w2, wz, seeds = parity.inputs(case)
    if case.builder == "sha256_bench":  # bench.py's SHA-256 statement
        msg = parity.SHA256_MESSAGE
        jprog, _ = jsha256.sha256_preimage_statement(hashlib.sha256(msg).digest())
        jw2, jwz = jsha256.block_to_witness_bits(jsha256.sha256_pad_one_block(msg)), []
    else:
        jprog, jw2, jwz = getattr(jbuilders, case.builder)(*case.args)
    assert tcircuit.dumps_program(prog) == jcircuit.dumps_program(jprog)
    assert (w2, wz) == (jw2, jwz)
    blob = jproof.prove(jprog, jw2, jwz, seeds=seeds.reshape(32, 8, 16)).to_bytes()
    assert len(blob) == case.length
    assert hashlib.sha256(blob).hexdigest() == case.sha256
    assert parity.matches(case, blob)
    assert not parity.matches(case, blob[:-1] + bytes([blob[-1] ^ 1]))


def test_torchkkw_rejects_reverie_tpu_ops():
    prog = jbuilders.mul_bench_circuit(4)[0]
    with pytest.raises(TypeError, match="bincode"):
        TorchKKW(prog, device=torch.device("cpu"))
    mixed = carry(prog) + prog[-1:]
    with pytest.raises(TypeError):
        TorchKKW(mixed, device=torch.device("cpu"))
    foreign_gate = tcircuit.CombineOp.gf2(prog[-1].gate)
    with pytest.raises(TypeError):
        TorchKKW([foreign_gate], device=torch.device("cpu"))
    assert TorchKKW(carry(prog), device=torch.device("cpu")).cc.m2 == 10


_POISONED = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["reverie_tpu"] = None
import reverie_tpu_torch
names = [m.name for m in pkgutil.walk_packages(reverie_tpu_torch.__path__, "reverie_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from reverie_tpu_torch.circuit import dumps_program
from reverie_tpu_torch.circuit.bincode import load_program_arrays
from reverie_tpu_torch.circuit.builders import mul_bench_circuit
assert len(load_program_arrays(dumps_program(mul_bench_circuit(9)[0])).kind) == 3
bad = [m for m in sys.modules if sys.modules[m] is not None
       and (m.split(".")[0] in ("jax", "reverie_tpu"))]
assert not bad, bad
print(" ".join(names))
print("poisoned import ok", len(names))
"""

#: the CLI's modules and the mesh's, which the walk must reach
CLI_MODULES = ("cli", "circuit.bristol", "circuit.witness", "circuit.eval", "utils.buildinfo",
               "circuit.bincode", "circuit.compile_native", "tools.make_sha256_statement",
               "tools.inspect_proof", "tools.past_card", "parallel", "parallel.mesh",
               "parallel.distributed")


def test_imports_with_jax_and_reverie_tpu_poisoned():
    """Every module of the port (the CLI's among them) and chip_smoke
    import with `jax` and `reverie_tpu` made unimportable (in a subprocess,
    so the poison stays out of this worker), and the C program reader
    (bincode.load_program_arrays) runs there."""
    res = subprocess.run([sys.executable, "-c", _POISONED], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    n = int(res.stdout.split()[-1])
    assert n >= 20  # the walk found the package's modules
    walked = set(res.stdout.split())
    assert not [m for m in CLI_MODULES if f"reverie_tpu_torch.{m}" not in walked]


def test_no_source_line_imports_jax_or_reverie_tpu():
    pat = re.compile(r"^\s*(import|from)\s+(jax|reverie_tpu)(\s|\.|$)")
    files = [*sorted((REPO / "reverie_tpu_torch").rglob("*.py")), REPO / "chip_smoke.py"]
    bad = [f"{f.relative_to(REPO)}:{i}" for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1) if pat.match(line)]
    assert not bad, bad
