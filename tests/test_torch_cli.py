"""The port's command line (`python -m reverie_tpu_torch.cli`) on the CPU,
`--backend cpu`: TorchKKW and StreamingKKW on the CPU device, through the
kernels' plain versions.  Against reverie_tpu's CLI (`--backend cpu`, its
NumPy golden prover; `--segment-ops`, its StreamingKKW):
- tests/test_cli.py's cases: oneshot, prove -> verify -> a corrupted byte
  rejected, streamed, version_info, Bristol with its right and wrong output;
- proof files byte-equal to reverie_tpu's CLI with os.urandom fixed (both
  draw a proof's rep seeds from it once), on the 5-gate program, a Bristol
  circuit of every gate kind and the streamed 5-gate program;
- either CLI verifying the other's proofs; tests/golden/b2a_proof.bin
  accepted and a tampered copy rejected;
- no fallback: the default `--backend cuda` raises without a card and
  writes no proof;
- the copied circuit modules (bristol, witness, eval, largest_wires) equal
  to reverie_tpu's on the same inputs, and the tools make_sha256_statement
  and inspect_proof to reverie_tpu's tools/.
The cases run in-process through `main(argv)`; one spawns the module.
Proofs are bytes: the tolerance is 0."""

import importlib.util
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import reverie_tpu.circuit as jcircuit
from reverie_tpu import cli as jcli
from reverie_tpu.circuit import builders as jbuilders
from reverie_tpu.circuit import bristol as jbristol
from reverie_tpu.circuit import eval as jeval

import reverie_tpu_torch.circuit as tcircuit
from reverie_tpu_torch import cli
from reverie_tpu_torch.circuit import bristol as tbristol
from reverie_tpu_torch.circuit import eval as teval
from reverie_tpu_torch.proof import Proof
from reverie_tpu_torch.tools import inspect_proof, make_sha256_statement
from torch_threads import one_thread  # noqa: F401  (autouse)

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"

#: a Bristol-fashion circuit with every gate kind the parser takes (XOR,
#: AND, INV, NOT, EQ, EQW, MAND): inputs a = w0 w1, b = w2 w3; outputs the
#: last four wires, w12..w15
BRISTOL_ALL_KINDS = """11 16
2 2 2
1 4

2 1 0 2 4 XOR
2 1 1 3 5 AND
1 1 4 6 INV
1 1 1 7 EQ
1 1 5 8 EQW
4 2 0 1 2 3 9 10 MAND
1 1 5 11 NOT
2 1 6 7 12 XOR
2 1 8 9 13 AND
1 1 10 14 EQW
1 1 11 15 EQW
"""


@pytest.fixture(autouse=True)
def no_jit_cache(monkeypatch, tmp_path):
    """reverie_tpu's CLI keeps no persistent compile cache in these tests,
    and the port's CLI its compile cache in the test's directory."""
    monkeypatch.setenv("REVERIE_JIT_CACHE", "0")
    monkeypatch.setenv("REVERIE_COMPILE_CACHE", str(tmp_path / "compile_cache"))


def five_gate():
    g, G, Op = jcircuit.CombineOp.gf2, jcircuit.Gate, jcircuit.Op
    return [
        g(G(Op.INPUT, dst=0)),
        g(G(Op.INPUT, dst=1)),
        g(G(Op.MUL, dst=2, src1=0, src2=1)),
        g(G(Op.ADDC, dst=3, src1=2, const=1)),
        g(G(Op.ASSERT_ZERO, src1=3)),
    ]


def bristol_output(text: str, wit: str) -> str:
    """The circuit's output bits on the witness, by reverie_tpu's cleartext
    evaluator."""
    circ = jbristol.parse_bristol(text)
    _, gf2 = jeval.evaluate_composite_program(
        jbristol.bristol_to_program(circ), [c == "1" for c in wit], [])
    return "".join(str(int(gf2[w])) for w in circ.output_wires())


@pytest.fixture()
def workdir(tmp_path):
    (tmp_path / "prog.bin").write_bytes(jcircuit.dumps_program(five_gate()))
    (tmp_path / "wit.txt").write_bytes(jcircuit.format_witness_bits([True, True]))
    (tmp_path / "c.txt").write_text(BRISTOL_ALL_KINDS)
    (tmp_path / "w.txt").write_bytes(b"1101")
    return tmp_path


def run(main, capsys, *argv):
    """main(argv) in-process: (rc, stdout, stderr)."""
    rc = main([str(a) for a in argv])
    out = capsys.readouterr()
    return rc, out.out, out.err


def port(capsys, *argv):
    return run(cli.main, capsys, *argv, "--backend", "cpu")


def reference(capsys, *argv):
    return run(jcli.main, capsys, *argv, "--backend", "cpu")


def fix_urandom(monkeypatch, seed: int) -> None:
    """os.urandom(n) -> the first n bytes of RandomState(seed)."""
    monkeypatch.setattr(os, "urandom", lambda n: np.random.RandomState(seed).bytes(n))


# -- tests/test_cli.py's cases -------------------------------------------------


def test_cli_oneshot(workdir, capsys):
    rc, out, _ = port(capsys, "--operation", "oneshot", "--program-path", workdir / "prog.bin",
                      "--witness-path", workdir / "wit.txt")
    assert rc == 0 and out.splitlines() == ["Evaluating program in cleartext", "Ok(())"]
    (workdir / "bad.txt").write_bytes(b"10")
    with pytest.raises(AssertionError, match="AssertZero failed on gf2 wire 3"):
        port(capsys, "--operation", "oneshot", "--program-path", workdir / "prog.bin",
             "--witness-path", workdir / "bad.txt")


def first_comm_online_byte(blob: bytes) -> int:
    """The offset of the first byte of the first GF(2) preprocessing
    opening's comm_online in a proof file."""
    proof = Proof.from_bytes(blob)
    opening = proof.gf2.preprocessing[0]
    opening.comm_online = bytes([opening.comm_online[0] ^ 1]) + opening.comm_online[1:]
    diff = [i for i, (a, b) in enumerate(zip(proof.to_bytes(), blob)) if a != b]
    assert len(diff) == 1
    return diff[0]


def test_cli_prove_verify_roundtrip(workdir, capsys, monkeypatch):
    """Prove, verify, and two flipped bytes rejected: the commitment, and
    the first preprocessing opening's comm_online (its rep hash, which the
    commitment binds on every seed).  os.urandom is fixed: the omit flip of
    byte 40 depends on the seeds (test_cli_omit_flip_verdict_matches_reverie_tpu)."""
    fix_urandom(monkeypatch, 7)
    proof = workdir / "proof.bin"
    rc, out, _ = port(capsys, "--operation", "prove", "--program-path", workdir / "prog.bin",
                      "--witness-path", workdir / "wit.txt", "--proof-path", proof)
    assert rc == 0 and out.startswith("Evaluating program in ~zero knowledge~\n")
    assert f"proof written: {proof.stat().st_size} bytes in " in out
    verify = ("--operation", "verify", "--program-path", workdir / "prog.bin",
              "--proof-path", proof)
    rc, out, _ = port(capsys, *verify)
    assert rc == 0 and out.startswith("Verifying Proof\nverified in ")
    assert out.endswith("Ok(())\n")
    good = proof.read_bytes()
    for at in (0, first_comm_online_byte(good)):
        blob = bytearray(good)
        blob[at] ^= 1
        proof.write_bytes(bytes(blob))
        rc, out, err = port(capsys, *verify)
        assert rc == 1 and err == "Unverifiable Proof\n" and "Ok(())" not in out
    proof.write_bytes(good[:-1])
    with pytest.raises(ValueError, match="truncated"):
        port(capsys, *verify)


#: the seeds of os.urandom whose proof of the five-gate program verifies
#: with byte 40 (the first GF(2) online opening's omit) flipped, in both
#: CLIs: the verifier reads each opened rep's omit from the proof and ties
#: it to the challenge only through the online hash it recomputes, which
#: for this one-AND circuit sometimes does not depend on which player is
#: left out (ROADMAP Queue 3)
OMIT_FLIP_ACCEPTED = (24, 28)


@pytest.mark.parametrize("seed", range(40))
def test_cli_omit_flip_verdict_matches_reverie_tpu(workdir, capsys, monkeypatch, seed):
    """Byte 40 flipped in the port's proof (os.urandom fixed to the seed):
    the port's CLI and reverie_tpu's CLI give the same verdict on the same
    bytes, accepting at the seeds of OMIT_FLIP_ACCEPTED and rejecting at
    every other seed of 0-39."""
    fix_urandom(monkeypatch, seed)
    proof = workdir / "proof.bin"
    assert port(capsys, "--operation", "prove", "--program-path", workdir / "prog.bin",
                "--witness-path", workdir / "wit.txt", "--proof-path", proof)[0] == 0
    good = proof.read_bytes()
    blob = bytearray(good)
    blob[40] ^= 1
    assert Proof.from_bytes(bytes(blob)).gf2.online[0].omit == \
        Proof.from_bytes(good).gf2.online[0].omit ^ 1
    proof.write_bytes(bytes(blob))
    verify = ("--operation", "verify", "--program-path", workdir / "prog.bin",
              "--proof-path", proof)
    got, want = port(capsys, *verify), reference(capsys, *verify)
    assert got[0] == want[0] == (0 if seed in OMIT_FLIP_ACCEPTED else 1)
    assert got[2] == want[2] == ("" if seed in OMIT_FLIP_ACCEPTED else "Unverifiable Proof\n")


def test_cli_streamed_prove_verify(workdir, capsys):
    """--segment-ops 2 streams the proof; the streamed and the unsegmented
    verifier accept it."""
    paths = ("--program-path", workdir / "prog.bin", "--proof-path", workdir / "proof.bin")
    rc, _, _ = port(capsys, "--operation", "prove", *paths, "--witness-path",
                    workdir / "wit.txt", "--segment-ops", 2)
    assert rc == 0
    for extra in (("--segment-ops", 2), ()):
        rc, out, _ = port(capsys, "--operation", "verify", *paths, *extra)
        assert rc == 0 and out.endswith("Ok(())\n")


def test_cli_version_as_a_module():
    """The one spawned case: the module's entry point."""
    r = subprocess.run([sys.executable, "-m", "reverie_tpu_torch.cli", "--operation",
                        "version_info"], capture_output=True, text=True, cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=str(REPO)), timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.splitlines()[0] == "reverie_tpu_torch_version: 0.1.0"


def test_cli_bristol_prove_verify(workdir, capsys):
    """--format bristol with --bristol-output binding the public output: the
    right bits prove and verify, the wrong ones fail the prover's assert."""
    right = bristol_output(BRISTOL_ALL_KINDS, "1101")
    wrong = right[:-1] + str(1 - int(right[-1]))
    argv = ("--operation", "oneshot-zk", "--program-path", workdir / "c.txt",
            "--witness-path", workdir / "w.txt", "--format", "bristol")
    rc, out, _ = port(capsys, *argv, "--bristol-output", right)
    assert rc == 0 and out.endswith("Ok(())\n")
    with pytest.raises(AssertionError, match="invalid"):
        port(capsys, *argv, "--bristol-output", wrong)
    for bad, msg in (("012", "must be '0'/'1' bits"), ("1", "has 1 bits, circuit outputs 4")):
        with pytest.raises(SystemExit, match=msg):
            port(capsys, *argv, "--bristol-output", bad)


@pytest.mark.parametrize("op, missing", [
    ("prove", "--witness-path"), ("verify", "--proof-path"),
    ("oneshot", "--witness-path"), ("oneshot-zk", "--witness-path"),
])
def test_cli_missing_paths(workdir, capsys, op, missing):
    rc, _, err = port(capsys, "--operation", op, "--program-path", workdir / "prog.bin")
    assert rc == 2 and err == f"{missing} is required for {op}\n"


# -- against reverie_tpu's CLI -------------------------------------------------


PARITY_CASES = {
    "five_gate": lambda d: ("--program-path", d / "prog.bin", "--witness-path", d / "wit.txt"),
    "bristol_all_kinds": lambda d: (
        "--program-path", d / "c.txt", "--witness-path", d / "w.txt", "--format", "bristol",
        "--bristol-output", bristol_output(BRISTOL_ALL_KINDS, "1101")),
    "five_gate_streamed": lambda d: ("--program-path", d / "prog.bin", "--witness-path",
                                     d / "wit.txt", "--segment-ops", 2),
}


@pytest.mark.parametrize("case", list(PARITY_CASES))
def test_proof_files_equal_reverie_tpu_cli(workdir, capsys, monkeypatch, case):
    """With os.urandom fixed, the port's CLI writes the bytes reverie_tpu's
    CLI writes."""
    argv = PARITY_CASES[case](workdir)
    fix_urandom(monkeypatch, 11)
    assert reference(capsys, "--operation", "prove", *argv, "--proof-path",
                     workdir / "ref.bin")[0] == 0
    assert port(capsys, "--operation", "prove", *argv, "--proof-path",
                workdir / "port.bin")[0] == 0
    assert (workdir / "port.bin").read_bytes() == (workdir / "ref.bin").read_bytes()


@pytest.mark.parametrize("prover, verifier", [("reference", "port"), ("port", "reference")])
def test_each_cli_verifies_the_others_proofs(workdir, capsys, prover, verifier):
    clis = {"reference": reference, "port": port}
    paths = ("--program-path", workdir / "c.txt", "--format", "bristol", "--bristol-output",
             bristol_output(BRISTOL_ALL_KINDS, "1101"), "--proof-path", workdir / "proof.bin")
    assert clis[prover](capsys, "--operation", "prove", *paths, "--witness-path",
                        workdir / "w.txt")[0] == 0
    rc, out, _ = clis[verifier](capsys, "--operation", "verify", *paths)
    assert rc == 0 and out.endswith("Ok(())\n")


def test_cli_verifies_the_b2a_golden(tmp_path, capsys):
    """tests/golden/b2a_proof.bin (reverie_tpu's, 190 levels: the wave
    executor) verifies against b2a_program.bin; one flipped bit in a GF(2)
    online opening's recons does not."""
    program = GOLDEN / "b2a_program.bin"
    blob = (GOLDEN / "b2a_proof.bin").read_bytes()
    rc, out, _ = port(capsys, "--operation", "verify", "--program-path", program,
                      "--proof-path", GOLDEN / "b2a_proof.bin")
    assert rc == 0 and out.endswith("Ok(())\n")
    bad = Proof.from_bytes(blob)
    bad.gf2.online[0].recons = bytes([bad.gf2.online[0].recons[0] ^ 1]) + \
        bad.gf2.online[0].recons[1:]
    tampered = bad.to_bytes()
    assert len(tampered) == len(blob) and sum(a != b for a, b in zip(tampered, blob)) == 1
    (tmp_path / "bad.bin").write_bytes(tampered)
    rc, out, err = port(capsys, "--operation", "verify", "--program-path", program,
                        "--proof-path", tmp_path / "bad.bin")
    assert rc == 1 and err == "Unverifiable Proof\n"


@pytest.mark.parametrize("op", ["prove", "verify", "oneshot-zk"])
def test_default_backend_never_falls_back_to_the_cpu(workdir, monkeypatch, op):
    """--backend cuda is the default; without a card it raises
    default_device's error and writes no proof."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"prove": ("--program-path", workdir / "prog.bin", "--witness-path",
                      workdir / "wit.txt", "--proof-path", workdir / "proof.bin"),
            "verify": ("--program-path", GOLDEN / "b2a_program.bin", "--proof-path",
                       GOLDEN / "b2a_proof.bin"),
            "oneshot-zk": ("--program-path", workdir / "prog.bin", "--witness-path",
                           workdir / "wit.txt")}[op]
    with pytest.raises(RuntimeError, match=r"torch.cuda.is_available\(\) is false"):
        cli.main(["--operation", op, *map(str, argv)])
    assert not (workdir / "proof.bin").exists()


# -- the copied modules --------------------------------------------------------


def eval_programs():
    """(program of reverie_tpu's classes, wit_gf2, wit_z64) by name."""
    b2a = jcircuit.load_program((GOLDEN / "b2a_program.bin").read_bytes())
    circ = jbristol.parse_bristol(BRISTOL_ALL_KINDS)
    return {
        "five_gate": (five_gate(), [True, True], []),
        "bristol_all_kinds": (jbristol.bristol_to_program(circ), [True, True, False, True], []),
        "b2a_golden": (b2a, *jbuilders.mixed_b2a_circuit()[1:]),
        "z64_mul": jbuilders.z64_mul_bench_circuit(20),
        "wide_and": jbuilders.wide_and_circuit(30, width=12, seed=4),
    }


@pytest.mark.parametrize("name", ["five_gate", "bristol_all_kinds", "b2a_golden", "z64_mul",
                                  "wide_and"])
def test_eval_and_largest_wires_match_reverie_tpu(name):
    prog, w2, wz = eval_programs()[name]
    tprog = tcircuit.load_program(jcircuit.dumps_program(prog))
    assert tcircuit.largest_wires(tprog) == jcircuit.largest_wires(prog)
    for got, want in zip(teval.evaluate_composite_program(tprog, w2, wz),
                         jeval.evaluate_composite_program(prog, w2, wz)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_eval_failing_assertion_matches_reverie_tpu():
    prog = five_gate()
    tprog = tcircuit.load_program(jcircuit.dumps_program(prog))
    with pytest.raises(AssertionError) as want:
        jeval.evaluate_composite_program(prog, [True, False], [])
    with pytest.raises(AssertionError) as got:
        teval.evaluate_composite_program(tprog, [True, False], [])
    assert str(got.value) == str(want.value)
    z2, g2 = teval.evaluate_composite_program(tprog, [True, False], [], check_assertions=False)
    z1, g1 = jeval.evaluate_composite_program(prog, [True, False], [], check_assertions=False)
    np.testing.assert_array_equal(g2, g1)


@pytest.mark.parametrize("text", [
    BRISTOL_ALL_KINDS,
    "1 3\n2 1 1\n1 1\n\n2 1 0 1 2 AND\n",  # tests/test_cli.py's circuit
])
def test_bristol_matches_reverie_tpu(text):
    got, want = tbristol.parse_bristol(text), jbristol.parse_bristol(text)
    assert vars(got) == vars(want)
    assert (got.n_input_bits, got.n_output_bits, got.output_wires()) == \
        (want.n_input_bits, want.n_output_bits, want.output_wires())
    assert tcircuit.dumps_program(tbristol.bristol_to_program(got)) == \
        jcircuit.dumps_program(jbristol.bristol_to_program(want))
    bits = [i % 2 for i in range(want.n_output_bits)]
    assert tcircuit.dumps_program(tbristol.bristol_with_output_assertion(got, bits)) == \
        jcircuit.dumps_program(jbristol.bristol_with_output_assertion(want, bits))
    for mod in (tbristol, jbristol):
        with pytest.raises(ValueError, match="length mismatch"):
            mod.bristol_with_output_assertion(mod.parse_bristol(text), bits + [0])
        with pytest.raises(ValueError, match="unsupported Bristol gate kind OR"):
            mod.bristol_to_program(mod.parse_bristol(text.replace("AND", "OR")))
        ngates = int(text.split()[0])
        with pytest.raises(ValueError, match=f"expected {ngates + 1} gates, parsed {ngates}"):
            mod.parse_bristol(text.replace(str(ngates), str(ngates + 1), 1))


def test_witness_matches_reverie_tpu(tmp_path):
    data = np.random.RandomState(5).choice(list(b"01, \n\t01x"), 500).astype(np.uint8).tobytes()
    bits = tcircuit.parse_witness_bits(data)
    assert bits == jcircuit.parse_witness_bits(data) and len(bits) > 100
    (tmp_path / "w.txt").write_bytes(data)
    assert tcircuit.parse_witness_file(str(tmp_path / "w.txt")) == bits
    assert tcircuit.format_witness_bits(bits) == jcircuit.format_witness_bits(bits)


# -- the tools -----------------------------------------------------------------


def reference_tool(name: str):
    """reverie_tpu's tools/<name>.py, loaded from its file."""
    spec = importlib.util.spec_from_file_location(f"reference_{name}",
                                                  REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_make_sha256_statement_matches_reverie_tpu_tool(tmp_path, capsys, monkeypatch):
    """The port's tool writes reverie_tpu's tool's program and witness
    files (a two-block message: the chained statement)."""
    msg = "x" * 60
    assert make_sha256_statement.main(["--message", msg, str(tmp_path / "port")]) == 0
    port_out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["make_sha256_statement.py", "--message", msg,
                                      str(tmp_path / "ref")])
    assert reference_tool("make_sha256_statement").main() == 0
    assert port_out.replace("port", "ref") == capsys.readouterr().out
    for name in ("program.bin", "witness.txt"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes()


def test_inspect_proof_matches_reverie_tpu_tool(capsys, monkeypatch):
    path = str(GOLDEN / "b2a_proof.bin")
    assert inspect_proof.main([path]) == 0
    port_out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["inspect_proof.py", path])
    assert reference_tool("inspect_proof").main() == 0
    assert port_out == capsys.readouterr().out
    assert inspect_proof.main([]) == 2
