"""The Z_2^64 configuration (z64_mul_50k) on the CPU: its plain reference
(reference/kkw_z64.py) reproduces reverie's B2A golden proof and proves
what the port proves, byte for byte, on the statement and on random mixed
programs of every Z_2^64 kind; the statement's file is the port's; the
port rejects each tampered copy a verify mix sends it; every file loads
through kkwbench.spec; the work counts of K4 and W2 equal the port's, and
the port's row counters equal the benchmark's own count of the program;
tiny cells of the statement run correct, and report the new metrics."""

from __future__ import annotations

import json
import random
import shutil
from pathlib import Path

import numpy as np
import pytest

from kkwbench import peaks, program, spec as specs, tamper
from kkwbench.driver import PROVER, VERIFY_ONL, VERIFY_PRE
from kkwbench.metrics import (aes_tape_z64_roofline, blake3_roofline, blake3_z64_roofline,
                              scan_z64_roofline)
from kkwbench.program import (ADD, ADDC, ASSERT_ZERO, B2A, CONST, GF2, INPUT, MUL, MULC, RANDOM,
                              SUB, SUBC, Z64, from_rows)
from kkwbench.reference import kkw_z64
from kkwbench.statements import z64_mul_b2a

SPEC = specs.load()
GOLDEN = specs.ROOT / "tests" / "golden"
CELLS = ("z64_mul_50k.prove_chunk4", "z64_mul_50k.verify_stream")
NEW_METRICS = ("aes_tape_z64_roofline", "scan_z64_roofline", "z64_host_ms_per_proof",
               "blake3_z64_roofline")
Z64_KINDS = (INPUT, RANDOM, CONST, ADD, SUB, ADDC, SUBC, MULC, MUL, ASSERT_ZERO)


def _port(prog):
    from reverie_tpu_torch import TorchKKW
    from reverie_tpu_torch.circuit.bincode import load_program_arrays

    return TorchKKW(load_program_arrays(program.to_bincode(prog)), device="cpu")


def _statement(n_mul: int, seed: int):
    return z64_mul_b2a.make({"n_mul": n_mul}, np.random.default_rng([seed, 0]))


def mixed_program(seed: int):
    """A random program of every Z_2^64 kind and two B2As, on wires that
    hold values: (program, GF(2) witness bits, Z_2^64 witness words).  Its
    AssertZeros hold on any witness (x - x, and GF(2) x + x)."""
    r = random.Random(seed)
    rows = [(GF2, INPUT, w, 0, 0, 0) for w in range(130)]
    rows += [(GF2, r.choice((ADD, SUB, MUL)), 130 + i, r.randrange(130), r.randrange(130), 0)
             for i in range(6)]
    rows += [(GF2, ADDC, 136, 3, 0, 1), (GF2, MULC, 137, 4, 0, 1), (GF2, SUBC, 138, 5, 0, 0),
             (GF2, RANDOM, 139, 0, 0, 0), (GF2, CONST, 140, 0, 0, 1),
             (GF2, ADD, 141, 139, 139, 0), (GF2, ASSERT_ZERO, 0, 141, 0, 0)]
    rows += [(B2A, 0, 0, 0, 0, 0), (Z64, INPUT, 1, 0, 0, 0), (Z64, INPUT, 2, 0, 0, 0),
             (Z64, RANDOM, 3, 0, 0, 0), (Z64, CONST, 4, 0, 0, r.getrandbits(64))]
    live = [0, 1, 2, 3, 4]
    for i in range(40):
        k = (ADD, SUB, ADDC, SUBC, MULC, MUL)[i % 6]
        a, b = r.choice(live), r.choice(live)
        dst = 5 + i % 12
        rows.append((Z64, k, dst, a, b if k in (ADD, SUB, MUL) else 0,
                     r.getrandbits(64) if k in (ADDC, SUBC, MULC) else 0))
        live.append(dst)
        if i == 20:
            rows.append((B2A, 0, 20, 64, 0, 0))
            live.append(20)
    rows += [(Z64, SUB, 30, live[-1], live[-1], 0), (Z64, ASSERT_ZERO, 0, 30, 0, 0),
             (GF2, MUL, 142, 136, 137, 0)]
    wit2 = np.asarray([r.getrandbits(1) for _ in range(130)], dtype=np.uint8)
    witz = np.asarray([r.getrandbits(64) for _ in range(2)], dtype=np.uint64)
    return from_rows(rows), wit2, witz


def _seeds(seed: int, n: int = 1) -> np.ndarray:
    return np.random.default_rng([seed, 1]).integers(0, 256, (n, 256, 16), dtype=np.uint8)


def test_reference_reproduces_the_b2a_golden():
    """reverie's round-trip circuit (src/proof/mod.rs:397-427), proved from
    the committed seeds, gives the committed proof file."""
    rows = [(GF2, INPUT, 1, 0, 0, 0)] * 64 + [(B2A, 0, 0, 2, 0, 0)] + [
        (GF2, INPUT, 0, 0, 0, 0), (GF2, INPUT, 1, 0, 0, 0), (GF2, MUL, 2, 0, 1, 0),
        (GF2, ADD, 3, 0, 1, 0), (GF2, MUL, 2, 2, 3, 0)]
    prog = from_rows(rows)
    assert program.to_bincode(prog) == (GOLDEN / "b2a_program.bin").read_bytes()
    seeds = np.frombuffer((GOLDEN / "b2a_seeds.bin").read_bytes(), dtype=np.uint8)
    proof = kkw_z64.prove(prog, np.ones((1, 66), dtype=np.uint8), seeds.reshape(1, 256, 16),
                          "cpu")[0]
    assert proof == (GOLDEN / "b2a_proof.bin").read_bytes()


@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_statement_equals_the_port(seed):
    st = _statement(64, seed)
    wit = st.witnesses(np.random.default_rng([seed, 2]), 2)
    port = _port(st.program)
    proofs = port.prove_batch_chunked([(w, []) for w in wit], _seeds(seed, 2), chunk=2)
    assert kkw_z64.prove(st.program, wit, _seeds(seed, 2), "cpu") == [p.to_bytes() for p in proofs]


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_mixed_program_equals_the_port(seed):
    prog, wit2, witz = mixed_program(seed)
    assert {int(o) for o in prog.op[prog.kind == Z64]} == set(Z64_KINDS)
    assert int((prog.kind == B2A).sum()) == 2
    port = _port(prog)
    proof = port.prove(wit2.tolist(), [int(v) for v in witz], _seeds(seed)[0])
    want = kkw_z64.prove(prog, wit2[None], _seeds(seed), "cpu", witz=witz[None])[0]
    assert want == proof.to_bytes()
    assert port.verify(proof)


def test_reference_refuses_a_failed_assert_and_missing_words():
    prog, wit2, witz = mixed_program(11)
    bad = from_rows([(Z64, INPUT, 0, 0, 0, 0), (Z64, ASSERT_ZERO, 0, 0, 0, 0)])
    with pytest.raises(AssertionError):
        kkw_z64.prove(bad, np.zeros((1, 0), np.uint8), _seeds(1), "cpu",
                      witz=np.ones((1, 1), np.uint64))
    with pytest.raises(ValueError):
        kkw_z64.prove(prog, wit2[None], _seeds(1), "cpu")


def test_statement_file_is_the_ports():
    from reverie_tpu_torch.circuit import CombineOp, Gate, Op, dumps_program

    n = 37
    ops = [CombineOp.gf2(Gate(Op.INPUT, dst=w)) for w in range(128)]
    ops += [CombineOp.b2a(0, 0), CombineOp.b2a(1, 64)]
    ops += [CombineOp.z64(Gate(Op.MUL, dst=2, src1=0, src2=1))] * n
    assert program.to_bincode(_statement(n, 5).program) == dumps_program(ops)


@pytest.fixture(scope="module")
def small_proofs():
    st = _statement(16, 7)
    wit = st.witnesses(np.random.default_rng(8), 2)
    port = _port(st.program)
    return port, port.prove_many([(w, []) for w in wit], _seeds(7, 2))


@pytest.mark.parametrize("kind", tamper.KINDS)
def test_port_rejects_each_tampered_copy(small_proofs, kind):
    from reverie_tpu_torch.proof.container import Proof

    port, proofs = small_proofs
    bad = Proof.from_bytes(tamper.tamper(proofs[0].to_bytes(), kind))
    assert port.verify_many([proofs[1], bad, proofs[0]]) == [True, False, True]


def test_files_load_through_spec():
    cfg = specs.config(SPEC, "z64_mul_50k")
    assert cfg["statement"] == "z64_mul_b2a" and cfg["args"] == {"n_mul": 50000}
    assert cfg["reference"] == "kkw_z64" and cfg["reference_sample"] == 2
    assert cfg["reduced"] == {} and cfg["entry"]["reduced"] == []
    assert cfg["guarantees"] == specs.config(SPEC, "gf2_mul_1M")["guarantees"]
    assert specs.statement("z64_mul_b2a") is z64_mul_b2a
    assert specs.reference("kkw_z64") is kkw_z64
    assert specs.traffic("prove_chunk4") == {"entry": "prove_batch_chunked",
                                             "statements_per_call": 32, "chunk": 4,
                                             "warmup_calls": 1}
    cells = {w["name"]: w for w in SPEC["workloads"]}
    assert cells[CELLS[0]]["traffic"] == "prove_chunk4"
    assert cells[CELLS[1]]["traffic"] == "verify_stream_16"
    assert all(cells[c]["chips"] == 1 for c in CELLS)
    for name in NEW_METRICS:
        for part, cell in zip(("prove", "verify"), CELLS):
            m = next(m for m in SPEC["per_layer"] if m["name"] == f"{name}.{part}")
            assert m["workloads"] == [cell]
            reader, got = specs.metric(m["name"])
            assert callable(reader.read) and got == part
    for m in SPEC["per_layer"]:
        if m["name"].split(".")[0] in ("aes_tape_gf2_roofline", "blake3_roofline",
                                        "scan_gf2_roofline"):
            assert not set(m["workloads"]) & set(CELLS)


# -- work counts ----------------------------------------------------------------

def test_tape_work_gives_the_k4_bound():
    """K4 at mz = 100,002, R = 256 and 1,980 MHz: 0.7408 ms (PERF.md's K4
    row), set by its operations; the online verifier's omitted keys none."""
    b, o = aes_tape_z64_roofline.work(100_002, 256, 8 * 256)
    assert peaks.bound_s(b, o, 1980.0) * 1e3 == pytest.approx(0.7408, abs=5e-5)
    assert o / (peaks.SMS * peaks.ISSUE_LANES_PER_SM * 1980e6) > b / peaks.HBM_BYTES_PER_S
    assert aes_tape_z64_roofline.work(100_002, 40, 7 * 40)[1] * 8 == \
        aes_tape_z64_roofline.work(100_002, 40, 8 * 40)[1] * 7


def _opcodes(gates: dict) -> np.ndarray:
    """A {kind: gates} as an opcode column, the wave table without its
    empty slots."""
    return np.repeat(np.asarray(sorted(gates), dtype=np.int64), [gates[k] for k in sorted(gates)])


@pytest.fixture(scope="module")
def statement_cc():
    from reverie_tpu_torch.circuit.bincode import load_program_arrays
    from reverie_tpu_torch.circuit.compile import compile_program

    st = _statement(300, 3)
    return st, compile_program(load_program_arrays(program.to_bincode(st.program)))


def test_wave_work_equals_the_port(statement_cc):
    """The frozen W2 formulas equal roofline.wave_gf2_work +
    wave_z64_work on the statement's wave table (its gates, without the
    empty slots; a B2A's two steps each a row of the bits table)."""
    from reverie_tpu_torch.backend import scan
    from reverie_tpu_torch.roofline import wave_gf2_work, wave_z64_work

    st, cc = statement_cc
    wv = scan.waves(cc)
    ops, zops = wv.op[wv.op != scan._NOP], wv.zop[wv.zop != scan._NOP]
    for role, R in ((PROVER, 1024), (VERIFY_ONL, 40), (VERIFY_PRE, 216)):
        s = scan_z64_roofline.sizes(st.program, role)
        assert sorted(_opcodes(s["gf2_gates"])) == sorted(ops.tolist())
        assert sorted(_opcodes(s["z64_gates"])) == sorted(zops.tolist())
        g = wave_gf2_work(ops, role, R, s["gf2_input_bytes"], cc.onl2, cc.pre2)
        z = wave_z64_work(zops, int(np.isin(zops, (10, 11)).sum()), role, R,
                          s["z64_input_bytes"], cc.onlz, cc.prez)
        assert scan_z64_roofline.work(s, R) == (g[0] + z[0], g[1] + z[1])


@pytest.mark.parametrize("which", ["statement", "mixed"])
def test_row_counters_equal_the_benchmarks_count(which):
    """The port's counters on its tape and executor rows (z64_tape_shares,
    w2_work) equal the benchmark's own count of the program, B2A's
    expansion counted by kkwbench."""
    if which == "statement":
        st = _statement(24, 9)
        prog, jobs = st.program, [(w, []) for w in st.witnesses(np.random.default_rng(1), 2)]
    else:
        prog, wit2, witz = mixed_program(12)
        jobs = [(wit2.tolist(), [int(v) for v in witz])] * 2
    port = _port(prog)
    proofs = port.prove_batch_chunked(jobs, _seeds(4, 2), chunk=1)
    rows = dict(port.last_timings)
    assert port.verify_many(proofs) == [True, True]
    rows.update(port.last_timings)
    for name, row in rows.items():
        phase = name.split("[")[0]
        if phase in aes_tape_z64_roofline.PHASES:
            assert row["z64_tape_shares"] == port.cc.mz
        if phase in scan_z64_roofline.PHASES:
            role = scan_z64_roofline.PHASES[phase]
            assert row["w2_work"] == scan_z64_roofline.sizes(prog, role)
    assert port.cc.mz == prog.count(Z64, INPUT) + prog.count(Z64, RANDOM) + \
        2 * prog.count(Z64, MUL) + int((prog.kind == B2A).sum())


def test_hash_work_counts_the_ports_streams(monkeypatch):
    """blake3_z64_roofline's legs are the port's: in each leg of a prove and
    a verify the port hashes streams of the lengths `lengths` gives from
    the benchmark's own count of the program, one K3 launch a stream of
    more than one chunk and one tail a leg, as many as leg_work's bounds."""
    from reverie_tpu_torch.crypto.kernels import blake3 as b3

    st = _statement(150, 5)  # every leg hashes a stream of more than one chunk
    port = _port(st.program)
    calls, legs = [], []
    stream_tail, chunk_cvs, hash_leg = b3.stream_tail, b3.chunk_cvs, b3.hash_leg

    def counted_tail(buf, T):
        calls.append(["tail", T])
        return stream_tail(buf, T)

    def counted_chunks(*a, **k):
        calls.append(["k3"])
        return chunk_cvs(*a, **k)

    def counted_leg(*a, **k):
        legs.append(calls[:])
        calls.clear()
        return hash_leg(*a, **k)

    monkeypatch.setattr(b3, "stream_tail", counted_tail)
    monkeypatch.setattr(b3, "chunk_cvs", counted_chunks)
    monkeypatch.setattr(b3, "hash_leg", counted_leg)
    jobs = [(w, []) for w in st.witnesses(np.random.default_rng(2), 1)]
    proofs = port.prove_batch_chunked(jobs, _seeds(6), chunk=1)
    assert port.verify_many(proofs) == [True]
    assert len(legs) == 3
    for role, leg in zip((PROVER, VERIFY_ONL, VERIFY_PRE), legs):
        want = blake3_z64_roofline.lengths(scan_z64_roofline.sizes(st.program, role), role)
        assert [c[1] for c in leg if c[0] == "tail"] == list(want)
        k3 = sum(c[0] == "k3" for c in leg)
        assert k3 == sum(T > 1024 for T in want) > 0
        assert len(blake3_roofline.leg_work(want, 256)) == k3 + 1


# -- tiny cells of the statement, on the CPU ------------------------------------

TINY = {"statement": "z64_mul_b2a", "args": {"n_mul": 12}, "reduced": {},
        "guarantees": {"total_reps": 256, "players": 8, "online_reps": 40},
        "reference": "kkw_z64", "reference_sample": 2}
TINY_MIXES = {"tinyz_chunked": ({"entry": "prove_batch_chunked", "statements_per_call": 3,
                                 "chunk": 2, "warmup_calls": 1}, "prove"),
              "tinyz_verify": ({"entry": "verify_many", "proofs_per_call": 2, "pool": 3,
                                "warmup_calls": 1}, "verify")}


@pytest.fixture(scope="module")
def tinyz_root(tmp_path_factory):
    """A copy of the benchmark with tiny cells of the statement, listed
    where the new cells are."""
    root = tmp_path_factory.mktemp("kkwbench_tinyz")
    shutil.copytree(specs.ROOT / "kkwbench", root / "kkwbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    (root / "kkwbench" / "configs" / "tinyz.json").write_text(json.dumps(TINY))
    spec = specs.load()
    spec["configs"].append({"name": "tinyz", "source": "test", "reduced": [], "why": "test",
                            "file": "kkwbench/configs/tinyz.json"})
    for mix, (data, kind) in TINY_MIXES.items():
        (root / "kkwbench" / "traffic" / f"{mix}.json").write_text(json.dumps(data))
        name = f"tinyz.{mix}"
        spec["workloads"].append({"name": name, "config": "tinyz", "traffic": mix, "chips": 1,
                                  "why": "test"})
        cell = CELLS[0] if kind == "prove" else CELLS[1]
        for m in spec["end_to_end"] + spec["per_layer"]:
            if cell in m.get("workloads", ()):
                m["workloads"].append(name)
    (Path(root) / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.mark.parametrize("mix", TINY_MIXES)
def test_tiny_cells_are_correct_and_report(mix, tinyz_root):
    """A traced tiny run on the CPU comes out correct and reports the span
    reader; the rooflines, which need the card's trace, read nothing."""
    from kkwbench import run

    kind = TINY_MIXES[mix][1]
    result, lines = run.run(f"tinyz.{mix}", 2**31 + 77, 0.2, True, root=tinyz_root, device="cpu")
    assert result["correct"] is True, lines
    m = result["metrics"]
    assert m[f"z64_host_ms_per_proof.{kind}"]["value"] > 0
    assert not {f"{name}.{kind}" for name in ("aes_tape_z64_roofline", "scan_z64_roofline",
                                              "blake3_z64_roofline")} & set(m)
    assert m[f"host_busy_ms_per_proof.{kind}"]["value"] > 0


@pytest.mark.parametrize("mix", TINY_MIXES)
def test_tiny_control_is_not_correct(mix, tinyz_root):
    from kkwbench import control, run

    result, lines = run.run(f"tinyz.{mix}", 2**31 + 78, 0.1, False, root=tinyz_root,
                            device="cpu", make=control.make)
    assert result["correct"] is False, lines
