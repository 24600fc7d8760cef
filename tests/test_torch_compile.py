"""The port's circuit compile on the host C passes (compile_native) against
its plain twin, the Python compile of circuit/compile.py: the same
CompiledCircuit and Segments field for field (every level's keys and
columns in the same order, every array of the same dtype and values), on
the fuzz programs of tests/test_fuzz_differential.py, the bench, wide, z64,
B2A and deep circuits and the SHA-256 statement; the bench builders'
shared op objects; and make_system's route to streaming, which compiles
each op once and sizes each segment by a compiled one's device_footprint.
Programs from reverie_tpu cross as bincode bytes.  Tolerance 0."""

import dataclasses

import numpy as np
import pytest
import torch

from reverie_tpu.circuit import builders as jbuilders
from reverie_tpu.circuit import dumps_program
from reverie_tpu_torch import StreamingKKW, TorchKKW, make_system
from reverie_tpu_torch.backend import host
from reverie_tpu_torch.backend.host import device_footprint, lower_footprint
from reverie_tpu_torch.circuit import CombineOp, Gate, Op, builders, load_program
from reverie_tpu_torch.circuit import dumps_program as torch_dumps
from reverie_tpu_torch.circuit import compile_native as native
from reverie_tpu_torch.circuit.compile import (
    CompiledCircuit,
    Segment,
    compile_program,
    compile_program_plain,
    compile_segments,
    compile_segments_plain,
)
from reverie_tpu_torch.parity import sha256_bench

from test_fuzz_differential import random_program
from test_torch_z64_prove import z64_kinds_circuit
from torch_threads import one_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")


def fuzz(seed: int, n: int = 120):
    return lambda: load_program(dumps_program(random_program(seed, n)[0]))


PROGRAMS = {
    **{f"fuzz{s}": fuzz(s) for s in (11, 23, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51)},
    "mul_bench": lambda: builders.mul_bench_circuit(50)[0],
    "wide_and": lambda: builders.wide_and_circuit(300, width=32, seed=3)[0],
    "z64_mul_bench": lambda: builders.z64_mul_bench_circuit(30)[0],
    "z64_kinds": lambda: z64_kinds_circuit()[0],
    "mixed_b2a": lambda: builders.mixed_b2a_circuit()[0],
    "deep_b2a": lambda: builders.deep_b2a_circuit(40)[0],
    "z64_all_ops": lambda: builders.z64_all_ops_circuit(40)[0],
    "z64_chains": lambda: builders.z64_chains_circuit(4, 20)[0],
    "size_hints": lambda: ([CombineOp.size_hint(3, 9)] + builders.mul_bench_circuit(9)[0]
                           + [CombineOp.size_hint(1, 1)] * 4),
    "empty": lambda: [],
}


def assert_circuits_equal(got: CompiledCircuit, want: CompiledCircuit) -> None:
    for f in dataclasses.fields(CompiledCircuit):
        if f.name == "wave_tables":
            continue
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "levels":
            assert len(a) == len(b)
            for la, lb in zip(a, b):
                assert list(la) == list(lb)  # keys in the same order
                for key in la:
                    assert list(la[key]) == list(lb[key])  # columns in the same order
                    for name, col in la[key].items():
                        ref = lb[key][name]
                        assert col.dtype == ref.dtype and col.shape == ref.shape, (key, name)
                        assert np.array_equal(col, ref), (key, name)
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert type(a) is type(b) and a == b, f.name


def assert_segments_equal(got, want) -> None:
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in dataclasses.fields(Segment):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if f.name == "cc":
                assert_circuits_equal(x, y)
            elif isinstance(y, np.ndarray):
                assert x.dtype == y.dtype and np.array_equal(x, y), f.name
            else:
                assert x == y, f.name


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_native_compile_equals_plain(name):
    prog = PROGRAMS[name]()
    assert_circuits_equal(compile_program(prog), compile_program_plain(prog))


def test_native_compile_of_the_sha256_statement():
    prog = sha256_bench()[0]
    cc = compile_program(prog)
    assert cc.depth == 5198
    assert_circuits_equal(cc, compile_program_plain(prog))


@pytest.mark.parametrize("name", ["fuzz11", "fuzz40", "mixed_b2a", "z64_kinds", "wide_and"])
def test_native_compile_with_carries_equals_plain(name):
    """compile_program's carry_in / carry_inz and out_val_map(z): the
    carried wires take values 1..k, read or not, and the final maps agree."""
    prog = PROGRAMS[name]()
    got, want = ({}, {}), ({}, {})
    kw = dict(carry_in=[0, 2, 5, 1000], carry_inz=[1, 3])
    assert_circuits_equal(
        compile_program(prog, out_val_map=got[0], out_val_mapz=got[1], **kw),
        compile_program_plain(prog, out_val_map=want[0], out_val_mapz=want[1], **kw))
    assert got == want


@pytest.mark.parametrize("name, seg_ops", [
    ("fuzz11", 1), ("fuzz23", 7), ("fuzz40", 13), ("fuzz44", 64), ("fuzz51", 5),
    ("mixed_b2a", 3), ("mixed_b2a", 65), ("deep_b2a", 17), ("z64_kinds", 4),
    ("z64_chains", 9), ("wide_and", 50), ("size_hints", 3), ("mul_bench", 8), ("empty", 4)])
def test_native_segments_equal_plain(name, seg_ops):
    prog = PROGRAMS[name]()
    assert_segments_equal(compile_segments(prog, seg_ops), compile_segments_plain(prog, seg_ops))


def test_native_segments_of_the_sha256_statement():
    prog = sha256_bench()[0]
    assert_segments_equal(compile_segments(prog, 40_000), compile_segments_plain(prog, 40_000))


def test_segment_compiler_takes_any_lengths():
    """SegmentCompiler at uneven lengths: each segment's circuit equals the
    plain compile of its ops with its carries, and each carry-in's source
    row holds that wire."""
    prog = PROGRAMS["fuzz42"]()
    sc = native.SegmentCompiler(prog)
    bounds, lo = [], 0
    for k in (5, 1, 30, 2, 17, 9, 40, 100):
        hi = min(len(prog), lo + k)
        sc.add(hi)
        bounds.append((lo, hi))
        lo = hi
        if lo == len(prog):
            break
    got = sc.finish()
    assert [hi - lo for lo, hi in bounds][:3] == [5, 1, 30]
    for seg, (lo, hi) in zip(got, bounds):
        ref = compile_program_plain(prog[lo:hi], carry_in=seg.carry_in, carry_inz=seg.carry_inz)
        assert_circuits_equal(seg.cc, ref)
        for w, (src, row) in zip(seg.carry_in, seg.carry_src):
            assert got[src].carry_out[row] == w
        for w, (src, row) in zip(seg.carry_inz, seg.carry_srcz):
            assert got[src].carry_outz[row] == w


def test_analyze_counts_equal_the_compiled_circuit():
    for name in ("fuzz11", "mixed_b2a", "z64_kinds", "deep_b2a", "size_hints", "empty"):
        prog = PROGRAMS[name]()
        cc, counts = compile_program(prog), native.analyze(prog)
        for f in ("m2", "mz", "onl2", "pre2", "onlz", "prez", "n_wit2", "n_witz", "n_vals2",
                  "n_valsz", "n_inputs2", "n_corrs2", "n_recons2", "n_inputsz", "n_corrsz",
                  "n_reconsz", "depth"):
            assert getattr(counts, f) == getattr(cc, f), (name, f)


@pytest.mark.parametrize("name", ["mul_bench", "wide_and", "z64_mul_bench", "mixed_b2a",
                                  "deep_b2a", "z64_all_ops", "fuzz42"])
def test_lower_footprint_is_a_lower_bound(name):
    prog = PROGRAMS[name]()
    cc = compile_program(prog)
    for R in (256, 64):
        assert lower_footprint(native.analyze(prog), R) <= device_footprint(cc, R)


def test_lower_footprint_is_tight_on_the_bench_circuits():
    """The bound is what make_system streams by without a compile: on the
    bench circuits it is within a few percent of the footprint."""
    for prog in (builders.mul_bench_circuit(5_000)[0], builders.z64_mul_bench_circuit(500)[0]):
        fp = device_footprint(compile_program(prog), 256)
        assert 0.8 * fp <= lower_footprint(native.analyze(prog), 256) <= fp


# -- the builders' shared op objects ------------------------------------------

FRESH = {
    "mul_bench_circuit": lambda n: [CombineOp.gf2(Gate(Op.INPUT, dst=0)),
                                    CombineOp.gf2(Gate(Op.INPUT, dst=1))]
    + [CombineOp.gf2(Gate(Op.MUL, dst=2, src1=0, src2=1)) for _ in range(n)],
    "z64_mul_bench_circuit": lambda n: [CombineOp.z64(Gate(Op.INPUT, dst=0)),
                                        CombineOp.z64(Gate(Op.INPUT, dst=1))]
    + [CombineOp.z64(Gate(Op.MUL, dst=2, src1=0, src2=1)) for _ in range(n)],
}


@pytest.mark.parametrize("name", list(FRESH))
def test_bench_builders_share_equal_ops(name):
    """The bench builders put one op object at every equal position: the
    program equals one of fresh objects, its bincode bytes equal
    reverie_tpu's builder's, and its distinct objects are three."""
    prog, w2, wz = getattr(builders, name)(1000)
    assert prog == FRESH[name](1000)
    jprog, jw2, jwz = getattr(jbuilders, name)(1000)
    assert (w2, wz) == (jw2, jwz)
    assert torch_dumps(prog) == dumps_program(jprog)
    assert load_program(dumps_program(jprog)) == prog
    objects, code = native.distinct_ops(prog)
    assert len(objects) == 3 and code.shape == (len(prog),)
    assert [objects[c] for c in code.tolist()] == prog


@pytest.mark.parametrize("name, make", [
    ("z64_chain_circuit", lambda m: m.z64_chain_circuit(30)),
    ("deep_b2a_circuit", lambda m: m.deep_b2a_circuit(30)),
])
def test_chain_builders_equal_reverie_tpu(name, make):
    """The chain builders share their repeated ops too; their programs'
    bincode equals the reference statements' (reverie_tpu's scan tests
    build these inline, so the check is against fresh objects)."""
    prog = make(builders)[0]
    fresh = [dataclasses.replace(op) for op in prog]
    assert prog == fresh and len(native.distinct_ops(prog)[0]) < len(prog)
    assert_circuits_equal(compile_program(prog), compile_program_plain(fresh))


def test_check_program_refuses_reverie_tpu_ops_in_a_shared_run():
    prog = builders.mul_bench_circuit(100)[0]
    foreign = jbuilders.mul_bench_circuit(1)[0][-1]
    with pytest.raises(TypeError, match="reverie_tpu_torch"):
        host.check_program(prog[:50] + [foreign] * 3 + prog[50:])


# -- make_system's route to streaming -----------------------------------------


def count_compiled_ops(monkeypatch) -> list:
    """Record (lo, hi, emit) of every C compile pass."""
    calls = []
    real = native._State.run

    def run(self, lo, hi, carry2=(), carryz=(), emit=True):
        calls.append((lo, hi, emit))
        return real(self, lo, hi, carry2, carryz, emit)

    monkeypatch.setattr(native._State, "run", run)
    return calls


@pytest.mark.parametrize("make", [lambda: builders.mul_bench_circuit(400_000),
                                  lambda: builders.z64_mul_bench_circuit(5_000),
                                  lambda: builders.wide_and_circuit(150_000, width=64, seed=1)],
                         ids=["gf2", "z64", "wide_and"])
def test_make_system_compiles_each_op_once_when_streaming(make, monkeypatch):
    """Past the budget by its lower bound, make_system compiles no whole
    circuit: each op once, in segments whose device_footprint is about an
    eighth of the budget (at most 1.1x an eighth, and none but the first
    and the last under half of it).  The circuits are large enough that a
    segment's fixed device bytes (the hash's transients, 3.4 MB at R =
    256) are small beside an eighth of the budget."""
    prog = make()[0]
    fp = device_footprint(compile_program(prog), 256)
    calls = count_compiled_ops(monkeypatch)
    budget = fp // 3
    sk = make_system(prog, device=CPU, hbm_budget_bytes=budget)
    assert isinstance(sk, StreamingKKW)
    compiled = [(lo, hi) for lo, hi, emit in calls if emit]
    assert sum(hi - lo for lo, hi in compiled) == len(prog)
    assert [lo for lo, _ in compiled] == [0] + [hi for _, hi in compiled[:-1]]
    fps = [device_footprint(s.cc, 256) for s in sk.segments]
    assert max(fps) <= 1.1 * budget / 8
    assert min(fps[1:-1]) >= budget / 8 / 2
    assert 8 <= len(sk.segments) <= 40


def test_make_system_compiles_once_when_the_circuit_fits(monkeypatch):
    prog, w2, wz = builders.mul_bench_circuit(200)
    calls = count_compiled_ops(monkeypatch)
    kkw = make_system(prog, device=CPU, hbm_budget_bytes=1 << 40)
    assert isinstance(kkw, TorchKKW)
    assert [(lo, hi) for lo, hi, emit in calls if emit] == [(0, len(prog))]
