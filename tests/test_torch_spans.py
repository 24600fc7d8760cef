"""The port's own spans (host.PhaseTimer): each phase row's child spans,
wait_ms, the witness and check rows, the profiler's clock, and the
record_function ranges the program enters only while a profiler records,
on TorchKKW over the CPU at a small GF(2) circuit.  No timing is asserted:
the CPU is noisy."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from reverie_tpu_torch import TorchKKW
from reverie_tpu_torch.backend import host
from reverie_tpu_torch.circuit.builders import mul_bench_circuit
from torch_threads import one_thread  # noqa: F401  (autouse)

#: each phase's children in order, on one device (the table of host.py's
#: TorchKKW docstring); a phase not named here has none
CHILDREN = {"tape_gf2": ["round_keys"], "tape_z64": ["round_keys"],
            "challenge": ["wait", "commit", "extract"],
            "extract_pull": ["wait", "gather", "assemble"],
            "check": [], "onl_inject": ["parse", "upload"],
            "onl_tape": ["round_keys", "round_keys"],
            "pre_tape": ["expand_seeds", "round_keys", "round_keys"],
            "finish": ["wait", "wait", "check"]}
PROVE_PHASES = ["witness", "expand_seeds", "tape_gf2", "tape_z64", "execute", "hash",
                "challenge", "extract_pull"]
VERIFY_PHASES = ["check", "onl_inject", "onl_tape", "onl_exec", "onl_hash", "pre_tape",
                 "pre_exec", "pre_hash", "finish"]
#: entry call -> (the phases of each chunk or proof, their count)
CALLS = {"prove_many": (PROVE_PHASES, 3), "prove_batch_chunked": (PROVE_PHASES, 3),
         "verify_many": (VERIFY_PHASES, 2)}


@pytest.fixture(scope="module")
def port():
    """A TorchKKW of 8 ANDs on the CPU, its witness and 5 rep seeds, and
    two proofs to verify; warm, so that a call under a profiler pays no
    first-use cost."""
    torch.set_num_threads(1)
    prog, w2, wz = mul_bench_circuit(8)
    kkw = TorchKKW(prog, device=torch.device("cpu"))
    seeds = np.random.RandomState(21).randint(0, 256, (5, 256, 16), dtype=np.uint8)
    proofs = kkw.prove_many([(w2, wz)] * 2, seeds[:2])
    assert kkw.verify_many(proofs) == [True, True]
    return kkw, (w2, wz), seeds, proofs


def call(port, entry):
    kkw, job, seeds, proofs = port
    if entry == "prove_many":
        return kkw.prove_many([job] * 3, seeds[:3])
    if entry == "prove_batch_chunked":
        return kkw.prove_batch_chunked([job] * 5, seeds, chunk=2)
    return kkw.verify_many(proofs)


def base(name):
    return name.split("[")[0]


@pytest.fixture(scope="module")
def plain(port):
    """Each entry's answers and last_timings with no profiler, counting
    the record_function ranges entered meanwhile."""
    entered = []
    orig = torch.autograd.profiler.record_function.__enter__

    def counted(self):
        entered.append(self.name)
        return orig(self)

    torch.autograd.profiler.record_function.__enter__ = counted
    try:
        out = {e: (call(port, e), port[0].last_timings) for e in CALLS}
    finally:
        torch.autograd.profiler.record_function.__enter__ = orig
    return out, entered


@pytest.fixture(scope="module")
def traced(port):
    """Each entry's answers, last_timings and the profiler's raw events,
    the call run once in the schedule's warm-up and recorded the second
    time."""
    out = {}
    for e in CALLS:
        with profile(activities=[ProfilerActivity.CPU],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            call(port, e)
            prof.step()
            answers = call(port, e)
            timings = port[0].last_timings
            prof.step()
        out[e] = (answers, timings, prof.profiler.kineto_results.events())
    return out


@pytest.mark.parametrize("entry", CALLS)
def test_rows_and_children(plain, entry):
    """Every phase of each chunk or proof has a row, in order, the rows do
    not overlap, each row's children lie inside it in order without
    overlapping and are the phase's own, and wait_ms is the sum of its
    "wait" children; the existing fields are still there."""
    phases, n = CALLS[entry]
    timings = plain[0][entry][1]
    assert sorted(timings) == sorted(f"{p}[{i}]" for p in phases for i in range(n))
    rows = sorted(timings.items(), key=lambda kv: kv[1]["start_ns"])
    for (_, a), (_, b) in zip(rows, rows[1:]):
        assert a["end_ns"] <= b["start_ns"]
    for name, row in rows:
        assert {"host_ms", "device_ms", "launches"} <= set(row) and row["device_ms"] is None
        assert row["host_ms"] == pytest.approx((row["end_ns"] - row["start_ns"]) / 1e6)
        assert [c for c, _, _ in row["spans"]] == CHILDREN.get(base(name), [])
        at = row["start_ns"]
        for _, s, e in row["spans"]:
            assert at <= s <= e <= row["end_ns"]
            at = e
        waits = sum(e - s for c, s, e in row["spans"] if c == "wait") / 1e6
        assert row["wait_ms"] == pytest.approx(waits)
    for i in range(n):
        assert [base(nm) for nm, _ in rows if nm.endswith(f"[{i}]")] == phases


def test_no_range_without_a_profiler(plain):
    """With no profiler recording, the program enters no record_function."""
    assert plain[1] == []


def test_spans_outside_a_phase_record_nothing():
    timer = host.PhaseTimer([torch.device("cpu")])
    with host.span("wait"), timer.span("wait"):
        pass
    with timer.phase("p[0]"):
        with timer.span("a"), host.span("b"):  # b inside a: part of a
            pass
        with host.span("c"):
            pass
    row = timer.report()["p[0]"]
    assert [c for c, _, _ in row["spans"]] == ["a", "c"] and row["wait_ms"] == 0


@pytest.mark.parametrize("entry", CALLS)
def test_ranges_under_a_profiler(plain, traced, entry):
    """Under a CPU profiler: the entry's root range, "<phase>[i]" and
    "<phase>.<child>[i]" for every row and child, and the levelized
    executor's "executor.gf2.<KIND>" steps; each row's start_ns within 1 ms
    of its range's start_ns() (one clock); the same answers as without."""
    answers, timings, raw = traced[entry]
    ranges = {}
    for e in raw:
        if e.is_user_annotation() and e.device_type() == torch.autograd.DeviceType.CPU:
            ranges.setdefault(e.name(), []).append(e.start_ns())
    assert entry in ranges
    for name, row in timings.items():
        assert len(ranges[name]) == 1 and abs(ranges[name][0] - row["start_ns"]) < 1e6
        phase, tag = base(name), name[len(base(name)):]
        for child, s, _ in row["spans"]:
            assert any(abs(t - s) < 1e6 for t in ranges[f"{phase}.{child}{tag}"])
    steps = {n for n in ranges if n.startswith("executor.")}
    assert {"executor.gf2.INPUT", "executor.gf2.MUL", "executor.assemble"} <= steps
    want = plain[0][entry][0]
    if entry == "verify_many":
        assert answers == want == [True, True]
    else:
        assert [p.to_bytes() for p in answers] == [p.to_bytes() for p in want]
