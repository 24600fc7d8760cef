"""The readers of the port's child spans (metrics/host_wait_ms_per_proof,
host_busy_ms_per_proof, assemble_ms_per_proof) on made-up windows, and on
a traced tiny run on the CPU; nothing where a row lacks a field, as in a
program without the spans."""

from __future__ import annotations

import pytest

from kkwbench import spec as specs
from kkwbench.driver import Call
from kkwbench.run import Window


def row(host_ms, wait_ms=None, spans=None):
    r = {"host_ms": host_ms, "device_ms": 1.0, "launches": {}}
    if wait_ms is not None:
        r.update(wait_ms=wait_ms, spans=spans or [], start_ns=0, end_ns=int(host_ms * 1e6))
    return r


def window(kind, timings, done=4):
    calls = [Call(0.0, 1.0, 2, 2, [], t) for t in timings]
    return Window(kind, calls, 1.0, done, 0.1, None, None, None, None)


MS = 1_000_000  # ns
PROVE = [{"challenge[0]": row(5.0, 2.0, [["wait", 0, 2 * MS], ["commit", 2 * MS, 4 * MS]]),
          "extract_pull[0]": row(7.0, 1.0, [["wait", 0, MS], ["gather", MS, 3 * MS],
                                            ["assemble", 3 * MS, 7 * MS]])},
         {"witness": row(1.0, 0.0), "extract_pull": row(3.0, 0.5, [["assemble", 0, 2 * MS]])}]
VERIFY = [{"onl_inject[0]": row(6.0, 0.0, [["parse", 0, MS], ["upload", MS, 5 * MS]]),
           "finish[0]": row(2.0, 1.5, [["wait", 0, MS // 2], ["wait", MS // 2, 3 * MS // 2]])}]
#: metric -> (its value on PROVE, on VERIFY), a proof of 4
WANT = {"host_wait_ms_per_proof.prove": ((2.0 + 1.0 + 0.0 + 0.5) / 4, None),
        "host_wait_ms_per_proof.verify": (None, 1.5 / 4),
        "host_busy_ms_per_proof.prove": ((3.0 + 6.0 + 1.0 + 2.5) / 4, None),
        "host_busy_ms_per_proof.verify": (None, (6.0 + 0.5) / 4),
        "assemble_ms_per_proof.prove": ((2.0 + 4.0 + 2.0) / 4, None)}


def read(name, w):
    reader, part = specs.metric(name)
    return reader.read(w, part)


@pytest.mark.parametrize("name", WANT)
def test_reads_the_spans(name):
    on_prove, on_verify = WANT[name]
    for timings, kind, want in ((PROVE, "prove", on_prove), (VERIFY, "verify", on_verify)):
        got = read(name, window(kind, timings))
        assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("name", WANT)
def test_nothing_without_the_spans(name):
    """A program whose rows lack wait_ms and spans (the parent's), or a
    window that returned nothing, reads nothing."""
    kind = name.rsplit(".", 1)[1]
    assert read(name, window(kind, [{"challenge[0]": row(5.0), "extract_pull[0]": row(7.0)},
                                    {"finish": row(1.0)}])) is None
    timings = PROVE if kind == "prove" else VERIFY
    assert read(name, window(kind, timings, done=0)) is None


@pytest.mark.parametrize("mix", ["tiny_chunked", "tiny_many", "tiny_verify"])
def test_traced_tiny_run_reports_them(mix, tiny_root):
    """A traced tiny run on the CPU reports each reader of its kind."""
    from kkwbench import run

    result, _ = run.run(f"tiny.{mix}", 2**31 + 21, 0.2, True, root=tiny_root, device="cpu")
    assert result["correct"] is True
    kind = "verify" if mix == "tiny_verify" else "prove"
    m = result["metrics"]
    names = [n for n in WANT if n.endswith("." + kind)]
    assert names and all(m[n]["value"] >= 0 for n in names)
    assert m[f"host_busy_ms_per_proof.{kind}"]["value"] > 0
