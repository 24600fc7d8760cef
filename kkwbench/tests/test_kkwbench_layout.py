"""BENCHMARK.json against the benchmark's contract and its files: every
cell, configuration, traffic mix, statement and per-layer metric resolves
to its file by name, and new ones are picked up as new files alone."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from kkwbench import spec as specs

ROOT = specs.ROOT
SPEC = specs.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level():
    assert set(SPEC) == KEYS
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert SPEC["paths"] == ["kkwbench"]
    assert len(SPEC["command"]) <= 32
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config_resolves(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and all(NAME.match(k) for k in entry["reduced"])
    assert entry["file"].startswith("kkwbench/")
    cfg = specs.config(SPEC, entry["name"])
    g = cfg["guarantees"]
    assert (g["total_reps"], g["players"], g["online_reps"]) == (256, 8, 40)
    assert hasattr(specs.statement(cfg["statement"]), "make")
    ref = specs.reference(cfg["reference"])
    assert callable(ref.plan) and callable(ref.prove)
    assert set(cfg) <= {"statement", "args", "source", "reduced", "assumed", "guarantees",
                        "reference", "reference_sample", "hbm_budget_bytes", "entry"}
    assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
    assert any(w["config"] == entry["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda e: e["name"])
def test_cell_resolves(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] == 1 and 1 <= len(cell["why"]) <= 200
    specs.config(SPEC, cell["config"])
    mix = specs.traffic(cell["traffic"])
    assert mix["entry"] in ("prove_batch_chunked", "prove_many", "verify_many") or \
        specs.entry(mix["entry"]).KIND in ("prove", "verify")
    e2e = [m for m in SPEC["end_to_end"] if "workloads" not in m or cell["name"] in m["workloads"]]
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    moves = {m["name"]: m for m in SPEC["end_to_end"]}
    assert any(specs.reports(SPEC, m, cell["name"], moves[m["moves"]]) for m in SPEC["per_layer"])


@pytest.mark.parametrize("m", SPEC["end_to_end"] + SPEC["per_layer"], ids=lambda e: e["name"])
def test_metric_resolves(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    if "bound" in m:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        return
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    moved = {e["name"]: e for e in SPEC["end_to_end"]}[m["moves"]]
    assert set(m.get("workloads", cells)) <= set(moved.get("workloads", cells))
    reader, part = specs.metric(m["name"])
    assert callable(reader.read) and part in ("", "prove", "verify")


def test_names_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_new_files_are_picked_up(tmp_path):
    """A configuration (with a plain reference of its own and a device
    memory budget), a traffic mix (with an entry of its own) and a
    per-layer metric, added to a copy of the benchmark as new files only,
    run, are used, and the metric is reported."""
    shutil.copytree(ROOT / "kkwbench", tmp_path / "kkwbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    kb = tmp_path / "kkwbench"
    (kb / "configs" / "tiny_mul.json").write_text(json.dumps({
        "statement": "mul_bench", "args": {"n_mul": 16}, "reduced": {},
        "guarantees": {"total_reps": 256, "players": 8, "online_reps": 40},
        "reference": "counted", "reference_sample": 1, "hbm_budget_bytes": 1 << 30}))
    (kb / "reference" / "counted.py").write_text(
        "from . import kkw\n"
        "PROVED = []\n"
        "plan = kkw.plan\n"
        "def prove(*args):\n"
        "    out = kkw.prove(*args)\n"
        "    PROVED.append(len(out))\n"
        "    return out\n")
    (kb / "traffic" / "tiny_pairs.json").write_text(json.dumps(
        {"entry": "prove_pairs", "statements_per_call": 2, "warmup_calls": 1}))
    (kb / "traffic" / "prove_pairs.py").write_text(
        "import time\n"
        "import numpy as np\n"
        "from kkwbench.driver import PROVER, Call\n"
        "KIND = 'prove'\n"
        "CALLS = []\n"
        "def call(mix, i):\n"
        "    jobs = mix.jobs(1 if i < 0 else 2, abs(i), int(mix.t['statements_per_call']))\n"
        "    t0 = time.perf_counter()\n"
        "    out = [mix.system.prove_many([(j.witness, [])], j.seeds[None])[0] for j in jobs]\n"
        "    CALLS.append(i)\n"
        "    if i >= 0:\n"
        "        mix.offer(jobs, out)\n"
        "    return Call(t0, time.perf_counter(), len(jobs), len(out),\n"
        "                [(PROVER, mix.R)] * len(jobs), dict(mix.system.last_timings))\n")
    (kb / "metrics" / "calls_in_window.py").write_text(
        "def read(window, part):\n    return float(len(window.calls))\n")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_mul", "source": "test", "reduced": [], "why": "test",
                            "file": "kkwbench/configs/tiny_mul.json"})
    spec["workloads"].append({"name": "tiny_mul.pairs", "config": "tiny_mul",
                              "traffic": "tiny_pairs", "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] == "proofs_per_s":
            m["workloads"].append("tiny_mul.pairs")
    spec["per_layer"].append({"name": "calls_in_window", "unit": "calls", "better": "higher",
                              "source": "host_clock", "layer": "test", "moves": "proofs_per_s",
                              "workloads": ["tiny_mul.pairs"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    from kkwbench import run

    result, _ = run.run("tiny_mul.pairs", 2**31 + 99, 0.2, True, root=tmp_path, device="cpu")
    assert result["correct"] is True
    assert result["metrics"]["calls_in_window"]["value"] >= 1
    assert "make_system_s" in result["metrics"]
    assert specs.reference("counted", tmp_path).PROVED == [1]
    calls = specs.entry("prove_pairs", tmp_path).CALLS
    assert calls[0] == -1 and 0 in calls
