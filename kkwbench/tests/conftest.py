"""A copy of the benchmark with tiny cells of its own, for runs on the CPU,
and the `cuda` marker's skip."""

from __future__ import annotations

import json
import shutil

import pytest

from kkwbench import spec as specs

TINY_CONFIG = {"statement": "mul_bench", "args": {"n_mul": 16}, "reduced": {},
               "guarantees": {"total_reps": 256, "players": 8, "online_reps": 40},
               "reference": "kkw", "reference_sample": 12}
#: one mix an entry, small enough that the sample takes (nearly) every proof
TINY_MIXES = {"tiny_chunked": {"entry": "prove_batch_chunked", "statements_per_call": 5,
                               "chunk": 2, "warmup_calls": 1},
              "tiny_many": {"entry": "prove_many", "statements_per_call": 3, "warmup_calls": 1},
              "tiny_verify": {"entry": "verify_many", "proofs_per_call": 3, "pool": 4,
                              "warmup_calls": 1}}


def add_tiny(root) -> None:
    """Copy kkwbench and BENCHMARK.json under root, with the tiny cells
    tiny.<mix> added as new files and entries."""
    shutil.copytree(specs.ROOT / "kkwbench", root / "kkwbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    (root / "kkwbench" / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    spec = specs.load()
    spec["configs"].append({"name": "tiny", "source": "test", "reduced": [], "why": "test",
                            "file": "kkwbench/configs/tiny.json"})
    for mix, data in TINY_MIXES.items():
        (root / "kkwbench" / "traffic" / f"{mix}.json").write_text(json.dumps(data))
        name = f"tiny.{mix}"
        spec["workloads"].append({"name": name, "config": "tiny", "traffic": mix, "chips": 1,
                                  "why": "test"})
        kind = "verify" if data["entry"] == "verify_many" else "prove"
        for m in spec["end_to_end"] + spec["per_layer"]:
            rate = "proofs_per_s" if kind == "prove" else "verifies_per_s"
            if "workloads" in m and (m["name"].endswith("." + kind) or m["name"] == rate):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


@pytest.fixture(scope="session", autouse=True)
def one_thread():
    """One torch thread a test process: the CPU runs here are many small
    ops, which threads only slow, and the test workers share the cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("kkwbench_tiny")
    add_tiny(root)
    return root


@pytest.fixture
def card():
    """The CUDA device, or a skip without one (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
