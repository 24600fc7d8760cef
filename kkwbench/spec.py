"""Where the benchmark finds things: BENCHMARK.json at the checkout's root,
and under kkwbench/ one file a configuration, traffic mix, statement
builder, plain reference, traffic entry and per-layer metric, each found by
the name BENCHMARK.json, a configuration's file or a mix's file gives.
Adding one is adding its file."""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

#: the checkout's root: the directory that holds BENCHMARK.json and kkwbench/
ROOT = Path(__file__).resolve().parent.parent


def load(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json names no {what} {name!r}")


def cell(spec: dict, name: str) -> dict:
    return _named(spec["workloads"], name, "workload")


def config(spec: dict, name: str, root: Path = ROOT) -> dict:
    """A configuration's file, with its BENCHMARK.json entry under "entry"."""
    entry = _named(spec["configs"], name, "config")
    data = json.loads((Path(root) / entry["file"]).read_text())
    return dict(data, entry=entry)


def traffic(name: str, root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "kkwbench" / "traffic" / f"{name}.json").read_text())


_LOADED: dict = {}


def _module(path: Path) -> ModuleType:
    """The module in kkwbench/<dir>/<stem>.py, loaded once a path: the
    package's own as kkwbench.<dir>.<stem>; one in another checkout's copy
    under a name of its own in the package kkwbench.<dir>, so that its
    relative imports resolve there too."""
    path = Path(path).resolve()
    if path not in _LOADED:
        package = f"kkwbench.{path.parent.name}"
        if path.parent == ROOT / "kkwbench" / path.parent.name:
            _LOADED[path] = importlib.import_module(f"{package}.{path.stem}")
        else:
            spec = importlib.util.spec_from_file_location(
                f"{package}._found{len(_LOADED)}_{path.stem}", path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[spec.name] = mod
            spec.loader.exec_module(mod)
            _LOADED[path] = mod
    return _LOADED[path]


def statement(name: str, root: Path = ROOT) -> ModuleType:
    return _module(Path(root) / "kkwbench" / "statements" / f"{name}.py")


def reference(name: str, root: Path = ROOT) -> ModuleType:
    """A configuration's plain reference, reference/<name>.py: `plan(program,
    device)` and `prove(program, witnesses, seeds, device, total_reps,
    online_reps, plan) -> [proof bytes]`."""
    return _module(Path(root) / "kkwbench" / "reference" / f"{name}.py")


def entry(name: str, root: Path = ROOT) -> ModuleType:
    """A traffic entry that driver.py does not hold, traffic/<name>.py:
    `KIND` ("prove" or "verify") and `call(mix, i) -> driver.Call`."""
    return _module(Path(root) / "kkwbench" / "traffic" / f"{name}.py")


def metric(name: str, root: Path = ROOT) -> tuple:
    """(the reader module of a per-layer metric, the part of its name after
    the reader's): metrics/<name>.py, else metrics/<name up to its first
    dot>.py reading the part after the dot ("prove", "verify")."""
    base = Path(root) / "kkwbench" / "metrics"
    if (base / f"{name}.py").exists():
        return _module(base / f"{name}.py"), ""
    head, _, part = name.partition(".")
    return _module(base / f"{head}.py"), part


def reports(spec: dict, metric_entry: dict, cell_name: str, moves_metric: dict) -> bool:
    """Whether a cell reports a metric: one the metric lists under
    "workloads", else every cell that reports the end-to-end metric it
    moves."""
    if "workloads" in metric_entry:
        return cell_name in metric_entry["workloads"]
    return "workloads" not in moves_metric or cell_name in moves_metric["workloads"]
