"""No module of the benchmark imports jax, jaxlib, flax or the JAX package
reverie_tpu (compared by the whole top-level name: reverie_tpu_torch is
the port), and the plain reference imports nothing of the port either."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

KB = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "reverie_tpu"}
MODULES = sorted(p for p in KB.rglob("*.py") if ".cache" not in p.parts)


def imported(path: Path) -> set:
    """Top-level names of every import in a module (absolute ones)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(KB)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((KB / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = imported(path)
    assert "reverie_tpu_torch" not in names and not names & FORBIDDEN
    # within kkwbench it takes only the program's columns
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("kkwbench"):
            assert node.module in ("kkwbench.program",), node.module


def test_run_refuses_a_loaded_jax(monkeypatch):
    import sys
    import types

    from kkwbench import run

    assert run.loaded_jax() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", types.ModuleType("jaxlib.xla"))
    monkeypatch.setitem(sys.modules, "reverie_tpu", types.ModuleType("reverie_tpu"))
    assert run.loaded_jax() == ["jaxlib.xla", "reverie_tpu"]
