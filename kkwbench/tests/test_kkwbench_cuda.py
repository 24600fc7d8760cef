"""On the card (the `cuda` marker; skipped without one): every cell of
BENCHMARK.json at its own size, a short window of the port that comes out
correct, of the control (kkwbench.control) that does not, and of the port
with each fault of test_kkwbench_faults.py planted underneath, which does
not either.

    python -m pytest kkwbench/tests -o addopts="" -q -m cuda
"""

from __future__ import annotations

import pytest

from kkwbench import control, driver, run, spec as specs
from kkwbench.tests.test_kkwbench_faults import PROVE_FAULTS, VERIFY_FAULTS, make_faulty

SPEC = specs.load()
CELLS = [w["name"] for w in SPEC["workloads"]]


def _kind(cell: str) -> tuple:
    """(the mix's kind, its chunk, the configuration's device budget)."""
    w = specs.cell(SPEC, cell)
    mix = specs.traffic(w["traffic"])
    return (driver.KIND[mix["entry"]], int(mix.get("chunk", 1)),
            specs.config(SPEC, w["config"]).get("hbm_budget_bytes"))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(cell, card):
    result, lines = run.run(cell, 2**31 + 11, 2.0, False, device=card)
    assert result["correct"] is True, lines
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(cell, card):
    result, lines = run.run(cell, 2**31 + 12, 1.0, False, device=card, make=control.make)
    assert result["correct"] is False, lines


@pytest.mark.cuda
@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in (
    VERIFY_FAULTS if _kind(c)[0] == "verify" else PROVE_FAULTS)])
def test_fault_is_not_correct_on_the_card(cell, fault, card):
    kind, chunk, budget = _kind(cell)
    result, lines = run.run(cell, 2**31 + 13, 1.0, False, device=card,
                            make=make_faulty(fault, kind, chunk, budget))
    assert result["correct"] is False, lines
    print(cell, fault, {k: v["value"] for k, v in result["checks"].items()})
