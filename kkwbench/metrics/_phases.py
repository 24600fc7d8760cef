"""Sums over the port's PhaseTimer rows (TorchKKW.last_timings) of a
window's calls, by phase name without its "[i]" tag."""

from __future__ import annotations

import re


def total(window, phases, field: str):
    """The sum of `field` ("host_ms" or "device_ms") over the rows of
    `phases` in every call; None where a row has none."""
    s = 0.0
    for call in window.calls:
        for name, row in call.timings.items():
            if re.sub(r"\[\d+\]$", "", name) in phases:
                if row.get(field) is None:
                    return None
                s += row[field]
    return s
