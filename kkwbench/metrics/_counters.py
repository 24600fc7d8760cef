"""The counters of the port's PhaseTimer rows (TorchKKW.last_timings):
sizes of a phase's work, the same on every row of one phase, which a
program without them lacks."""

from __future__ import annotations

import re


def counter(window, phases, name: str):
    """The value of counter `name` on the window's rows of `phases` (their
    names without the "[i]" tag); None where a row of them lacks it, none
    holds it, or two differ."""
    seen = []
    for call in window.calls:
        for row_name, row in call.timings.items():
            if re.sub(r"\[\d+\]$", "", row_name) in phases:
                if name not in row:
                    return None
                seen.append(row[name])
    if not seen or any(v != seen[0] for v in seen):
        return None
    return seen[0]
