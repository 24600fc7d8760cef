"""Sums over the port's PhaseTimer rows (last_timings) of a window's calls,
a proof, from the rows' child spans (host.PhaseTimer.span): fields that a
program without them lacks, which then reads nothing."""

from __future__ import annotations

import re


def per_proof(window, part, value):
    """Σ value(phase, row) over every row of the window's calls, over the
    proofs returned, in ms; None where the window is of the other kind,
    returned nothing, or a row lacks a field `value` reads.  `phase` is
    the row's name without its "[i]" tag."""
    if part != window.kind or not window.done:
        return None
    s = 0.0
    for call in window.calls:
        for name, row in call.timings.items():
            try:
                s += value(re.sub(r"\[\d+\]$", "", name), row)
            except KeyError:
                return None
    return s / window.done
