"""A kernel family's share of its roofline over a traced window: the sum of
its launches' bounds over the sum of their device times, in percent.  The
launches the window's calls make are worked out from the calls' legs; where
the trace does not hold exactly those launches, there is nothing to read."""

from __future__ import annotations

from kkwbench.peaks import bound_s


def share(window, kernel: str, bounds: list):
    """bounds: [(bytes, int ops)] of every launch of the window's calls, in
    any order; the trace's launches are the kernels whose name holds
    `kernel`."""
    tr = window.trace
    if tr is None or window.clock_mhz is None or not bounds:
        return None
    times = [d for name, ds in tr.kernels.items() if kernel in name for d in ds]
    if len(times) != len(bounds) or sum(times) <= 0:
        return None
    return 100.0 * sum(bound_s(b, o, window.clock_mhz) for b, o in bounds) / sum(times)


def legs(window, part):
    """(executor role, lanes) of every leg of the window's calls, or []."""
    if part != window.kind:
        return []
    return [leg for call in window.calls for leg in call.legs]
