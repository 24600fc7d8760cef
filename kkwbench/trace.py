"""The traced run's reading of torch.profiler's events: the device's busy
time in the window (the union of its kernel, copy and set intervals), the
device time by kernel name, the kernels' durations in launch order, and the
idle gaps named by the host span they fall in.

Host spans are the benchmark's `kkwbench.call` around each timed call and,
while tracing, one span a PhaseTimer phase of the port (`phase_spans`)."""

from __future__ import annotations

import bisect
import re
from contextlib import contextmanager
from typing import Dict, List, NamedTuple, Optional

import torch

CALL_SPAN = "kkwbench.call"
TOP = 10


class Trace(NamedTuple):
    window_s: float  # first timed call's start to the last one's end
    busy_s: float  # union of device intervals inside the window
    kernels: Dict[str, List[float]]  # device seconds a launch, by name, in order
    device_ops: List[list]  # [[name, seconds]] the most device time, at most TOP
    idle_gaps: List[list]  # [[host span, seconds]] the most idle time, at most TOP


@contextmanager
def phase_spans():
    """While tracing, each PhaseTimer phase of the port is also a profiler
    span of its name, so that an idle gap can be named by it."""
    from reverie_tpu_torch.backend import host

    orig = host.PhaseTimer.phase

    @contextmanager
    def phase(self, name):
        with torch.profiler.record_function(name), orig(self, name):
            yield

    host.PhaseTimer.phase = phase
    try:
        yield
    finally:
        host.PhaseTimer.phase = orig


def _union(spans) -> List[tuple]:
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def read(events) -> Optional[Trace]:
    """The window's reading from the profiler's raw events
    (`prof.profiler.kineto_results.events()`: each event's name, device
    type and nanosecond times, without the event tree that
    `prof.events()` builds, which took minutes for a window of thousands
    of proofs), or None where it holds no timed call or no device event."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in events:
        on_card = e.device_type() == cuda
        if e.is_user_annotation():
            if not on_card:
                host.append((e.start_ns(), e.end_ns(), e.name()))
        elif on_card:
            dev.append((e.start_ns(), e.end_ns(), e.name()))
    calls = [h for h in host if h[2] == CALL_SPAN]
    if not calls or not dev:
        return None
    w0 = min(c[0] for c in calls)
    w1 = max(c[1] for c in calls)
    inside = sorted(d for d in dev if w0 <= d[0] and d[1] <= w1)
    busy = _union((s, e) for s, e, _ in inside)
    kernels: Dict[str, List[float]] = {}
    for s, e, name in inside:
        kernels.setdefault(name, []).append((e - s) / 1e9)
    by_name = sorted(((n, sum(d)) for n, d in kernels.items()), key=lambda x: -x[1])

    spans = sorted((s, e, re.sub(r"\[\d+\]$", "", n)) for s, e, n in host
                   if n != CALL_SPAN and not n.startswith("ProfilerStep"))
    starts = [sp[0] for sp in spans]
    gaps: Dict[str, float] = {}
    edges = [w0] + [x for s in busy for x in s] + [w1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) / 2
        # the innermost span (the latest start) in flight at the gap's middle
        name = "between phases"
        j = bisect.bisect_right(starts, mid) - 1
        for i in range(j, max(j - 64, -1), -1):  # spans are seldom nested deeper
            if spans[i][1] >= mid:
                name = spans[i][2]
                break
        gaps[name] = gaps.get(name, 0.0) + (e - s) / 1e9
    return Trace((w1 - w0) / 1e9, sum(e - s for s, e in busy) / 1e9, kernels,
                 [[n[:120], t] for n, t in by_name[:TOP]],
                 [[n, t] for n, t in sorted(gaps.items(), key=lambda x: -x[1])[:TOP]])
