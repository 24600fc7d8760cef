"""The traced window's reading (kkwbench.trace.read) on made-up profiler
events: busy time as the union of device intervals inside the timed calls,
device time by kernel, idle gaps named by the host span they fall in."""

from __future__ import annotations

import pytest
import torch

from kkwbench import trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, dev, start_ms, end_ms, annotation=False):
        self._n, self._d, self._s, self._e, self._a = name, dev, start_ms, end_ms, annotation

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return int(self._s * 1e6)

    def end_ns(self):
        return int(self._e * 1e6)

    def is_user_annotation(self):
        return self._a


def test_busy_kernels_and_gaps():
    events = [
        Ev(trace.CALL_SPAN, CPU, 10, 110, True),
        Ev("challenge[0]", CPU, 40, 60, True),
        Ev("ProfilerStep#1", CPU, 0, 200, True),
        Ev("k1", CUDA, 5, 12),  # starts before the window: left out
        Ev("k1", CUDA, 12, 20),
        Ev("k2", CUDA, 18, 30),  # overlaps k1: the union counts 12..30 once
        Ev("k1", CUDA, 70, 100),
        Ev("gpu_user_annotation", CUDA, 12, 100, True),  # not a device op
    ]
    tr = trace.read(events)
    assert tr.window_s == pytest.approx(0.100)
    assert tr.busy_s == pytest.approx(0.048)
    assert tr.kernels == {"k1": [pytest.approx(0.008), pytest.approx(0.030)],
                          "k2": [pytest.approx(0.012)]}
    assert tr.device_ops[0] == ["k1", pytest.approx(0.038)]
    gaps = dict(tr.idle_gaps)
    # 10..12 and 100..110 between phases; 30..70 has its middle in challenge
    assert gaps == {"challenge": pytest.approx(0.040), "between phases": pytest.approx(0.012)}


def test_nothing_to_read():
    assert trace.read([Ev("k1", CUDA, 0, 1)]) is None
    assert trace.read([Ev(trace.CALL_SPAN, CPU, 0, 1, True)]) is None
