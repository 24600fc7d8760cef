"""The profiler summary of reverie_tpu_torch.trace: device busy time as the
union of device intervals, device time by kernel name, and host time by
CUDA runtime call."""

from types import SimpleNamespace

import pytest
import torch

from reverie_tpu_torch import trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def ev(name, start, end, device=CUDA):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


EVENTS = [
    ev("aten::add", 0.0, 100.0, CPU),  # host op: never device time
    ev("cudaLaunchKernel", 1.0, 3.0, CPU),
    ev("cudaLaunchKernel", 4.0, 6.0, CPU),
    ev("cudaHostAlloc", 7.0, 47.0, CPU),
    ev("add_kernel", 10.0, 20.0),
    ev("add_kernel", 15.0, 30.0),  # overlaps the one before
    ev("(anonymous namespace)::blake3_chunk_cvs_kernel(...)", 50.0, 51.0),
    ev("xor_kernel", 60.0, 64.0),
    ev("xor_kernel", 70.0, 74.0),
]


def test_busy_is_the_union_of_device_intervals():
    assert trace.busy_us(EVENTS) == pytest.approx(20.0 + 1.0 + 8.0)
    assert trace.busy_us(EVENTS[:1]) == 0.0


@pytest.mark.parametrize("top", [1, 3])
def test_by_kernel_lists_the_top_names_and_the_ports_kernels(top):
    rows = trace.by_kernel(EVENTS, top)
    by_name = {r["name"]: (r["calls"], r["device_ms"]) for r in rows}
    assert rows[0]["name"] == "add_kernel"
    assert by_name["add_kernel"] == (2, pytest.approx(0.025))
    assert by_name["(anonymous namespace)::blake3_chunk_cvs_kernel(...)"] == (
        1, pytest.approx(0.001))
    assert ("xor_kernel" in by_name) == (top == 3)
    assert "aten::add" not in by_name


def test_host_api_sums_the_runtime_calls():
    rows = trace.host_api(EVENTS, 5)
    assert rows == [{"name": "cudaHostAlloc", "calls": 1, "host_ms": pytest.approx(0.04)},
                    {"name": "cudaLaunchKernel", "calls": 2, "host_ms": pytest.approx(0.004)}]
    assert trace.host_api(EVENTS, 1)[0]["name"] == "cudaHostAlloc"
