"""The profiler summary of reverie_tpu_torch.trace: device busy time as the
union of device intervals, device time by kernel name, and host time by
CUDA runtime call."""

from types import SimpleNamespace

import pytest
import torch

from reverie_tpu_torch import trace
from torch_threads import one_thread  # noqa: F401  (autouse)

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def ev(name, start, end, device=CUDA, annotation=False):
    return SimpleNamespace(name=name, device_type=device, is_user_annotation=annotation,
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
    ev("ProfilerStep*", 0.0, 100.0, annotation=True),  # the step's span on the card
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
    assert "aten::add" not in by_name and "ProfilerStep*" not in by_name


def test_host_api_sums_the_runtime_calls():
    rows = trace.host_api(EVENTS, 5)
    assert rows == [{"name": "cudaHostAlloc", "calls": 1, "host_ms": pytest.approx(0.04)},
                    {"name": "cudaLaunchKernel", "calls": 2, "host_ms": pytest.approx(0.004)}]
    assert trace.host_api(EVENTS, 1)[0]["name"] == "cudaHostAlloc"


def test_traced_launches_counts_each_wrappers_kernels():
    """A leg's trace is whole when it holds as many kernels of each wrapper
    as the wrapper counted; host events of the same name do not count."""
    events = EVENTS + [ev("void (anonymous namespace)::scan_gf2_kernel<0>(...)", 80.0, 90.0),
                       ev("void (anonymous namespace)::scan_gf2_kernel<1>(...)", 91.0, 92.0),
                       ev("scan_gf2_kernel", 93.0, 94.0, CPU)]
    launched = {"aes_tape_gf2": 1, "blake3_chunk_cvs": 1, "scan_gf2": 2}
    assert trace.traced_launches(events, launched) == {
        "aes_tape_gf2": 0, "blake3_chunk_cvs": 1, "scan_gf2": 2}


def test_cells_are_the_smokes_cells():
    """One definition of the cells for trace.py and chip_smoke.py: the
    SHA-256 cell is the wave executor's, in chunks of 64, and the smoke's
    chunked batch is 512 proofs of it (bench.py's config 5)."""
    import chip_smoke
    from reverie_tpu_torch.backend import host
    from reverie_tpu_torch.circuit.compile import compile_program

    cell = trace.CELLS["sha256_1block"]
    prog, wit2, witz = cell.make()
    assert host.uses_waves(compile_program(prog)) and (len(wit2), witz) == (512, [])
    assert (cell.most, cell.many) == (64, False)
    assert chip_smoke.SHA256_CHUNKS * cell.most == 512
    assert [c.most for k, c in trace.CELLS.items() if c.many] == [8, 4]


def test_tail_kernels_are_traced_under_their_wrapper():
    """Both kernels of csrc/blake3_tail.cu, the tree's and the pairs', hold
    the name the blake3_tail wrapper is traced by, and are listed among the
    port's kernels whatever their time."""
    events = [ev("(anonymous namespace)::blake3_tail_kernel(Stack, Tree)", 0.0, 1.0),
              ev("(anonymous namespace)::blake3_tail_kernel_pairs(...)", 2.0, 3.0)]
    assert trace.traced_launches(events, {"blake3_tail": 2}) == {"blake3_tail": 2}
    assert len(trace.by_kernel(events + EVENTS, 0)) == 3  # the tail's two and K3


def test_cells_option_rejects_an_unknown_cell(capsys):
    """--cells takes the names of CELLS only, and says which it knows."""
    with pytest.raises(SystemExit) as exc:
        trace.main(["--cells", "gf2_mul_1M,nope"])
    assert exc.value.code == 2 and "nope" in capsys.readouterr().err


class Raw:
    """A raw profiler event (kineto_results.events()), in ms."""

    def __init__(self, name, start, end, device=CUDA, annotation=False, corr=0, linked=0):
        self._v = (name, device, int(start * 1e6), int(end * 1e6), annotation, corr, linked)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]


MS = 1_000_000
#: a verify's rows: its check, and a finish with two children
TIMINGS = {
    "check[0]": {"host_ms": 5.0, "start_ns": 0, "end_ns": 5 * MS, "spans": []},
    "finish[0]": {"host_ms": 40.0, "start_ns": 10 * MS, "end_ns": 50 * MS,
                  "spans": [["wait", 10 * MS, 20 * MS], ["check", 20 * MS, 40 * MS]]},
}
RAW = [
    Raw("verify_many", 0, 100, CPU, True, corr=1),
    Raw("ProfilerStep#1", -5, 105, CPU, True, corr=2),
    Raw("check[0]", 0.01, 5, CPU, True, corr=3),
    Raw("finish[0]", 9.98, 50, CPU, True, corr=4),
    Raw("finish.wait[0]", 9.97, 20, CPU, True, corr=5),
    Raw("finish.check[0]", 20, 40, CPU, True, corr=6),
    Raw("executor.gf2.MUL", 60, 70, CPU, True, corr=7),
    Raw("aten::bitwise_xor", 61, 62, CPU, corr=8),
    Raw("cudaLaunchKernel", 61.5, 61.6, CPU, corr=900),
    Raw("cudaLaunchKernel", 1, 1.1, CPU, corr=901),
    Raw("gpu_user_annotation", 0, 100, CUDA, True),
    Raw("K3", 0, 15, corr=901),  # launched in check[0]
    Raw("elementwise_kernel", 60, 100, corr=900),  # launched in executor.gf2.MUL
    Raw("xor_kernel", 70, 71, corr=999, linked=8),  # by its op, in the same range
    Raw("lost_kernel", 72, 73, corr=998, linked=77),
]


def test_span_self_ms_takes_the_children_out():
    assert trace.span_self_ms(TIMINGS) == {
        "check": 5.0, "finish": pytest.approx(10.0), "finish.wait": pytest.approx(10.0),
        "finish.check": pytest.approx(20.0)}


def test_idle_by_span_names_idle_by_the_programs_rows():
    """The card idles from 15 to 60 ms inside the call: 15-20 in finish's
    wait, 20-40 in its check, 40-50 in finish itself, 50-60 outside every
    row."""
    assert trace.idle_by_span(RAW, TIMINGS) == {
        "finish.wait": pytest.approx(5.0), "finish.check": pytest.approx(20.0),
        "finish": pytest.approx(10.0), trace.OUTSIDE: pytest.approx(10.0)}
    assert trace.idle_by_span([], {}) == {}


def test_clock_skew_pairs_rows_with_their_ranges():
    skew = trace.clock_skew_us(RAW, TIMINGS)
    assert skew["pairs"] == 4  # the two rows, finish's two children
    assert skew["median"] == pytest.approx(15.0) and skew["most"] == pytest.approx(30.0)
    assert trace.clock_skew_us([], TIMINGS) == {"median": None, "most": None, "pairs": 0}


def test_device_ms_by_span_follows_the_launch():
    assert trace.device_ms_by_span(RAW) == {
        "check": pytest.approx(15.0), "executor.gf2.MUL": pytest.approx(41.0),
        "unmatched": pytest.approx(1.0)}
