"""reverie_tpu_torch.device_footprint against the device memory a prove
really holds: the peak of live tensor bytes over `TorchKKW.prove_batch` on
the CPU, from the profiler's allocation trace, with each CUDA kernel's
plain version replaced by an allocation of its output (the kernels allocate
nothing else; the plain versions' working sets exist only on the CPU; the
wave kernels allocate their spill arenas and their outputs).  The circuits
and the 25% tolerance are tests/test_footprint.py's, with a deep GF(2)
circuit for the wave executor beside them; mixed_b2a (190 levels) takes
the wave executor too (W2)."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from reverie_tpu_torch import (
    StreamingKKW,
    TorchKKW,
    device_footprint,
    largest_batch,
    pipeline_footprint,
)
from reverie_tpu_torch.backend import host, scan
from reverie_tpu_torch.circuit.builders import (
    mixed_b2a_circuit,
    mul_bench_circuit,
    wide_and_circuit,
    z64_mul_bench_circuit,
)
from reverie_tpu_torch.crypto.kernels import aes_tape, aes_tape_z64, blake3 as b3
from torch_threads import one_thread  # noqa: F401  (autouse)

CIRCUITS = {
    "gf2": lambda: mul_bench_circuit(3000),
    "z64": lambda: z64_mul_bench_circuit(300),
    "mixed_b2a": mixed_b2a_circuit,  # 190 levels: the wave executor (W2)
    "deep_gf2": lambda: wide_and_circuit(3000, width=16, seed=1),  # the wave executor
}


def live_peak(fn) -> int:
    """Peak bytes of live CPU tensors while fn runs."""
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        fn()
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() == "[memory]"), key=lambda e: e.start_ns())
    live = peak = 0
    for e in events:
        live += e.nbytes()
        peak = max(peak, live)
    return peak


def card_table_bytes(ex) -> int:
    """Bytes of the tables an executor holds on the card: the levelized
    Executor's index tables, or the wave executor's packed program (its
    slots, input fields and chunk offsets, and its packed z64 slots, their
    staged words' fields and chunk offsets and the bits table), which the
    CPU keeps as the slot-allocated tables."""
    if isinstance(ex, scan.ScanExecutor):
        prog = ex.program
        packed = scan.pack_table(ex.table.numpy(), ex.mode, prog.plan.chunk)
        if prog.has_z64:
            packed += scan.pack_ztable(prog.ztable.numpy(), ex.mode, prog.plan.chunk)
            packed += (prog.bits.numpy(),)
        return sum(a.nbytes for a in packed)
    return sum(t.numel() * t.element_size() for t in ex.tables.values())


@pytest.fixture
def kernel_outputs_only(monkeypatch):
    monkeypatch.setattr(aes_tape, "aes_ctr_tape_gf2", lambda rk, m2, omit=None, block=0:
                        torch.zeros((m2, rk.shape[0] // 8), dtype=torch.uint8))
    monkeypatch.setattr(aes_tape_z64, "aes_ctr_tape_z64", lambda rk, mz, omit=None, block=0:
                        torch.zeros((mz, 8, rk.shape[0] // 8), dtype=torch.int64))
    monkeypatch.setattr(b3, "chunk_cvs", lambda buf, n, base=0: torch.zeros(
        (8, n, buf.shape[1]), dtype=torch.int32))

    def wave_run(prog, mode, tape, xin, co2, re2, n_onl, n_pre, tapez=None, xinz=None,
                 coz=None, rez=None, n_onlz=0, n_prez=0, *carries):
        R = tape.shape[1]
        u8 = dict(dtype=torch.uint8)
        z = prog.has_z64
        out = scan.WaveOut(
            torch.zeros((max(n_onl, 1), R), **u8), torch.zeros((max(n_pre, 1), R), **u8),
            torch.zeros((R,), dtype=torch.bool),
            torch.zeros((max(n_onlz, 1) if z else 1, R), **u8),
            torch.zeros((max(n_prez, 1) if z else 1, R), **u8),
            *(torch.zeros((0, R), **u8),) * 2, torch.zeros((0, 8, R), dtype=torch.int64),
            torch.zeros((0, R), dtype=torch.int64))
        # the spill arenas (GF(2); z64: W2's), while it runs (the live values
        # sit in shared memory)
        torch.empty((max(prog.n_spill, 1), R), dtype=torch.int16).zero_()
        if z:
            torch.empty((max(prog.n_spillz, 1), 9, R), dtype=torch.int64).zero_()
        return out

    monkeypatch.setattr(scan, "wave_run", wave_run)


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("name", list(CIRCUITS))
def test_footprint_tracks_a_prove(kernel_outputs_only, name, n):
    prog, wit2, witz = CIRCUITS[name]()
    port = TorchKKW(prog, device=torch.device("cpu"))
    assert host.uses_waves(port.cc) == (name in ("deep_gf2", "mixed_b2a"))
    seeds = np.random.RandomState(n).randint(0, 256, (n, 256, 16), dtype=np.uint8)
    peak = live_peak(lambda: port.prove_batch([(wit2, witz)] * n, seeds))
    # the index or wave tables come from numpy without a copy on the CPU
    (ex,) = port._executors.values()
    peak += card_table_bytes(ex)
    pred = device_footprint(port.cc, n * 256)
    assert abs(pred - peak) <= 0.25 * peak, (pred, peak)


def test_footprint_grows_with_the_batch():
    cc = TorchKKW(mul_bench_circuit(100)[0], device=torch.device("cpu")).cc
    one = device_footprint(cc, 256)
    assert device_footprint(cc, 8 * 256) == pytest.approx(8 * one, rel=1e-3)
    # the tape (2n + 2 rows) and the streams three times over (2n + 2 rows)
    assert one > 4 * (2 * 100 + 2) * 256


@pytest.mark.parametrize("n, most, want", [(3, 8, 3), (3, 2, 2), (1, 8, 1)])
def test_largest_batch_fits_two_batches(n, most, want):
    """largest_batch sizes a chunk by pipeline_footprint: one chunk's
    device_footprint and the streams of the chunk before, which is still
    alive."""
    cc = TorchKKW(z64_mul_bench_circuit(10)[0], device=torch.device("cpu")).cc
    free = pipeline_footprint(cc, n * 256)
    assert device_footprint(cc, n * 256) < free < 2 * device_footprint(cc, n * 256)
    assert largest_batch(cc, free, most) == want
    # a byte less, and a chunk of n proofs no longer fits
    assert largest_batch(cc, free - 1, most) == min(n - 1, most)


def test_chunked_sha256_peak_within_the_smokes_limit(kernel_outputs_only):
    """prove_batch_chunked keeps the chunk before alive (its streams await
    their challenge) while the next runs: on the SHA-256 statement, at
    chunk 1, the peak stays within chip_smoke.py's limit of
    pipeline_footprint (one chunk's device_footprint and the chunk before's
    streams: what largest_batch sizes a chunk by), and above it."""
    import chip_smoke
    from reverie_tpu_torch.parity import sha256_bench

    prog, wit2, witz = sha256_bench()
    port = TorchKKW(prog, device=torch.device("cpu"))
    seeds = np.random.RandomState(3).randint(0, 256, (3, 256, 16), dtype=np.uint8)
    peak = live_peak(lambda: port.prove_batch_chunked([(wit2, witz)] * 3, seeds, chunk=1))
    (ex,) = port._executors.values()
    peak += card_table_bytes(ex)
    fp = pipeline_footprint(port.cc, 256)
    assert fp <= peak <= chip_smoke.PEAK_OVER_FOOTPRINT * fp, (peak, fp)


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_chunked_peak_tracks_pipeline_footprint(kernel_outputs_only, name):
    """prove_batch_chunked at chunk 1 on every executor's circuits: the
    peak is pipeline_footprint, the model largest_batch sizes chunks by,
    within 25% and at most chip_smoke.py's limit over it."""
    import chip_smoke

    prog, wit2, witz = CIRCUITS[name]()
    port = TorchKKW(prog, device=torch.device("cpu"))
    seeds = np.random.RandomState(4).randint(0, 256, (3, 256, 16), dtype=np.uint8)
    peak = live_peak(lambda: port.prove_batch_chunked([(wit2, witz)] * 3, seeds, chunk=1))
    (ex,) = port._executors.values()
    peak += card_table_bytes(ex)
    pred = pipeline_footprint(port.cc, 256)
    assert abs(pred - peak) <= 0.25 * peak, (pred, peak)
    assert peak <= chip_smoke.PEAK_OVER_FOOTPRINT * pred, (peak, pred)


class HostPull:
    """host._Pull without its host tensor: on the card a pull lands in
    pinned host memory, not on the device."""

    def __init__(self, t):
        self._a = t.numpy().copy()

    def numpy(self):
        return self._a


def test_streamed_peak_does_not_grow_with_the_circuit(kernel_outputs_only, monkeypatch):
    """StreamingKKW's peak over a prove of 4,596 and 33,268 ANDs in segments
    of 256 ops differs by the CVs its hashes may hold at most: the device
    holds one segment's tapes, executor and streams, and hash states of at
    most a segment's stream bytes of CVs (8 nodes a stream here), paired
    into the CV stack past them (a node a height).  The larger circuit's
    33 chunks a stream would hold 56 nodes more without the stack.  Both
    streams end 500 bytes into a chunk, so that the final chunk's
    transient, which sets the peak at this size, is the same."""
    monkeypatch.setattr(host, "_Pull", HostPull)
    peaks = []
    for n in (4 * 1024 + 500, 32 * 1024 + 500):
        prog, wit2, witz = mul_bench_circuit(n)
        sk = StreamingKKW(prog, 256, device=torch.device("cpu"))
        assert sk._hashers(256)["onl2"].max_nodes == 8
        seeds = np.random.RandomState(n).randint(0, 256, (256, 16), dtype=np.uint8)
        peaks.append(live_peak(lambda: sk.prove(wit2, witz, seeds)))
    # two GF(2) streams, each 8 nodes and a stack of 6 heights at most
    assert abs(peaks[1] - peaks[0]) <= 2 * (8 + 6) * b3.CV_BYTES * 256, peaks
