"""reverie_tpu_torch.device_footprint against the device memory a prove
really holds: the peak of live tensor bytes over `TorchKKW.prove_batch` on
the CPU, from the profiler's allocation trace, with each CUDA kernel's
plain version replaced by an allocation of its output (the kernels allocate
nothing else; the plain versions' working sets exist only on the CPU).  The
circuits and the 25% tolerance are tests/test_footprint.py's."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from reverie_tpu_torch import TorchKKW, device_footprint, largest_batch
from reverie_tpu_torch.circuit.builders import (
    mixed_b2a_circuit,
    mul_bench_circuit,
    z64_mul_bench_circuit,
)
from reverie_tpu_torch.crypto.kernels import aes_tape, aes_tape_z64, blake3 as b3

CIRCUITS = {
    "gf2": lambda: mul_bench_circuit(3000),
    "z64": lambda: z64_mul_bench_circuit(300),
    "mixed_b2a": mixed_b2a_circuit,
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


@pytest.fixture
def kernel_outputs_only(monkeypatch):
    monkeypatch.setattr(aes_tape, "aes_ctr_tape_gf2", lambda rk, m2, omit=None: torch.zeros(
        (m2, rk.shape[0] // 8), dtype=torch.uint8))
    monkeypatch.setattr(aes_tape_z64, "aes_ctr_tape_z64", lambda rk, mz, omit=None: torch.zeros(
        (mz, 8, rk.shape[0] // 8), dtype=torch.int64))
    monkeypatch.setattr(b3, "chunk_cvs", lambda buf, n, base=0: torch.zeros(
        (8, n, buf.shape[1]), dtype=torch.int32))


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("name", list(CIRCUITS))
def test_footprint_tracks_a_prove(kernel_outputs_only, name, n):
    prog, wit2, witz = CIRCUITS[name]()
    port = TorchKKW(prog, device=torch.device("cpu"))
    seeds = np.random.RandomState(n).randint(0, 256, (n, 256, 16), dtype=np.uint8)
    peak = live_peak(lambda: port.prove_batch([(wit2, witz)] * n, seeds))
    # the index tables come from numpy without a copy on the CPU
    (ex,) = port._executors.values()
    peak += sum(t.numel() * t.element_size() for t in ex.tables.values())
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
    cc = TorchKKW(z64_mul_bench_circuit(10)[0], device=torch.device("cpu")).cc
    free = 2 * device_footprint(cc, n * 256)
    assert largest_batch(cc, free, most) == want
    # a byte less, and n proofs no longer fit twice
    assert largest_batch(cc, free - 1, most) == min(n - 1, most)
