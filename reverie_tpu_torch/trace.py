"""Profile one warm prove and one warm verify of each main path on the card.

    python -m reverie_tpu_torch.trace [--out DIR]

For each cell, `TorchKKW(mul_bench_circuit(1_000_000))` (GF(2)) and
`TorchKKW(z64_mul_bench_circuit(50_000))` (Z_2^64), runs a prove and a
verify once cold, then profiles a warm prove and a warm verify, each under
its own `torch.profiler` window (activities CPU and CUDA). For each leg it
prints the wall time, the device's busy time (the union of its kernel,
memcpy and memset intervals), the idle share 1 - busy / wall, and the device
time by kernel name (the top names and the port's own kernels), as one JSON
line. With --out it also writes each leg's Chrome trace there. The wall time
inside a window includes the profiler's own overhead, so the idle share is
given against both it and the same leg's unprofiled wall time. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .circuit.builders import mul_bench_circuit, z64_mul_bench_circuit


#: the cells: the GF(2) main path (1M AND gates) and the Z64 one (50k MULs)
CELLS = {"gf2_mul_1M": (mul_bench_circuit, 1_000_000),
         "z64_mul_50k": (z64_mul_bench_circuit, 50_000)}
TOP = 15  # kernel names listed by device time

#: the port's own kernels, always listed by `by_kernel`
PORT_KERNELS = ("aes_tape_gf2_kernel", "aes_tape_z64_kernel",
                "blake3_chunk_cvs_kernel")


def _device_events(events):
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]


def busy_us(events) -> float:
    """Length of the union of the device events' time intervals, in µs."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in _device_events(events))
    total, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def by_kernel(events, top: int) -> list:
    """Device time by kernel name: the `top` names with the most time, and
    the port's own kernels."""
    agg = {}
    for e in _device_events(events):
        calls, us = agg.get(e.name, (0, 0.0))
        agg[e.name] = (calls + 1, us + e.time_range.end - e.time_range.start)
    rows = sorted(agg.items(), key=lambda kv: -kv[1][1])
    keep = [r for i, r in enumerate(rows)
            if i < top or any(k in r[0] for k in PORT_KERNELS)]
    return [{"name": n[:160], "calls": c, "device_ms": us / 1e3}
            for n, (c, us) in keep]


def timed(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)

    from reverie_tpu_torch import default_device

    dev = default_device()
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
    for cell, (builder, n) in CELLS.items():
        profile_cell(cell, builder(n), dev, args.out)
    return 0


def profile_cell(cell: str, circuit, dev, out) -> None:
    from reverie_tpu_torch import TorchKKW

    prog, w2, wz = circuit
    kkw = TorchKKW(prog, device=dev)
    seeds = np.random.RandomState(2026).randint(0, 256, (256, 16), dtype=np.uint8)
    proof = kkw.prove(w2, wz, seeds=seeds)  # cold: builds, allocates
    if kkw.verify(proof) is not True:
        raise AssertionError(f"{cell}: the proof did not verify")

    legs = {"prove": lambda: kkw.prove(w2, wz, seeds=seeds),
            "verify": lambda: kkw.verify(proof)}
    for leg, fn in legs.items():
        _, plain_wall = timed(fn)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall = timed(fn)
        events = prof.events()
        busy = busy_us(events) / 1e3
        if busy == 0:
            raise RuntimeError("the profiler recorded no device time")
        if out is not None:
            prof.export_chrome_trace(str(out / f"{cell}_{leg}.json.gz"))
        print(json.dumps({
            "cell": cell, "leg": leg, "card": torch.cuda.get_device_name(0),
            "unprofiled_wall_ms": plain_wall, "profiled_wall_ms": wall,
            "device_busy_ms": busy, "device_idle_share": 1 - busy / wall,
            "device_idle_share_of_unprofiled_wall": 1 - busy / plain_wall,
            "phases": kkw.last_timings, "n_device_events": len(_device_events(events)),
            "by_kernel": by_kernel(events, TOP),
        }), flush=True)


if __name__ == "__main__":
    sys.exit(main())
