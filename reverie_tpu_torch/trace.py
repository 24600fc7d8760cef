"""Profile warm proves and verifies of each main path on the card.

    python -m reverie_tpu_torch.trace [--out DIR]

For each cell, `TorchKKW(mul_bench_circuit(1_000_000))` (GF(2), batches of
up to 8) and `TorchKKW(z64_mul_bench_circuit(50_000))` (Z_2^64, up to 4),
the batch being the largest of which two fit the free device memory by
`device_footprint` (`largest_batch`), runs each leg once cold, then profiles it warm under its own
`torch.profiler` window (activities CPU and CUDA). The legs: a prove, a
verify, a `prove_batch` and a `prove_many` of the cell's N proofs. For
each leg it prints the wall time, the device's busy time (the union of its
kernel, memcpy and memset intervals), the idle share 1 - busy / wall, the
device time by kernel name (the top names and the port's own kernels) and
the host time by CUDA runtime call (launches, allocations, copies, waits:
whether a leg's host time goes to launching or to waiting), as one JSON
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


#: the cells: the GF(2) main path (1M AND gates) and the Z64 one (50k MULs),
#: with the most proofs of their batch legs (chip_smoke.py's batch phase too)
CELLS = {"gf2_mul_1M": (mul_bench_circuit, 1_000_000, 8),
         "z64_mul_50k": (z64_mul_bench_circuit, 50_000, 4)}
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


def host_api(events, top: int) -> list:
    """Host time by CUDA runtime call (the host events named cuda*): the
    `top` names with the most time."""
    agg = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("cuda"):
            calls, us = agg.get(e.name, (0, 0.0))
            agg[e.name] = (calls + 1, us + e.time_range.end - e.time_range.start)
    rows = sorted(agg.items(), key=lambda kv: -kv[1][1])[:top]
    return [{"name": n, "calls": c, "host_ms": us / 1e3} for n, (c, us) in rows]


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
    for cell, (builder, n, most) in CELLS.items():
        profile_cell(cell, builder(n), most, dev, args.out)
    return 0


def profile_cell(cell: str, circuit, most: int, dev, out) -> None:
    from reverie_tpu_torch import TorchKKW, largest_batch

    prog, w2, wz = circuit
    kkw = TorchKKW(prog, device=dev)
    torch.cuda.empty_cache()
    n_proofs = largest_batch(kkw.cc, torch.cuda.mem_get_info(dev)[0], most)
    if n_proofs < 1:
        raise RuntimeError(f"{cell}: two proofs do not fit the card")
    seeds = np.random.RandomState(2026).randint(0, 256, (n_proofs, 256, 16), dtype=np.uint8)
    proof = kkw.prove(w2, wz, seeds=seeds[0])
    if kkw.verify(proof) is not True:
        raise AssertionError(f"{cell}: the proof did not verify")

    jobs = [(w2, wz)] * n_proofs
    legs = {"prove": lambda: kkw.prove(w2, wz, seeds=seeds[0]),
            "verify": lambda: kkw.verify(proof),
            f"prove_batch_{n_proofs}": lambda: kkw.prove_batch(jobs, seeds),
            f"prove_many_{n_proofs}": lambda: kkw.prove_many(jobs, seeds)}
    for leg, fn in legs.items():
        fn()  # cold: builds, allocates
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
            "by_kernel": by_kernel(events, TOP), "host_api": host_api(events, TOP),
        }), flush=True)


if __name__ == "__main__":
    sys.exit(main())
