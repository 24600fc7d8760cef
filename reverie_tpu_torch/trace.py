"""Profile warm proves and verifies of each main path on the card.

    python -m reverie_tpu_torch.trace [--out DIR] [--cells gf2_mul_1M,z64_mul_50k]

For each cell of CELLS, `TorchKKW(mul_bench_circuit(1_000_000))` (GF(2),
batches of up to 8), `TorchKKW(z64_mul_bench_circuit(50_000))` (Z_2^64, up
to 4) and the SHA-256 preimage statement of `parity.sha256_bench` (5,198
levels deep, on the wave executor; one chunk of 64), the batch being the
largest that fits the free device memory by `pipeline_footprint`
(`largest_batch`), runs each leg once cold, then profiles it warm under its
own `torch.profiler` window (activities CPU and CUDA; a warm-up run, then
the recorded one). The legs: a prove, a verify, a `prove_batch` of the
cell's N proofs and, for the first two cells, a `prove_many` of them. For
each leg it prints the wall time, the device's busy time (the union of its
kernel, memcpy and memset intervals), the idle share 1 - busy / wall, the
device time by kernel name (the top names and the port's own kernels) and
the host time by CUDA runtime call (launches, allocations, copies, waits:
whether a leg's host time goes to launching or to waiting), as one JSON
line. With --out it also writes each leg's Chrome trace there. The wall
time inside a window includes the profiler's own overhead, so the idle
share is given against both it and the same leg's unprofiled wall time.

A leg's trace is whole when it holds every launch of the port's kernels
that the wrappers counted in the recorded run, and no more device time
than the run's wall; where it is not, its busy time and idle shares are
null (not measured) and the exit code is 1.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from .circuit.builders import mul_bench_circuit, z64_mul_bench_circuit
from .parity import sha256_bench


class Cell(NamedTuple):
    make: Callable[[], tuple]  # -> (program, wit_gf2, wit_z64)
    most: int  # the most proofs of its batch legs (a chunk, for SHA-256)
    many: bool  # whether it has a prove_many leg


#: the cells, shared with chip_smoke.py's batch and sha256 phases: the GF(2)
#: main path (1M AND gates), the Z64 one (50k MULs) and the SHA-256
#: statement (BASELINE configs 2 and 5: chunks of 64 proofs)
CELLS = {"gf2_mul_1M": Cell(functools.partial(mul_bench_circuit, 1_000_000), 8, True),
         "z64_mul_50k": Cell(functools.partial(z64_mul_bench_circuit, 50_000), 4, True),
         "sha256_1block": Cell(sha256_bench, 64, False)}
TOP = 15  # kernel names listed by device time

#: the port's own kernels, always listed by `by_kernel` (a name matches
#: every kernel whose name holds it)
PORT_KERNELS = ("aes_tape_gf2_kernel", "aes_tape_z64_kernel", "blake3_chunk_cvs_kernel",
                "blake3_tail_kernel", "scan_gf2_kernel", "scan_gf2_carry_kernel",
                "scan_z64_kernel", "scan_z64_carry_kernel")


def _device_events(events):
    """The kernels, copies and sets on the card: device events that are not
    annotations (the window's ProfilerStep spans its whole step there)."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]


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


def traced_launches(events, launched: dict) -> dict:
    """{wrapper: kernels of that wrapper's name in the device events} for
    each wrapper of `launched` (host.launch_counts keys, the kernel being
    named after its wrapper)."""
    names = [e.name for e in _device_events(events)]
    return {k: sum(f"{k}_kernel" in n for n in names) for k in launched}


def profiled(fn):
    """fn run twice under one profiler window: a warm-up step whose events
    are dropped, then the recorded one.  Without the warm-up the first
    kernels of a window (a tape, the wave kernel) were missing from some
    legs' traces on the H100.  -> (the profiler, the recorded run's wall
    ms, the port's launches in it by wrapper)."""
    from .backend.host import launch_counts

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        prof.step()
        n0 = launch_counts()
        _, wall = timed(fn)
        n1 = launch_counts()
        prof.step()
    return prof, wall, {k: n1[k] - n0[k] for k in n0}


def timed(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--cells", default=",".join(CELLS),
                    help="the cells to profile, comma-separated (default: all)")
    args = ap.parse_args(argv)
    cells = args.cells.split(",")
    unknown = sorted(set(cells) - set(CELLS))
    if unknown:
        ap.error(f"unknown cells {unknown}; the cells are {list(CELLS)}")

    from reverie_tpu_torch import default_device

    dev = default_device()
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
    complete = [profile_cell(cell, CELLS[cell].make(), CELLS[cell].most, CELLS[cell].many,
                             dev, args.out)
                for cell in cells]
    return 0 if all(complete) else 1


def profile_cell(cell: str, circuit, most: int, many: bool, dev, out) -> bool:
    from reverie_tpu_torch import TorchKKW, largest_batch

    prog, w2, wz = circuit
    kkw = TorchKKW(prog, device=dev)
    torch.cuda.empty_cache()
    n_proofs = largest_batch(kkw.cc, torch.cuda.mem_get_info(dev)[0], most)
    if n_proofs < 1:
        raise RuntimeError(f"{cell}: one proof does not fit the card")
    seeds = np.random.RandomState(2026).randint(0, 256, (n_proofs, 256, 16), dtype=np.uint8)
    proof = kkw.prove(w2, wz, seeds=seeds[0])
    if kkw.verify(proof) is not True:
        raise AssertionError(f"{cell}: the proof did not verify")

    jobs = [(w2, wz)] * n_proofs
    legs = {"prove": lambda: kkw.prove(w2, wz, seeds=seeds[0]),
            "verify": lambda: kkw.verify(proof),
            f"prove_batch_{n_proofs}": lambda: kkw.prove_batch(jobs, seeds)}
    if many:
        legs[f"prove_many_{n_proofs}"] = lambda: kkw.prove_many(jobs, seeds)
    complete = True
    for leg, fn in legs.items():
        fn()  # cold: builds, allocates
        _, plain_wall = timed(fn)
        prof, wall, launched = profiled(fn)
        events = prof.events()
        busy = busy_us(events) / 1e3
        if busy == 0:
            raise RuntimeError("the profiler recorded no device time")
        seen = traced_launches(events, launched)
        whole = busy <= wall and all(seen[k] == n for k, n in launched.items())
        complete &= whole
        if out is not None:
            prof.export_chrome_trace(str(out / f"{cell}_{leg}.json.gz"))
        print(json.dumps({
            "cell": cell, "leg": leg, "card": torch.cuda.get_device_name(0),
            "unprofiled_wall_ms": plain_wall, "profiled_wall_ms": wall,
            "port_launches": launched, "port_kernels_traced": seen, "trace_whole": whole,
            "device_busy_ms": busy if whole else None,
            "device_idle_share": 1 - busy / wall if whole else None,
            "device_idle_share_of_unprofiled_wall": 1 - busy / plain_wall if whole else None,
            "phases": kkw.last_timings, "n_device_events": len(_device_events(events)),
            "by_kernel": by_kernel(events, TOP), "host_api": host_api(events, TOP),
        }), flush=True)
    return complete


if __name__ == "__main__":
    sys.exit(main())
