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

Each line also reads the program's own records (the leg's `last_timings`,
host.PhaseTimer) beside the trace: `span_self_ms`, each phase's host ms
less what its child spans cover, and each child's ms; `idle_by_span`, the
card's idle ms inside the entry call named by the innermost of those rows
and children; `clock_skew_us`, the median and most of |a row's or child's
start_ns - its profiler range's start_ns()| (both on the Unix ns clock);
and `device_ms_by_span`, the device ms of the kernels, copies and sets by
the innermost profiler range their launch fell in (the launch found
through correlation_id() and linked_correlation_id()): the levelized
executor's kernels by its "executor.*" ranges, each phase's busy time.

A leg's trace is whole when it holds every launch of the port's kernels
that the wrappers counted in the recorded run, and no more device time
than the run's wall; where it is not, its busy time and idle shares are
null (not measured) and the exit code is 1.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import bisect
import functools
import json
import re
import statistics
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


def _union(spans) -> list:
    """The union of (start, end) intervals, as disjoint ones in order."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy_us(events) -> float:
    """Length of the union of the device events' time intervals, in µs."""
    return sum(e - s for s, e in _union((e.time_range.start, e.time_range.end)
                                        for e in _device_events(events)))


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


# -- the program's records beside the trace (raw events:
#    prof.profiler.kineto_results.events(), nanosecond stamps) ----------------

#: the port's entry calls, each a profiler range of its name (profiling.entry)
ENTRIES = ("prove_batch", "prove_batch_chunked", "prove_many", "verify_many", "prove", "verify")
OUTSIDE = "outside phases"


def _untagged(name: str) -> str:
    return re.sub(r"\[\d+\]$", "", name)


def _ranges(raw) -> list:
    """(start_ns, end_ns, name) of the host's profiler ranges (the
    program's annotations), by start; the schedule's ProfilerStep left out."""
    cpu = torch.autograd.DeviceType.CPU
    return sorted((e.start_ns(), e.end_ns(), e.name()) for e in raw
                  if e.is_user_annotation() and e.device_type() == cpu
                  and not e.name().startswith("ProfilerStep"))


def _on_card(raw) -> list:
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in raw if e.device_type() == cuda and not e.is_user_annotation()]


def span_self_ms(timings: dict) -> dict:
    """{phase: Σ host_ms less what its children cover, "<phase>.<child>":
    Σ the child's ms} over a last_timings report, "[i]" tags stripped."""
    out: dict = {}
    for name, row in timings.items():
        base = _untagged(name)
        kids = 0.0
        for child, s, e in row["spans"]:
            out[f"{base}.{child}"] = out.get(f"{base}.{child}", 0.0) + (e - s) / 1e6
            kids += (e - s) / 1e6
        out[base] = out.get(base, 0.0) + row["host_ms"] - kids
    return out


def _segments(timings: dict) -> list:
    """The program's host timeline: (start_ns, end_ns, name) of each child
    as "<phase>.<child>", and of each stretch of a row its children leave."""
    segs = []
    for name, row in timings.items():
        base, at = _untagged(name), row["start_ns"]
        for child, s, e in sorted(row["spans"], key=lambda c: c[1]):
            if s > at:
                segs.append((at, s, base))
            segs.append((s, e, f"{base}.{child}"))
            at = max(at, e)
        if row["end_ns"] > at:
            segs.append((at, row["end_ns"], base))
    return sorted(segs)


def idle_by_span(raw, timings: dict) -> dict:
    """{name: ms} of the card's idle time inside the entry call (its
    ENTRIES range; else the rows' extent), each idle stretch split over
    the program's rows and children (_segments) it overlaps, the rest
    OUTSIDE.  Empty where the trace holds no such call."""
    roots = [(s, e) for s, e, n in _ranges(raw) if n in ENTRIES]
    if roots:
        w0, w1 = min(s for s, _ in roots), max(e for _, e in roots)
    elif timings:
        w0 = min(r["start_ns"] for r in timings.values())
        w1 = max(r["end_ns"] for r in timings.values())
    else:
        return {}
    busy = _union((max(e.start_ns(), w0), min(e.end_ns(), w1)) for e in _on_card(raw)
                  if e.end_ns() > w0 and e.start_ns() < w1)
    edges = [w0] + [x for b in busy for x in b] + [w1]
    segs = _segments(timings)
    out: dict = {}
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        left = g1 - g0
        for s, e, name in segs:
            cut = min(e, g1) - max(s, g0)
            if cut > 0:
                out[name] = out.get(name, 0.0) + cut / 1e6
                left -= cut
        if left > 0:
            out[OUTSIDE] = out.get(OUTSIDE, 0.0) + left / 1e6
    return out


def clock_skew_us(raw, timings: dict) -> dict:
    """{median, most, pairs}: |start_ns - the profiler range's start_ns()|
    in µs over the report's rows and children, each paired with the range
    of its name ("<phase>[i]", "<phase>.<child>[i]") in order; nulls where
    none pairs."""
    starts: dict = {}
    for s, _, name in _ranges(raw):
        starts.setdefault(name, []).append(s)
    mine: dict = {}
    for name, row in timings.items():
        mine.setdefault(name, []).append(row["start_ns"])
        base, tag = re.match(r"(.*?)(\[\d+\])?$", name).groups()
        for child, s, _ in row["spans"]:
            mine.setdefault(f"{base}.{child}{tag or ''}", []).append(s)
    d = [abs(a - b) / 1e3 for name, ss in mine.items() for a, b in zip(ss, starts.get(name, []))]
    return {"median": statistics.median(d) if d else None, "most": max(d, default=None),
            "pairs": len(d)}


def device_ms_by_span(raw) -> dict:
    """{range: device ms} of the card's kernels, copies and sets, each by the
    innermost host profiler range ("[i]" stripped) in flight when it was
    launched: the launch is the host runtime call of its correlation_id()
    (cudaLaunchKernel, cudaMemcpyAsync, ...), else the host op of its
    linked_correlation_id().  "unmatched" where neither is in the trace,
    OUTSIDE where no range holds the launch."""
    cpu = torch.autograd.DeviceType.CPU
    runtime, ops = {}, {}
    for e in raw:
        if e.device_type() == cpu:
            (runtime if e.name().startswith("cu") and not e.is_user_annotation()
             else ops)[e.correlation_id()] = e.start_ns()
    ranges = _ranges(raw)
    starts = [r[0] for r in ranges]
    out: dict = {}
    for d in _on_card(raw):
        t = runtime.get(d.correlation_id())
        if t is None:
            t = ops.get(d.linked_correlation_id())
        name = "unmatched"
        if t is not None:
            name = OUTSIDE
            for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
                if ranges[i][1] >= t:
                    name = _untagged(ranges[i][2])
                    break
        out[name] = out.get(name, 0.0) + (d.end_ns() - d.start_ns()) / 1e6
    return out


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
        raw = prof.profiler.kineto_results.events()
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
            "span_self_ms": span_self_ms(kkw.last_timings),
            "idle_by_span": idle_by_span(raw, kkw.last_timings),
            "clock_skew_us": clock_skew_us(raw, kkw.last_timings),
            "device_ms_by_span": device_ms_by_span(raw),
        }), flush=True)
    return complete


if __name__ == "__main__":
    sys.exit(main())
