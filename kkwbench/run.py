"""One run of one cell of BENCHMARK.json, on the machine it is started on.

    python -m kkwbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the cell's statement from the seed, hands its program file to
the port through its normal path (circuit.bincode.load_program_arrays, then
make_system with the file's cache key), and makes the mix's warm-up calls
(and a verify mix's pool of proofs).  The window then drives the mix for
`--seconds`, closed loop.  With --trace 0 the last line of standard output
is the cell's end-to-end metrics; with --trace 1 the window runs under
torch.profiler and the line holds the cell's per-layer metrics.  After the
window the plain reference (kkwbench/reference) proves a sample of the
window's statements again, drawn from the seed, on the same inputs (a
verify mix: of its pool), and a verify mix makes one more call of its
entry on pool proofs mixed with tampered copies.  The run is `correct` when
every sampled proof is byte-equal to its reference, every answer asked for
came back, every verdict of the window is True and every verdict of the
tampered call is what its proof deserves.  Exits 2 without enough CUDA
devices, 3 when jax, jaxlib, flax or the JAX package reverie_tpu was
loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import NamedTuple, Optional  # noqa: E402

from kkwbench import spec as specs  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "reverie_tpu")


class Window(NamedTuple):
    """What the per-layer readers read (kkwbench/metrics)."""

    kind: str  # "prove" or "verify"
    calls: list  # driver.Call, the window's
    seconds: float  # the window's wall time
    done: int  # proofs or verdicts returned
    make_system_s: float
    peak_bytes: Optional[int]  # the window's max_memory_allocated
    trace: object  # kkwbench.trace.Trace, or None
    shape: object  # program.Shape of the cell's statement
    clock_mhz: Optional[float]  # the card's clocks.max.sm


def _caches(root: Path) -> None:
    """The caches a run may fill, at fixed places inside the checkout, so
    that only the first run of a cell in a checkout builds and compiles."""
    cache = Path(root) / "kkwbench" / ".cache"
    os.environ["REVERIE_COMPILE_CACHE"] = str(cache / "circuits")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def _sm_clock_mhz() -> Optional[float]:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run(cell_name: str, seed: int, seconds: float, trace: bool, root: Path = specs.ROOT,
        device=None, make=None, t_start: float = None) -> tuple:
    """One run -> (the result's line as a dict, the checks' lines).
    `device` defaults to the CUDA device; `make(statement, ops, params,
    cache_key, device, reference)` stands in for make_system (the control,
    the tests' faults)."""
    import numpy as np
    import torch

    from reverie_tpu_torch import make_system
    from reverie_tpu_torch.circuit.bincode import load_program_arrays
    from reverie_tpu_torch.params import ProtocolParams

    from kkwbench import driver, program
    from kkwbench import trace as traces

    t_start = T_START if t_start is None else t_start
    _caches(root)
    spec = specs.load(root)
    cell = specs.cell(spec, cell_name)
    cfg = specs.config(spec, cell["config"], root)
    mix_spec = specs.traffic(cell["traffic"], root)
    g = cfg["guarantees"]
    reference = specs.reference(cfg["reference"], root)
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    cuda = device.type == "cuda"

    t_imported = time.perf_counter()
    statement = specs.statement(cfg["statement"], root).make(cfg["args"],
                                                              np.random.default_rng([seed, 0]))
    data = program.to_bincode(statement.program)
    params = ProtocolParams(players=g["players"], online_reps=g["online_reps"],
                            total_reps=g["total_reps"])
    t = time.perf_counter()
    ops = load_program_arrays(data)
    key = hashlib.sha256(data).digest()
    if make is not None:
        system = make(statement, ops, params, key, device, reference)
    else:
        system = make_system(ops, params, cache_key=key, device=device,
                             hbm_budget_bytes=cfg.get("hbm_budget_bytes") if cuda else 1 << 40)
    make_system_s = time.perf_counter() - t
    t_system = time.perf_counter()
    mix = driver.Mix(system, statement, mix_spec, seed, int(cfg["reference_sample"]),
                     g["total_reps"], g["online_reps"], root)
    mix.setup()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    print(f"kkwbench: setup_s {setup_s:.3f}: imports {t_imported - t_start:.3f}, statement "
          f"{t - t_imported:.3f}, make_system {make_system_s:.3f}, pool and warm-up "
          f"{setup_s - (t_system - t_start):.3f}", file=sys.stderr)

    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else None
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    import resource

    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    tr = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function, schedule

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            # a warm-up step: without it the first kernels of a window went missing
            mix.call(-1000)
            prof.step()
            with traces.phase_spans():
                start, calls = mix.window(seconds, lambda: record_function(traces.CALL_SPAN))
            prof.step()
        tr = traces.read(prof.profiler.kineto_results.events())
    else:
        start, calls = mix.window(seconds)
    end = calls[-1].t1
    if cuda:
        torch.cuda.synchronize(device)
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else None
    done = sum(c.returned for c in calls)
    asked = sum(c.n for c in calls)
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    per_call = sorted(c.t1 - c.t0 for c in calls)
    print(f"kkwbench: {len(calls)} calls in {end - start:.3f} s, a call {per_call[0]:.4f} / "
          f"{per_call[len(per_call) // 2]:.4f} / {per_call[-1]:.4f} s (least / median / most); "
          f"host user {ru1.ru_utime - ru0.ru_utime:.3f} s, system {ru1.ru_stime - ru0.ru_stime:.3f} s, "
          f"minor faults {ru1.ru_minflt - ru0.ru_minflt}", file=sys.stderr)
    print("kkwbench: calls " + " ".join(f"{c.t1 - c.t0:.3f}" for c in calls), file=sys.stderr)
    w = Window(mix.kind, calls, end - start, done, make_system_s, window_peak, tr,
               program.shape(statement.program), _sm_clock_mhz() if trace and cuda else None)

    rate = {"prove": "proofs_per_s", "verify": "verifies_per_s"}[mix.kind]
    e2e = {"setup_s": setup_s, rate: done / w.seconds}
    units = {m["name"]: m["unit"] for m in spec["end_to_end"]}
    moves = {m["name"]: m for m in spec["end_to_end"]}
    metrics = {}
    if not trace:
        for m in spec["end_to_end"]:
            if "workloads" not in m or cell_name in m["workloads"]:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": units[m["name"]]}
    else:
        for m in spec["per_layer"]:
            if not specs.reports(spec, m, cell_name, moves[m["moves"]]):
                continue
            reader, part = specs.metric(m["name"], root)
            value = reader.read(w, part)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": int(cell["chips"]) if cuda else 1,
           "memory_peak_bytes": max(setup_peak, window_peak) if cuda else None}
    if trace and tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)

    # -- correctness, once the window has closed and the peak is read -------
    wrong = mix.wrong_verdicts()
    t = time.perf_counter()
    wrong_tampered, missing_tampered, kinds = mix.tampered_check()
    if kinds:
        print(f"kkwbench: the tampered call took {time.perf_counter() - t:.3f} s, "
              f"{len(kinds)} tampered: {' '.join(kinds)}", file=sys.stderr)
    sampled = [(job, proof.to_bytes()) for job, proof in mix.compared()]
    del system, mix
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    mismatched = reference_mismatches(reference, statement.program, sampled, g, device)
    peak = f", device peak since the window {torch.cuda.max_memory_allocated(device)} bytes" \
        if cuda else ""
    print(f"kkwbench: the reference proved {len(sampled)} in {time.perf_counter() - t:.3f} s{peak}",
          file=sys.stderr)
    checks = {"mismatched_proofs": (mismatched, "<=", 0),
              "missing_answers": (asked - done + missing_tampered, "<=", 0),
              "wrong_verdicts": (wrong, "<=", 0),
              "wrong_tampered_verdicts": (wrong_tampered, "<=", 0),
              "proofs_compared": (len(sampled), ">=", 1)}
    correct = all(v <= lim if rule == "<=" else v >= lim for v, rule, lim in checks.values())
    result = {"correct": correct, "attempted": asked, "failed": asked - done, "metrics": metrics,
              "device": dev}
    if trace and tr is not None:
        result["breakdown"] = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
    result["checks"] = {k: {"value": v, "rule": rule, "limit": lim}
                        for k, (v, rule, lim) in checks.items()}
    lines = [f"check {k}={v} {rule} {lim}" for k, (v, rule, lim) in checks.items()]
    return result, lines


def reference_mismatches(reference, prog, sampled: list, guarantees: dict, device) -> int:
    """The sampled proofs that differ from the plain reference's proofs of
    the same statements and rep seeds, proved in one call."""
    import numpy as np

    if not sampled:
        return 0
    want = reference.prove(prog, np.stack([j.witness for j, _ in sampled]),
                           np.stack([j.seeds for j, _ in sampled]), device,
                           guarantees["total_reps"], guarantees["online_reps"],
                           reference.plan(prog, device))
    return sum(w != got for w, (_, got) in zip(want, sampled))


def loaded_jax() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches(specs.ROOT)
    import torch

    chips = int(specs.cell(specs.load(), args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"kkwbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    result, lines = run(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = loaded_jax()
    if bad:
        print(f"kkwbench: the process loaded {bad}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
