"""Device timing shared by the probes."""

from __future__ import annotations

import json
import subprocess
from typing import Callable, Optional

import torch


def cuda_ms(fn: Callable[[], object], device: torch.device, reps: int = 5) -> Optional[float]:
    """Mean stream time of fn() over `reps` runs after one warm-up, from
    CUDA events; None off a CUDA device (no device time is measured on the
    CPU)."""
    if device.type != "cuda":
        return None
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def gbps(n_bytes: float, ms: Optional[float]) -> Optional[float]:
    return None if ms is None else n_bytes / ms / 1e6


def _smi(query: str, fmt: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return _smi("name,power.limit", "csv,noheader")


def max_sm_clock_mhz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm), in MHz."""
    return float(_smi("clocks.max.sm", "csv,noheader,nounits"))


def print_results(rows) -> None:
    """One JSON line per result row, then the card's line."""
    for row in rows:
        print(json.dumps(row), flush=True)
    print(card(), flush=True)
