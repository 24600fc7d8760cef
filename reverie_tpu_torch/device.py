"""Device selection for the port: the GPU path is asked for explicitly and
never falls back to the CPU."""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The CUDA device; raises when CUDA is absent.  CPU runs (the tests'
    plain path) pass `device=torch.device("cpu")` themselves."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "reverie_tpu_torch: the GPU path was asked for but "
            "torch.cuda.is_available() is false")
    return torch.device("cuda")
