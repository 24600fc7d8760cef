"""The program's annotations for torch.profiler: a named range entered only
while a profiler records, so that with none a range costs one check.

`annotate(name)` is `torch.profiler.record_function(name)` under a running
profiler and a shared no-op context otherwise; `entry` gives a method a
root range of its own name (the port's entry calls: prove_batch,
verify_many, ...).  An ungated record_function costs ~12 µs a range on a
CPU, the check ~0.1-0.25 µs."""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.profiler import record_function

#: whether a torch.profiler is recording in this process
enabled = torch._C._autograd._profiler_enabled

NOTHING = contextlib.nullcontext()


def annotate(name: str):
    """record_function(name) while a profiler records, else NOTHING."""
    return record_function(name) if enabled() else NOTHING


def entry(method):
    """`method` run inside annotate(its name): an idle gap of the card
    inside the call is then named by a range of the program's own."""
    name = method.__name__

    @functools.wraps(method)
    def wrapped(*args, **kwargs):
        with annotate(name):
            return method(*args, **kwargs)

    return wrapped
