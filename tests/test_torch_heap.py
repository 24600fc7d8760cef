"""host.keep_freed_heap, which make_system calls: once it has run, the heap
that a prove call's freed openings leave stays with the process, and the
next call's openings are made in it, where by default glibc gives that heap
back to the system and faults every page in again.  Read from glibc's own
account of its heap (mallinfo2), not from page-fault counters, which some
virtual machines do not keep.  The probe runs in a process of its own,
since the setting holds for the whole process.  And host.rows_to_bytes, the
copy that makes the openings bytes: the bytes of tobytes, row by row."""

import subprocess
import sys

import numpy as np
import pytest

#: three rounds of the openings of 128 opened reps of a 50k-word z64 stream
#: (400,000 bytes each), made bytes and freed as a call's proofs are; prints
#: mallopt's answers, then a line a round: the heap glibc holds from the
#: system while the round's bytes live, and the free heap it keeps after
#: they go
PROBE = """
import ctypes
import numpy as np
from reverie_tpu_torch.backend import host

libc = ctypes.CDLL(None)
new = hasattr(libc, "mallinfo2")
field = ctypes.c_size_t if new else ctypes.c_int
class Info(ctypes.Structure):
    _fields_ = [(n, field) for n in ("arena", "ordblks", "smblks", "hblks", "hblkhd",
                                     "usmblks", "fsmblks", "uordblks", "fordblks", "keepcost")]
info = libc.mallinfo2 if new else libc.mallinfo
info.restype = Info
print(host.keep_freed_heap(), host.keep_freed_heap())
rows = np.ones((128, 400_000), np.uint8)
for _ in range(3):
    out = host.rows_to_bytes(rows)
    held = info().arena
    del out
    print(held, info().fordblks)
"""


@pytest.mark.skipif(not sys.platform.startswith("linux"), reason="glibc's mallopt")
def test_freed_heap_is_reused():
    run = subprocess.run([sys.executable, "-c", PROBE], capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0, run.stderr
    lines = run.stdout.split("\n")
    assert lines[0] == "True True"  # both thresholds set, the second call cached
    rounds = [tuple(map(int, line.split())) for line in lines[1:4]]
    # the 51.2 MB of a round's bytes stay as free heap once they are freed
    assert all(free >= 128 * 400_000 for _, free in rounds)
    # and the next rounds are made in it: the heap does not grow again
    assert rounds[2][0] == rounds[1][0] <= rounds[0][0] + (1 << 20)


def test_make_system_sets_the_heap_and_the_prover_does_not(monkeypatch):
    """The thresholds are the process's: make_system, where a proving
    process starts, sets them; making a TorchKKW alone leaves them."""
    import torch

    from reverie_tpu_torch import TorchKKW, make_system
    from reverie_tpu_torch.backend import host
    from reverie_tpu_torch.circuit.builders import mul_bench_circuit

    calls = []
    monkeypatch.setattr(host, "keep_freed_heap", lambda: calls.append(1) or True)
    prog = mul_bench_circuit(8)[0]
    TorchKKW(prog, device=torch.device("cpu"))
    assert calls == []
    make_system(prog, device=torch.device("cpu"), hbm_budget_bytes=1 << 30)
    assert calls == [1]


@pytest.mark.parametrize("shape, step", [((0, 5), 1), ((3, 0), 1), ((1, 1), 1), ((7, 13), 1),
                                         ((50, 90), 3), ((40, 100_003), 1), ((9, 400_008), 2)])
def test_rows_to_bytes_equals_tobytes(shape, step):
    """Each row's bytes, whether the caller's thread copies them all (under
    COPY_ALONE_BYTES) or the pool does (the last two shapes), from a
    contiguous array or from every step-th column of one."""
    from reverie_tpu_torch.backend import host

    rows = np.random.RandomState(sum(shape)).randint(0, 256, shape, dtype=np.uint8)[:, ::step]
    got = host.rows_to_bytes(rows)
    assert got == [r.tobytes() for r in rows]
    assert all(type(b) is bytes for b in got)
