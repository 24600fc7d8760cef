"""reverie_tpu_torch -- the PyTorch / CUDA (H100) port of reverie_tpu.

`TorchKKW` proves and verifies GF(2), Z_2^64 and B2A circuits on one CUDA
card, or sharded over the cards and processes of a mesh (`parallel`), one
proof at a time or in batches and pipelines (`prove_batch`,
`prove_batch_chunked`, `prove_many`, `verify_many`; `device_footprint`,
`pipeline_footprint` and `largest_batch` size a batch).  `StreamingKKW`
proves and verifies a circuit segment by segment in O(segment) device
memory, and `make_system` picks the one of the two that fits a device
budget.  The AES-CTR mask tapes, the BLAKE3 chunk chaining values and the
wave executor are hand-written CUDA kernels (`csrc/`), the levelized
executor and the hash tail are plain torch.  Proofs are byte-identical to
reverie_tpu's.

The package stands on its own: it imports neither jax nor reverie_tpu.  It
keeps its own copies of the circuit IR, compiler, builders and bincode
(`circuit/`), the proof container and Fiat-Shamir challenge (`proof/`), the
protocol parameters (`params.py`) and the host C crypto (`crypto/`,
`native/`).  Programs and proofs cross between the two packages as bytes:
`circuit.load_program(reverie_tpu.circuit.dumps_program(p))` and
`proof.Proof.from_bytes(p.to_bytes())`.

`python -m reverie_tpu_torch.cli` is the command line (reverie_tpu's
`cli.py`: prove, verify, oneshot, oneshot-zk, version_info) on
`make_system`, reading a bincode program file into arrays in C
(`circuit.bincode.load_program_arrays`) and caching its whole compile
on disk (REVERIE_COMPILE_CACHE).  `tools/` holds the measurement probes
(the ports of reverie_tpu's `tools/r2_measure.py`, `r4_bwroof.py`,
`r5_u8emit.py` and `r4_extract_probe.py`) with their CUDA kernels, and
the CLI's helpers `make_sha256_statement` and `inspect_proof`.
"""

import os

import torch

from .backend.host import TorchKKW, device_footprint, largest_batch, pipeline_footprint
from .backend.streaming import StreamingKKW
from .device import default_device
from .params import DEFAULT_PARAMS

__version__ = "0.1.0"

__all__ = ["StreamingKKW", "TorchKKW", "default_device", "device_footprint", "largest_batch",
           "make_system", "pipeline_footprint"]

#: the free device memory a budget taken from the card leaves unplanned:
#: a budget of free / FREE_MARGIN keeps a peak up to 1.06x its
#: device_footprint inside the free bytes (measured peaks reached 1.0543x
#: the model, PERF.md section 5)
FREE_MARGIN = 1.06
#: the share of the budget a streamed segment's device_footprint takes
SEGMENT_SHARE = 1 / 8


def device_budget(device, hbm_budget_bytes=None) -> int:
    """The device bytes make_system plans for: hbm_budget_bytes, else the
    environment's REVERIE_HBM_BUDGET, else the card's free bytes
    (torch.cuda.mem_get_info) / FREE_MARGIN.  A CPU device has no free
    bytes to read: ValueError without one of the first two."""
    if hbm_budget_bytes is not None:
        return int(hbm_budget_bytes)
    if os.environ.get("REVERIE_HBM_BUDGET"):
        return int(os.environ["REVERIE_HBM_BUDGET"])
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"make_system: no device budget on {device}; pass "
                         "hbm_budget_bytes or set REVERIE_HBM_BUDGET")
    free, _ = torch.cuda.mem_get_info(device)
    return int(free / FREE_MARGIN)


def make_system(program, params=DEFAULT_PARAMS, mesh=None, hbm_budget_bytes=None,
                cache_key=None, *, device=None):
    """The prover and verifier for a circuit's size (reverie_tpu's
    make_system, its positional arguments in its order): a `TorchKKW` when
    its device_footprint at the full R fits the budget of one device
    (device_budget), else a `StreamingKKW` whose segments take about
    SEGMENT_SHARE of the budget each by their device_footprint.  Both give
    the same proof bytes.  `program` is a list of the port's op objects or
    a program's OpArrays (circuit.bincode.load_program_arrays: a program
    file read with no op objects).  `cache_key` names the program for the
    disk cache of its whole compile (compile.compile_program; the CLI's is
    a hash of the program file); the streaming route compiles segments
    and ignores it, as reverie_tpu's does.  `device`, keyword-only,
    defaults to the CUDA device; with a `mesh` (reverie_tpu_torch.parallel)
    the system shards over it, and the budget is read on its first device
    of this process.

    The program is lowered to arrays once (compile_native.OpArrays) and its
    counters and depth read without tables (analyze): a circuit whose lower
    bound of the footprint (host.lower_footprint) passes the budget goes
    to streaming with no whole compile, each op compiled once, in
    segments sized by the one before (sized_segments).  Otherwise it is
    compiled whole, and streamed only if its footprint passes the budget
    after all (the one case that compiles its ops twice).

    It also sets the process's heap thresholds (host.keep_freed_heap, once
    a process): a prover's calls return their openings as fresh `bytes`
    (~32 MB a proof of 50k Z_2^64 MULs), and by default glibc hands the
    freed heap back after each call and faults it in again on the next.
    A process that makes its system with TorchKKW or StreamingKKW directly
    keeps the C library's defaults."""
    from .backend.host import Lanes, check_program, keep_freed_heap, lower_footprint
    from .backend.streaming import sized_segments
    from .circuit.compile_native import analyze, compile_program, encode_program

    ops = encode_program(program)
    check_program(ops)
    keep_freed_heap()
    lanes = Lanes(mesh, device)
    budget = device_budget(lanes.device, hbm_budget_bytes)
    # the system is made on the mesh, or else on the one device
    where = dict(mesh=mesh) if mesh is not None else dict(device=lanes.device)
    R = params.total_reps
    footprint = lower_footprint(analyze(ops), R)
    if footprint <= budget:
        cc = compile_program(ops, cache_key=cache_key)
        footprint = device_footprint(cc, R)
        if footprint <= budget:
            return TorchKKW(ops, params=params, cc=cc, **where)
        del cc
    segments, seg_ops = sized_segments(ops, budget * SEGMENT_SHARE,
                                       footprint / max(len(ops), 1), R)
    return StreamingKKW(ops, seg_ops, params=params, segments=segments, **where)
