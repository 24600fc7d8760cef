"""K3's time on the card (csrc/blake3_chunks.cu, `blake3.chunk_cvs`) at the
port's shapes, to set two trees side by side in one call.

    python -m reverie_tpu_torch.tools.k3_times            # the kernel at each case
    python -m reverie_tpu_torch.tools.k3_times --probe    # and its cut builds

The cases: the GF(2) 1M-AND streams (976 whole chunks) proved at R = 256,
verified online at 40 and preprocessing at 216, and a batch of 8 proofs
(2,048); the Z64 50k-MUL prez and onlz streams (390 and 3,125 chunks) at
256; the SHA-256 statement's pre2 and onl2 (21 and 22 chunks) in a chunk of
64 proofs (16,384); a streamed absorb (30 chunks at chunk base 600) at 256
and 40; the mesh's shard widths 3, 4, 18, 21 and 22 (12 shards of 256, 40
and 216 lanes) at 976 chunks; the prove's shape on a buffer one byte past a
16-byte boundary.  Each case's bytes are random, made on the card from its
own seed, so two trees hash the same bytes.  One JSON line a case: three
means of 20 launches queued behind a spin of the card (tail_times.queued_ms),
the launches a call, the bound (roofline.bound_ms of the bytes read and
written and BLAKE3_COMPRESSION_INT_OPS a compression, as chip_smoke.py
counts them), a digest of the output (equal on two trees that agree) and,
where the package has it, the launch plan.  The last line is the card's
name and power limit.

The module imports its own package by name and uses only what K3 had
before its plan, so another tree's package can be timed with this file
(from that tree's root):

    PYTHONPATH=. python <this tree>/reverie_tpu_torch/tools/k3_times.py

--probe (this tree only) splits the kernel's time: each case at its plan
and at other plans, on the kernel and on two builds of csrc/blake3_chunks.cu
compiled alone with nvcc into _build/probe/, each with the macro of its
cut: `reads`, the rows staged and read but not compressed
(BLAKE3_CHUNKS_CUT_COMPRESSIONS), and `compressions`, words made in
registers compressed and no rows copied (BLAKE3_CHUNKS_CUT_READS).  The
kernel's output at every plan is held to the plan's.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys

import torch

from reverie_tpu_torch import _build
from reverie_tpu_torch.crypto.kernels import blake3 as b3
from reverie_tpu_torch.roofline import BLAKE3_COMPRESSION_INT_OPS, bound_ms
from reverie_tpu_torch.tools._timing import card, max_sm_clock_mhz
from reverie_tpu_torch.tools.tail_times import queued_ms

#: (case, R, chunks, chunk base, the buffer's bytes past a 16-byte boundary)
CASES = (("gf2_1M prove", 256, 976, 0, 0), ("gf2_1M online", 40, 976, 0, 0),
         ("gf2_1M preprocessing", 216, 976, 0, 0), ("gf2_1M batch of 8", 2048, 976, 0, 0),
         ("z64_50k prez", 256, 390, 0, 0), ("z64_50k onlz", 256, 3125, 0, 0),
         ("sha256 pre2 chunk of 64", 16_384, 21, 0, 0),
         ("sha256 onl2 chunk of 64", 16_384, 22, 0, 0),
         ("streamed absorb", 256, 30, 600, 0), ("streamed absorb online", 40, 30, 600, 0),
         ("shard 3", 3, 976, 0, 0), ("shard 4", 4, 976, 0, 0), ("shard 18", 18, 976, 0, 0),
         ("shard 21", 21, 976, 0, 0), ("shard 22", 22, 976, 0, 0),
         ("gf2_1M prove, buffer 1 byte past 16", 256, 976, 0, 1))

#: --probe: (case, other plans (route, chunks a tile, stages; None: the plan's))
PROBE_CASES = (("gf2_1M prove", ((0, 1, None), (3, 1, 2), (3, 1, 4))),
               ("gf2_1M online", ((0, 4, None),)), ("gf2_1M preprocessing", ((0, 1, None),)),
               ("gf2_1M batch of 8", ((4, 1, None),)), ("sha256 onl2 chunk of 64", ((4, 1, None),)),
               ("streamed absorb", ((0, 1, None),)), ("shard 21", ((0, 1, None),)))

PROBE_DIR = _build.BUILD_DIR / "probe"
#: the cut builds: (name, the macro that cuts csrc/blake3_chunks.cu)
CUTS = (("reads", "BLAKE3_CHUNKS_CUT_COMPRESSIONS"), ("compressions", "BLAKE3_CHUNKS_CUT_READS"))


def case_buffer(dev, R: int, n: int, offset: int, seed: int) -> torch.Tensor:
    """(n * 1024, R) random bytes on the card, `offset` bytes into a flat
    allocation (a 16-byte-aligned one)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    flat = torch.randint(0, 256, (n * b3.CHUNK_LEN * R + offset,), dtype=torch.uint8,
                         device=dev, generator=gen)
    return flat[offset:].view(n * b3.CHUNK_LEN, R)


def case_bound(R: int, n: int, clock: float):
    """(ms, "bytes" or "operations"): the buffer's n * 1024 rows read once,
    the (8, n, R) CVs written once, 16 compressions a (chunk, column)."""
    return bound_ms(n * b3.CHUNK_LEN * R + 8 * n * R * 4,
                    n * R * 16 * BLAKE3_COMPRESSION_INT_OPS, clock)


def digest(out: torch.Tensor) -> str:
    return hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]


def times(dev, clock: float) -> None:
    for i, (name, R, n, base, offset) in enumerate(CASES):
        buf = case_buffer(dev, R, n, offset, seed=100 + i)
        fn = lambda: b3.chunk_cvs(buf, n, base)  # noqa: E731
        n0 = b3.LAUNCHES
        out = fn()
        launches = b3.LAUNCHES - n0
        ms = [queued_ms(fn, dev, 20) for _ in range(3)]
        bound, by = case_bound(R, n, clock)
        row = {"case": name, "R": R, "n": n, "chunk_base": base, "offset": offset,
               "launches": launches, "ms": ms, "bound_ms": bound, "bound_by": by,
               "bound_share": bound / min(ms), "digest": digest(out)}
        if hasattr(b3, "launch_plan"):
            row["plan"] = b3.launch_plan(buf, n).line()
        print(json.dumps(row), flush=True)
        del buf, out
        torch.cuda.empty_cache()


def build_cuts() -> dict:
    """The cut builds, one nvcc each, at once."""
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, f"-D{macro}", "-shared", "-I", str(_build.CSRC),
         "-o", str(PROBE_DIR / f"k3_{name}.so"), str(_build.CSRC / "blake3_chunks.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for name, macro in CUTS}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"k3_times: nvcc {name} failed:\n{log}")
        lib = ctypes.CDLL(str(PROBE_DIR / f"k3_{name}.so"))
        lib.reverie_blake3_chunk_cvs.argtypes = \
            _build.kernels().reverie_blake3_chunk_cvs.argtypes
        lib.reverie_blake3_chunk_cvs.restype = ctypes.c_int
        libs[name] = lib
    return libs


def probe(dev, clock: float) -> None:
    libs = {"kernel": _build.kernels(), **build_cuts()}
    sms, registers = b3.card(dev.index or 0)
    by_name = {c[0]: (i, c) for i, c in enumerate(CASES)}
    for name, others in PROBE_CASES:
        i, (_, R, n, base, offset) = by_name[name]
        buf = case_buffer(dev, R, n, offset, seed=100 + i)
        chosen = b3.launch_plan(buf, n)
        want = b3.chunk_cvs(buf, n, base)
        plans = [chosen] + [b3.plan_at(R, n, chosen.delta, route, ct, st, sms, registers)
                            for route, ct, st in others]
        for p in plans:
            out = torch.empty_like(want)
            row = {"case": name, "R": R, "n": n, "plan": p.line(), "chosen": p == chosen,
                   "cost": p.cost, "bound_ms": case_bound(R, n, clock)[0]}
            for build, lib in libs.items():
                row[f"{build}_ms"] = queued_ms(lambda: b3.launch(buf, n, base, out, p, lib), dev,
                                               20)
                if build == "kernel":
                    torch.cuda.synchronize(dev)
                    row["equal"] = bool(torch.equal(out, want))
            print(json.dumps(row), flush=True)
            if not row["equal"]:
                raise AssertionError(f"k3_times: {name} {p.line()} disagrees with the chosen plan")
        del buf, want
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    dev = torch.device("cuda")
    clock = max_sm_clock_mhz()
    times(dev, clock)
    if "--probe" in argv:
        probe(dev, clock)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
