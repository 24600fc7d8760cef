"""Where the BLAKE3 tail kernel's time goes on the card.

    python -m reverie_tpu_torch.tools.tail_probe

Each case is a hash leg's streams at its R (random node CVs and last
chunks on the card: the kernel's time does not depend on their values):
the GF(2) 1M-AND prove (R = 256), online (40) and preprocessing (216)
verify, and the Z64 50k-MUL prove (256).  For each, one JSON line a launch
plan (`blake3_tail.plan`'s, then others of C columns a block and pieces of
at most 2^k nodes), each with the mean time of 50 launches queued behind a
spin of the card (tail_times.queued_ms) on three builds of
csrc/blake3_tail.cu: the kernel; `pieces`, the kernel stopped after the
pieces are reduced and the last chunks' first blocks hashed (no merge,
fold or pair hash); and `loads`, the kernel whose pieces load their nodes
but do not compress them.  The two cut builds are csrc/blake3_tail.cu
compiled alone with nvcc into _build/probe/, each with the macro of its
cut (BLAKE3_TAIL_CUT_AFTER_PIECES, BLAKE3_TAIL_CUT_COMPRESSIONS, which the
source defines); every plan's output is held to the plain version
(blake3.hash_leg_ref).  Then
one line of a BLAKE3 compression alone: its latency (one warp, a chain of
2,000) and an SM's and the card's rate with 4 to 32 warps an SM.  Then the
card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from reverie_tpu_torch import _build
from reverie_tpu_torch.crypto.kernels import blake3 as b3, blake3_tail as bt
from reverie_tpu_torch.tools._timing import card
from reverie_tpu_torch.tools.tail_times import queued_ms

PROBE_DIR = _build.BUILD_DIR / "probe"

#: (case, stream lengths (pre2, onl2, prez, onlz), R, committed online
#: hashes given, other plans (C, k))
CASES = (("gf2_1M prove", (1_000_000, 1_000_002, 0, 0), 256, False, ((2, 3), (2, 4), (1, 5))),
         ("gf2_1M online", (1_000_000, 1_000_002, 0, 0), 40, False, ((1, 3), (1, 5))),
         ("gf2_1M preprocessing", (1_000_000, 1_000_002, 0, 0), 216, True, ((1, 4), (2, 3))),
         ("z64_50k prove", (0, 0, 400_000, 3_200_016), 256, False, ((2, 4), (2, 6))))

#: the cut builds: (name, the macro that cuts csrc/blake3_tail.cu)
CUTS = (("pieces", "BLAKE3_TAIL_CUT_AFTER_PIECES"), ("loads", "BLAKE3_TAIL_CUT_COMPRESSIONS"))

CHAIN_CU = r"""
#include <cstdint>
#include <cuda_runtime.h>
#include "blake3_core.cuh"
__global__ void chain_kernel(uint32_t* out, int n) {
  uint32_t cv[8], m[16];
  for (int w = 0; w < 8; ++w) cv[w] = threadIdx.x + w;
  for (int i = 0; i < 16; ++i) m[i] = i * (threadIdx.x + 1);
  for (int i = 0; i < n; ++i) compress(cv, m, i, 64u, 4u);
  for (int w = 0; w < 8; ++w) out[(blockIdx.x * blockDim.x + threadIdx.x) * 8 + w] = cv[w];
}
extern "C" int run_chain(void* out, int n, int blocks, int threads, void* stream) {
  chain_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>((uint32_t*)out, n);
  return (int)cudaGetLastError();
}
"""


def build_probes() -> dict:
    """The cut builds and the compression chain, one nvcc each, at once."""
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    chain = PROBE_DIR / "chain.cu"
    chain.write_text(CHAIN_CU)
    builds = {"chain": (chain, [])}
    for name, macro in CUTS:
        builds[name] = (_build.CSRC / "blake3_tail.cu", [f"-D{macro}"])
    procs = {}
    for name, (cu, defines) in builds.items():
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-shared", "-I", str(_build.CSRC),
             "-o", str(PROBE_DIR / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"tail_probe: nvcc {name} failed:\n{log}")
        libs[name] = ctypes.CDLL(str(PROBE_DIR / f"{name}.so"))
    for name in ("pieces", "loads"):
        libs[name].reverie_blake3_tail.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        libs[name].reverie_blake3_tail.restype = ctypes.c_int
    libs["chain"].run_chain.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p]
    return libs


def leg_inputs(dev, gen, lengths, R: int, comm: bool):
    """(the kernel's inputs, the plain version's) of a leg: random node CVs
    and last chunks, or given hashes for onl2 and onlz with comm."""
    legs, plain = [], []
    for i, T in enumerate(lengths):
        if comm and i in (1, 3):
            rows = torch.randint(0, 256, (R, 32), dtype=torch.uint8, device=dev, generator=gen)
            legs.append(rows)
            plain.append(rows)
            continue
        n, rem_len = b3._last_chunk(T)
        levels = [torch.randint(-2**31, 2**31 - 1, (8, n - 1, R), dtype=torch.int32, device=dev,
                                generator=gen)] if n > 1 else []
        rem = torch.randint(0, 256, (max(rem_len, 1), R), dtype=torch.uint8, device=dev,
                            generator=gen)
        legs.append((levels, rem, rem_len))
        plain.append((levels, rem, T))
    return legs, plain


def chain_rows(dev, lib) -> list:
    out = torch.empty(132 * 1024 * 8, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    n, rows = 2000, []
    for blocks, threads in ((1, 32), (1, 128), (1, 512), (132, 512), (132, 1024)):
        ms = queued_ms(lambda: lib.run_chain(out.data_ptr(), n, blocks, threads, stream), dev, 3)
        rows.append({"blocks": blocks, "threads": threads, "us_a_compression": ms * 1e3 / n,
                     "compressions_per_us": blocks * threads * n / (ms * 1e3)})
    return rows


def main() -> int:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    libs = build_probes()
    kernel = _build.kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for name, lengths, R, comm, others in CASES:
        legs, plain = leg_inputs(dev, gen, lengths, R, comm)
        want = torch.cat(b3.hash_leg_ref(*plain), dim=1)
        shapes = tuple(bt._shapes(legs)[1])
        chosen = bt.launch_plan(legs)
        for p in [chosen] + [bt.plan_at(R, shapes, C, k) for C, k in others]:
            if p.threads > bt.MAX_THREADS:
                continue
            hashed = [i for i in (1, 3) if not isinstance(legs[i], torch.Tensor)]
            words, out, hashes, _ = bt.launch_words(legs, hashed, p=p)
            row = {"case": name, "R": R, "plan": p.line(), "chosen": p == chosen}
            for build, lib in (("kernel", kernel), ("pieces", libs["pieces"]),
                               ("loads", libs["loads"])):
                def launch(lib=lib):
                    _build.check(lib.reverie_blake3_tail(words.ctypes.data, stream), build)
                row[f"{build}_ms"] = queued_ms(launch, dev, 50)
                if build == "kernel":
                    got = torch.cat([out, hashes.get(1, legs[1]), hashes.get(3, legs[3])], dim=1)
                    row["equal_to_plain"] = bool(torch.equal(got, want))
            print(json.dumps(row), flush=True)
            if not row["equal_to_plain"]:
                raise AssertionError(f"tail_probe: {name} {p.line()} disagrees with hash_leg_ref")
        del legs, plain
        torch.cuda.empty_cache()
    print(json.dumps({"compression": chain_rows(dev, libs["chain"])}), flush=True)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
