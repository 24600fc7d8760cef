"""Smoke test of reverie_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero and
prints no result line:

  1. the card: its name, its name and power limit and its maximum SM clock
     from nvidia-smi;
  2. the build of the CUDA kernels (csrc/*.cu, one nvcc per source in
     parallel, for sm_90a, with each kernel's registers, spills and static
     shared memory from ptxas -v) and of the host C crypto (native/*.c,
     gcc), timed;
  3. each of the seven tape, hash and probe kernels against its plain
     PyTorch version on the card, byte for byte, with its time, the plain
     version's, a library call's where one computes the same function (all
     from CUDA events) and its bound: the GF(2) tape at m2 = 2,000,002 and the z64 tape at
     mz = 100,002, each at the three legs' R (256, 40 with random omits,
     216) with its launch plan, the BLAKE3 chunks (K3: at the prove's
     shape, then on each route of its plan — widths, buffers past a
     16-byte boundary, one chunk, chunk bases crossing 2^32 — and timed
     at R = 40, 216, 2,048 and 16,384, each with its plan), then the
     per-column hash against the host C blake3; the keystream planes
     (B = 15,626, 2,048 keys) with its launch plan, the copy (512 MB in
     u8 and in u32), the u32 -> u8 emission (T = 1,000,001, both orders)
     and the pack-shift (1,000,002 x 256, random shifts);
  4. the GF(2) main path: TorchKKW(mul_bench_circuit(1_000_000)).prove,
     then .verify (True), and a proof with one flipped byte in a GF(2)
     online opening (False), with the kernels' launch counts of that run
     (K1, K3 and the BLAKE3 tail in every leg); then a warm prove and
     verify with the tail kernel and with the torch tail (torch_tail: the
     plain versions routed in, as the port ran them before the tail
     kernel) in turns, kernel, torch, torch, kernel, their hash, onl_hash
     and pre_hash ms (the same in phases 6, 8 and 9);
  5. byte parity at 50,000 AND gates with reverie_tpu's NumPy golden
     prover, through the digest committed in reverie_tpu_torch/parity.py;
  6. the Z64 main path: TorchKKW(z64_mul_bench_circuit(50_000)), the same
     legs, a flipped byte in a z64 online opening (False), and the z64 tape
     kernel launched in the prove, the online and the preprocessing verify;
  7. Z64 parity: 2,000 Z64 MULs equal to the golden's digest; then the
     BLAKE3 tail kernel (csrc/blake3_tail.cu) against the torch tail,
     byte for byte, on K3's chunk CVs of random streams: a hash leg (the
     four streams and the pair hashes in one launch, with and without the
     committed online hashes) on phases 4, 6 and 8's circuits' streams at
     R = 256, 40 and 216, the GF(2) 1M-AND's at 2,048, SHA-256's at
     16,384, the mesh's shard widths and 0, with each launch plan; one
     stream's hash at the same lengths, an empty stream, a partial and a
     whole chunk; a streamed hasher's CV stack and the tree on it, and
     four hashers' leg; the pair hashes at each R; the leg timed with its
     bound at the GF(2) 1M prove (R = 256), one stream's hash beside it;
  8. the SHA-256 phase, on reverie_tpu's SHA-256 preimage statement
     (parity.sha256_bench; 5,198 levels, pure GF(2), so TorchKKW runs it on
     the wave executor): the wave kernel (csrc/scan_gf2.cu) through the
     executors' slot-allocated programs against its plain version on the
     SSA tables, byte for byte, in each role (R = 256, 40 with random omits
     and online inputs, 216) and at one chunk of 64 proofs (R = 16,384),
     each timed with its bound and its launch plan (reps and shared memory
     per block, resident blocks, slots in shared memory and spilled), the
     three block widths at R = 256 and 16,384, the dependency chain alone,
     and a spill case (the two-block statement at 32 reps a block); the
     kernel's ptxas registers and spills; the levelized
     Executor on the same inputs (equal streams and fail, its time and the
     torch ops it dispatches); then TorchKKW's prove (equal to the golden's
     committed digest), verify, a tampered proof (False) and the wave
     kernel launched in each leg's executor; prove_batch_chunked of 512
     proofs at chunk 64 (bench.py's config 5), proofs 0, 63, 64 and 511
     equal to prove()'s, verify_many of 8, proofs/s, per-proof hash and the
     peak memory against pipeline_footprint (at most 1.25x);
  9. the deep z64 phase (z64_wave_phase), on reverie_tpu's deep-scan test
     statements, deeper than 128 levels, so that TorchKKW runs them on the
     wave executor's W2 (csrc/scan_z64.cu): the serial z64 MUL chain at
     5,000 MULs (depth 5,004), every z64 kind on a 200-level accumulator
     and deep B2A (mixed_b2a with a 200-MUL GF(2) chain), and 64 z64
     chains side by side (150 MULs each: build_waves' widest z64 waves,
     one wave a staged chunk).  W2 through the
     executors' slot-allocated programs against its plain version on the
     SSA tables, every stream and fail byte for byte, in each role (R =
     256, 40 with random omits and records, 216, and 2,560 on one lane a
     z64 slot), at a ragged R (37) and
     with its values spilled, each timed with its bound and launch plan
     (with its staged z64 chunk: bytes, words and bits rows a chunk, lanes
     a z64 slot, and the kernel's own count of a block's shared memory,
     which must equal the host's and fit 232,448 bytes), beside the
     levelized Executor on the same inputs (equal outputs, its ms and
     torch ops); the chain at R = 16,384 (a 10.5 GB tape) against
     the plain version 256 columns at a time; the chain in three segments,
     each through W2 with its carries chained, against the plain version
     (R = 256, and 2,560 on one lane a z64 slot);
     then, with the launches counted from 0, the chain's TorchKKW prove,
     verify, a tampered proof and W2 in every leg's executor, its proof
     on the waves equal to the levelized route's, prove_batch of N chain
     proofs (N from largest_batch, at most 64; peak memory at most 1.25x
     device_footprint), and tests/golden/b2a_proof.bin reproduced from
     b2a_seeds.bin on W2 (190 levels);
 10. the streaming phase (streaming_phase), with the launches counted
     from 0 over its streamed runs: make_system with no budget on the 1M-AND
     circuit (a TorchKKW, the budget it took from mem_get_info), then
     make_system(..., hbm_budget_bytes=512 MiB) on it and 1 GiB on the 50k
     Z64 MULs, each a StreamingKKW (~31 and ~33 segments) whose proof equals
     TorchKKW's with the same seeds; SHA-256 in thirds (each segment deeper
     than 128 levels, W1 with carries; the proof equal to the sha256_1block
     digest) and the 5,000-MUL z64 chain in segments of 1,000 ops (W2 with
     carries; equal to TorchKKW's).  For each: a cold and a warm prove,
     verify (True), a flipped online byte (False), walls and last_timings,
     segments, launches, and the peak max_memory_allocated over all of it,
     at most the budget where make_system had one.  Before them K1 and K4
     at a middle segment's tape window (start_block > 0, R = 256 and 40
     with random omits) and K3 at its onl2 chunk base, each against its
     plain version; then the 1M-AND and 50k-MUL systems' warm proves with
     the tail kernel and the torch tail in turns (kernel, torch, torch,
     kernel), pass1 and hash_final by route; K1, K3, K4, the tail, W1 and
     W2 must each launch in the phase;
 11. the batch phase, on each main-path circuit: N from largest_batch
     (pipeline_footprint and the free memory; 8 proofs of 1M ANDs and 4 of
     50k Z64 MULs where a chunk of that many fits); prove() N times, prove_batch
     and prove_many of N distinct witnesses and seeds, a first run of each
     and then two rounds in opposite orders, every proof byte-equal to
     prove()'s and verified by verify_many, with walls, proofs/s, phase
     times, the main thread's CPU time, Python's collections and the new
     pinned host blocks of each run, the host's write rate into fresh and
     into rewritten memory, the proof size, and the peak memory of a warm
     prove() and of the batch against device_footprint (at most 1.25x);
     the 50k-AND and 2,000-MUL parity
     digests reproduced as proof 0 of a batch of 3; prove_batch_chunked of
     6 1M-AND proofs at chunk 4 (a ragged second chunk); verify_many of
     good, tampered, malformed and good proofs ([True, False, False,
     True]); then the GF(2) and z64 tapes and the chunk CVs at the batch
     width, past 2**31 bytes, each block of 256 columns equal to the plain
     version on the same inputs (and to the kernel's launch at R = 256);
 12. the probes (reverie_tpu_torch/tools: r2_measure at B = 15,626,
     r4_bwroof, r5_u8emit, r4_extract_probe at the tools' shapes), with the
     launches of the planes, copy, emission and pack-shift kernels in them;
 13. the CLI phase (cli_phase): `python -m reverie_tpu_torch.cli` as
     subprocesses on the card with its default backend (make_system), in a
     temporary directory, each with its wall.  One at a time: the SHA-256
     statement of parity.SHA256_MESSAGE (written by
     tools/make_sha256_statement) proved and verified (Ok(())); the
     1M-AND program and its witness from files, proved and verified.
     Seven at once: the SHA-256 statement proved in thirds
     (--segment-ops: W1 with carries), a flipped byte in a GF(2) online
     opening rejected (rc 1, "Unverifiable Proof", no traceback), oneshot,
     tests/golden/b2a_proof.bin verified (W2, K4), a 64-bit ripple-carry
     adder in Bristol format with its right output (rc 0) and a wrong one
     (non-zero), tools/inspect_proof.  A fresh process's start (import
     torch, the CLI, the kernels' library, CUDA), and cli.main in this
     process on the SHA-256 and 1M-AND files, split into load_program,
     make_system, prove and the rest; the first with os.urandom giving the
     sha256_1block seeds, its launches counted from 0 (K1, K3, the tail
     and W1 must launch) and its proof equal to the golden's digest; the 1M-AND one
     with the compile cache off (a compile) and on (a pickle load of the
     entry the prove subprocess wrote); the
     subprocesses' proof files (SHA-256, streamed too, and 1M-AND) read
     with Proof.from_bytes and verified here by the TorchKKW make_system
     gave;
 14. the mesh phase (mesh_phase): the lanes of every stage sharded over
     a mesh of shards on cuda:0 (reverie_tpu_torch.parallel), each path's
     launches counted from 0 just before it and read just after.  4
     shards: phase 4's circuit and seeds, the proof equal to phase 4's,
     verify True, a flipped byte False, sharded and unsharded walls in
     turns with their phases, the launches per kernel, the peak memory
     against device_footprint (at most 1.25x); the 50k-AND golden digest.
     12 shards (dividing none of 256, 40, 216): the SHA-256 statement
     equal to its digest (W1) and tests/golden/b2a_proof.bin (W2), and K1,
     K4, K3, W1 and W2 against their plain versions at the shard widths
     (R = 22, 21, 4, 3, 18 in their roles).  48 shards (more than the 40
     online reps) on 200 ANDs.  make_system at 512 MiB on 4 shards (1M
     ANDs, equal to phase 4's proof, the peak within the budget) and the
     z64 chain in 1,000-op segments on 4 shards (W2 with carries).  Two
     processes on cuda:0 (this script with --mesh-child, gloo over
     loopback): a global-mesh 1M-AND proof equal to phase 4's, verified in
     both, and prove_batch_distributed of 8 and 7 SHA-256 statements, each
     proof equal to TorchKKW.prove's with its seeds.  With two cards, 4
     shards' case again on make_mesh(2); else a line that it was skipped.
     K1, K3, K4, the tail, W1 and W2 must each launch;
 15. the past-the-card phase (past_card_phase): make_system with no
     budget on circuits larger than the card, each in a fresh process
     (reverie_tpu_torch.tools.past_card, after torch.cuda.empty_cache()
     here, so that its free memory and host peak RSS are its own):
     mul_bench_circuit(48,000,000) (K1, K3, the levelized executor) and
     z64_mul_bench_circuit(1,200,000) (K4, K3).  For each: the whole
     circuit's device_footprint beside the device_budget (it must be
     larger), the StreamingKKW make_system must return, its segments and
     seg_ops, the setup split (build, make_system), cold and warm prove
     walls with last_timings, verify (True), a flipped byte in an online
     opening (False), the peak max_memory_allocated (at most the budget),
     the host's peak RSS, and the launches of K1, K3, K4 and the tail
     counted from 0 (the tail must launch in each case);
     the case's tape kernel at the last segment's window (the largest
     start_block) and K3 at its chunk base against their plain versions;
     a cut (4,000,000 ANDs, 100,000 MULs) under the budget scaled by the
     cut, streamed, its proof byte-equal to TorchKKW's;
 16. the CLI past the card (past_cli_phase): tools/past_card.py's cli case
     as a fresh process: mul_bench_circuit(48,000,000) written as a
     bincode file by the C writer (its 1M-AND cut's SHA-256 equal to
     dumps_program's), then `python -m reverie_tpu_torch.cli` on it in
     fresh processes with no budget, each split into import torch,
     load_program (the file read into arrays in C), make_system, prove or
     verify and the write or read: prove, verify (Ok(()), rc 0) and
     verify of a copy with a flipped byte in a preprocessing opening's
     comm_online (rc 1), each with its host peak RSS (at most 16 GB), its
     peak against the budget and K1's, K3's and the tail's launches (each
     must launch); on a 4M-AND cut under the budget scaled by the cut, the
     CLI's proof file equal to StreamingKKW's from mul_bench_circuit's list;
 17. one JSON line of kernels, the nvidia-smi line, and the last line
     {"ok": true, "device": {...}}.

Every CLI process of the run keeps its compile cache (REVERIE_COMPILE_CACHE)
in a temporary directory of the run, removed at its end.

Imports nothing of JAX or reverie_tpu.  Needs the CUDA toolkit (nvcc), gcc
and one card.  `python3 chip_smoke.py --mesh-child RANK N PORT DIR` is one
process of phase 14's two-process case, started by the phase itself.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import gc
import io
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: the GF(2) main path's sizes (bench config 4: 1M AND gates, 256 reps)
N_MUL = 1_000_000
M2 = 2 * N_MUL + 2  # tape slots of mul_bench_circuit(N_MUL)
T_STREAM = N_MUL + 2  # onl2 rows of mul_bench_circuit(N_MUL)
REPS = (256, 40, 216)  # prove, online verify, preprocessing verify
#: the Z64 main path's sizes (bench.py's z64 cell, BASELINE config 3)
N_MUL_Z64 = 50_000
MZ = 2 * N_MUL_Z64 + 2  # z64 tape slots of z64_mul_bench_circuit(N_MUL_Z64)
ONLZ = 64 * N_MUL_Z64 + 16  # onlz rows of z64_mul_bench_circuit(N_MUL_Z64)
ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"
#: the probes' shapes (reverie_tpu's tools)
PLANES_BLOCKS = 15_626  # r2_measure at the 1M tape: 2,048 keys
EMIT_T = 1_000_001  # r5_u8emit at the 1M tape
PACK_N, PACK_R = 1_000_002, 256  # r4_extract_probe
KEY_BYTES = 176  # AES-128 round keys per key
#: the batch phase: the most a measured peak may exceed device_footprint by
PEAK_OVER_FOOTPRINT = 1.25


def log(tag: str, msg: str) -> None:
    print(f"[{tag}] {msg}", flush=True)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest absolute difference of two integer tensors, over their bytes
    for int64 (a difference of two int64 can overflow)."""
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if torch.equal(a, b):
        return 0
    if a.dtype == torch.int64:
        a, b = a.view(torch.uint8), b.view(torch.uint8)
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def timed(res: dict, kernel, plain, library=None) -> str:
    """Time kernel, plain version and library call into res (mean stream
    ms from CUDA events after a warm-up; the plain version once); the log
    text."""
    from reverie_tpu_torch.tools._timing import cuda_ms

    dev = torch.device("cuda")
    res["ms"] = cuda_ms(kernel, dev)
    res["plain_ms"] = cuda_ms(plain, dev, 1)
    res["library_ms"] = cuda_ms(library, dev) if library is not None else None
    lib = "null" if library is None else f"{res['library_ms']:.4f}"
    return (f"kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
            f"library_ms={lib} bound_ms={res['bound_ms']:.4f} ({res['bound_by']})")


def set_bound(res: dict, n_bytes: float, int_ops: float, clock_mhz: float) -> None:
    from reverie_tpu_torch.roofline import bound_ms

    res["bound_ms"], res["bound_by"] = bound_ms(n_bytes, int_ops, clock_mhz)


def check(name: str, res: dict, got: torch.Tensor, ref: torch.Tensor, line: str) -> None:
    err = max_abs_err(got, ref)
    res["max_abs_err"] = max(res.get("max_abs_err", 0), err)
    log("kernel", f"{name} {line} max_abs_err={err}")
    if err:
        raise AssertionError(f"{name} disagrees with its plain version ({line})")


def check_tape(dev, rng, name: str, m: int, clock: float) -> dict:
    """The GF(2) tape (name aes_tape_gf2, m = m2) or the z64 tape
    (aes_tape_z64, m = mz) at each leg's R: byte-equal to its plain version,
    its launch plan, and timed with its bound.  The kernels line takes the
    prove's R = 256."""
    from reverie_tpu_torch.crypto.kernels import aes_tape, aes_tape_z64
    from reverie_tpu_torch.roofline import AES_BLOCK_INT_OPS

    gf2 = name == "aes_tape_gf2"
    mod = aes_tape if gf2 else aes_tape_z64
    kernel = aes_tape.aes_ctr_tape_gf2 if gf2 else aes_tape_z64.aes_ctr_tape_z64
    plain = aes_tape.aes_ctr_tape_gf2_ref if gf2 else aes_tape_z64.aes_ctr_tape_z64_ref
    res = {}
    for R in REPS:
        keys = rng.randint(0, 256, (R, 8, 16), dtype=np.uint8)
        rk = aes_tape.round_keys(keys, dev)
        omit = None
        if R == 40:  # the online verifier's shape: one omitted player per rep
            om = rng.randint(0, 8 if gf2 else 9, R).astype(np.uint8)
            om[0] = 8  # and one rep omitting none
            omit = torch.from_numpy(om).to(dev)
        line = f"{'m2' if gf2 else 'mz'}={m} R={R} omit={'random' if omit is not None else 'none'}"
        check(name, res, kernel(rk, m, omit), plain(rk, m, omit), line)
        log("kernel", f"{name} {line} plan {json.dumps(mod.plan(m, R))}")
        # the function needs no keystream for an omitted player (its tape bit
        # or word is 0), so the operations count only the other keys
        live_keys = 8 * R - (0 if omit is None else int((omit < 8).sum()))
        case = {}
        if gf2:
            set_bound(case, m * R + R * 8 * KEY_BYTES + R,
                      -(-m // 128) * live_keys * AES_BLOCK_INT_OPS, clock)
        else:
            set_bound(case, m * 8 * R * 8 + R * 8 * KEY_BYTES + R,
                      -(-m // 2) * live_keys * AES_BLOCK_INT_OPS, clock)
        log("kernel", f"{name} {line} " + timed(
            case, lambda: kernel(rk, m, omit), lambda: plain(rk, m, omit)))
        if R == REPS[0]:
            res.update(case)
    return res


#: K3 (csrc/blake3_chunks.cu) on each of its routes, held to the plain
#: version: (R, chunks, chunk base, the buffer's bytes past a 16-byte
#: boundary): the legs' widths 40 and 216 (span40, span216), a batch's 2,048
#: and the SHA-256 chunk of 64 proofs (16,384 at 21 and 22 chunks) on rows;
#: the mesh's shard widths on span; a ragged rows tile (272); rows_shifted
#: (300, and 272 on a buffer 3 bytes past a 16-byte boundary); buffers 1, 5
#: and 8 bytes past a boundary (span, span40, span216); one chunk; chunk
#: bases whose chunks cross 2^32
K3_CASES = ((40, 976, 0, 0), (216, 976, 0, 0), (2048, 64, 0, 0), (16_384, 21, 0, 0),
            (16_384, 22, 0, 0), (3, 976, 0, 0), (4, 976, 0, 0), (18, 976, 0, 0),
            (21, 976, 0, 0), (22, 976, 0, 0), (272, 40, 0, 0), (272, 40, 0, 3),
            (300, 40, 0, 5), (256, 976, 0, 1), (40, 976, 0, 5), (216, 976, 0, 8),
            (256, 1, 0, 0), (40, 1, 0, 0), (216, 1, 0, 0), (256, 64, 2**32 - 8, 0),
            (40, 64, 2**32 - 8, 3))
#: K3 timed with its bound beside the prove's R = 256: (R, chunks)
K3_TIMED = ((40, 976), (216, 976), (2048, 976), (16_384, 22))


def check_blake3(dev, rng, T: int, clock: float) -> dict:
    """K3 at the GF(2) 1M prove's shape (R = 256, the kernels line) against
    its plain version and timed with its bound, then on each route
    (K3_CASES) and timed at K3_TIMED's widths, each with its launch plan;
    then the per-column hash against the host C blake3 at each leg's R."""
    from reverie_tpu_torch.crypto import blake3_many
    from reverie_tpu_torch.crypto.kernels import blake3 as b3
    from reverie_tpu_torch.tools._timing import cuda_ms
    from reverie_tpu_torch.tools.k3_times import case_bound, case_buffer

    R = REPS[0]
    n = T // 1024
    buf = torch.from_numpy(rng.randint(0, 256, (T, R), dtype=np.uint8)).to(dev)
    res = {}
    line = f"T={T} R={R} n={n}"
    check("blake3_chunk_cvs", res, b3.chunk_cvs(buf, n, 0), b3.chunk_cvs_ref(buf, n, 0), line)
    res["bound_ms"], res["bound_by"] = case_bound(R, n, clock)
    log("kernel", f"blake3_chunk_cvs {line} plan {b3.launch_plan(buf, n).line()} " + timed(
        res, lambda: b3.chunk_cvs(buf, n, 0), lambda: b3.chunk_cvs_ref(buf, n, 0)))
    for i, (R, n, base, offset) in enumerate(K3_CASES):
        buf = case_buffer(dev, R, n, offset, seed=200 + i)
        check("blake3_chunk_cvs", res, b3.chunk_cvs(buf, n, base), b3.chunk_cvs_ref(buf, n, base),
              f"R={R} n={n} chunk_base={base} offset={offset} "
              f"plan {b3.launch_plan(buf, n).line()}")
    for R, n in K3_TIMED:
        buf = case_buffer(dev, R, n, 0, seed=R)
        ms = cuda_ms(lambda: b3.chunk_cvs(buf, n, 0), dev)
        bound, by = case_bound(R, n, clock)
        log("kernel", f"blake3_chunk_cvs R={R} n={n} plan {b3.launch_plan(buf, n).line()} "
            f"kernel_ms={ms:.4f} bound_ms={bound:.4f} ({by}) bound_share={bound / ms:.3f}")
    del buf
    torch.cuda.empty_cache()
    for R in REPS:
        cols = rng.randint(0, 256, (R, T), dtype=np.uint8)
        dbuf = torch.from_numpy(np.ascontiguousarray(cols.T)).to(dev)
        t0 = time.perf_counter()
        h = b3.hash_columns(dbuf, T).cpu().numpy()
        dt = (time.perf_counter() - t0) * 1e3
        ok = np.array_equal(h, blake3_many(cols))
        log("kernel", f"hash_columns T={T} R={R} equal_to_host_blake3={ok} "
            f"wall_ms={dt:.3f}")
        if not ok:
            raise AssertionError(f"hash_columns disagrees with blake3_many at R={R}")
    return res


#: the shard widths of the mesh phase's 12 shards (of 256, 40 and 216 lanes)
TAIL_SHARD_WIDTHS = (3, 4, 18, 21, 22)


def check_blake3_tail(dev, rng, clock: float, ccs: dict) -> dict:
    """The tail kernel (csrc/blake3_tail.cu) against the torch tail on the
    card, byte for byte, on the chunk CVs K3 makes of random streams: a
    hash leg (hash_leg: the four streams' tails and the pair hashes in one
    launch) on each cell's four stream lengths (ccs: cell -> compiled
    circuit) at the prover's R = 256, the online verifier's 40 and the
    preprocessing verifier's 216, with and without the committed online
    hashes; a batch of 8 1M-AND proofs (R = 2,048), a chunk of 64 SHA-256
    proofs (R = 16,384), the mesh's shard widths and R = 0; each with its
    launch plan.  One stream's hash (finalize_columns) at each of those
    lengths and widths, an empty stream, a partial and a whole chunk; the
    CV stack of a streamed hasher (pair_levels) against
    _tree_reduce(root=False) and the tree on it; four ColumnHashers'
    leg; the pair hashes at each R.  The kernels line takes the leg at the
    GF(2) 1M prove (R = 256): its ms, the torch tail's and its bound
    (roofline.blake3_tail_work over the four streams plus
    blake3_pairs_work); one stream's hash (the 1M-AND onl2 stream) and the
    pair hashes are logged beside it."""
    from reverie_tpu_torch.crypto.kernels import blake3 as b3, blake3_tail
    from reverie_tpu_torch.roofline import blake3_pairs_work, blake3_tail_work
    from reverie_tpu_torch.tools.tail_times import queued_ms

    gen = torch.Generator(device=dev).manual_seed(int(rng.randint(2**31)))
    res = {}

    def stream(T: int, R: int):
        buf = torch.randint(0, 256, (max(T, 1), R), dtype=torch.uint8, device=dev, generator=gen)
        return b3.stream_tail(buf, T)

    def case(T: int, R: int, what: str) -> None:
        levels, rem, _ = stream(T, R)
        n = b3._last_chunk(T)[0]
        check("blake3_tail", res, b3.finalize_columns(levels, rem, T),
              b3.finalize_columns_ref(levels, rem, T), f"finalize {what} T={T} R={R} n={n}")

    def leg_inputs(cc, R: int, comm: bool):
        legs = [stream(getattr(cc, name), R) for name in ("pre2", "onl2", "prez", "onlz")]
        if comm:
            legs[1], legs[3] = [torch.randint(0, 256, (R, 32), dtype=torch.uint8, device=dev,
                                              generator=gen) for _ in range(2)]
        return legs

    def leg_plan(legs) -> str:
        return blake3_tail.launch_plan([x if isinstance(x, torch.Tensor) else
                                        (x[0], x[1], b3._last_chunk(x[2])[1])
                                        for x in legs]).line()

    def leg_case(cc, R: int, comm: bool, what: str) -> None:
        legs = leg_inputs(cc, R, comm)
        n0 = blake3_tail.LAUNCHES
        got = b3.hash_leg(*legs)
        if blake3_tail.LAUNCHES - n0 != int(R > 0):
            raise AssertionError(f"blake3_tail: the leg {what} R={R} took "
                                 f"{blake3_tail.LAUNCHES - n0} launches")
        want = b3.hash_leg_ref(*legs)
        check("blake3_tail", res, torch.cat(got, dim=1), torch.cat(want, dim=1),
              f"leg {what} R={R} committed={comm} plan {leg_plan(legs)}")

    lengths = {}
    for cell, cc in ccs.items():
        for name in ("onl2", "pre2", "onlz", "prez"):
            T = getattr(cc, name)
            lengths[T] = lengths.get(T, []) + [f"{cell}.{name}"]
            for R in (256, 40) + ((216,) if name.startswith("pre") else ()):
                case(T, R, f"{cell}.{name}")
        for R in (256, 40, 216) + TAIL_SHARD_WIDTHS + (0,):
            for comm in (False, True):
                leg_case(cc, R, comm, cell)
    for T in (0, 700, 1024):
        for R in (256, 40, 216):
            case(T, R, "short")
    gf2, sha = ccs["gf2_1M"], ccs["sha256"]
    case(gf2.onl2, 2048, "batch of 8")
    case(max(sha.onl2, sha.pre2), 16_384, "chunk of 64 SHA-256")
    for comm in (False, True):
        leg_case(gf2, 2048, comm, "gf2_1M batch of 8")
        leg_case(sha, 16_384, comm, "sha256 chunk of 64")
    for R in TAIL_SHARD_WIDTHS:
        case(gf2.onl2, R, "shard")
        case(0, R, "shard")

    # a streamed hasher's CV stack: the first k chunk CVs paired
    T, R = gf2.onl2, 256
    levels, rem, _ = stream(T, R)
    n = b3._last_chunk(T)[0]
    k = (n - 1) // 2 + 3
    plain, stack = [levels[0][:, :k]], [levels[0][:, :k].clone()]
    b3._tree_reduce(plain, root=False)
    b3.pair_levels(stack)
    heights = {j for j, x in enumerate(plain) if x.shape[1]}
    if heights != {j for j, x in enumerate(stack) if x.shape[1]}:
        raise AssertionError("blake3_tail: the CV stack's heights differ from _tree_reduce's")
    check("blake3_tail", res, torch.cat([stack[j] for j in sorted(heights)], dim=1),
          torch.cat([plain[j] for j in sorted(heights)], dim=1), f"CV stack of k={k} chunks R={R}")
    stack[0] = torch.cat([stack[0], levels[0][:, k:]], dim=1)
    check("blake3_tail", res, b3.finalize_columns(stack, rem, T),
          b3.finalize_columns_ref(levels, rem, T), f"finalize on the CV stack k={k} T={T} R={R}")

    # four streamed hashers (each held to a few segments' CVs, its CV stack
    # past them) and their leg, as StreamingKKW's hash_final runs it
    T2 = (gf2.pre2, gf2.onl2, 5 * 1024 + 300, 3 * 1024)
    for R in (256, 40):
        bufs = [torch.randint(0, 256, (max(T, 1), R), dtype=torch.uint8, device=dev,
                              generator=gen) for T in T2]
        hashers = []
        for T, buf in zip(T2, bufs):
            h = b3.ColumnHasher(T, R, dev, 96 * b3.CV_BYTES * R, 1 << 30)
            for lo in range(0, T, 150_000):
                h.absorb(buf[lo : min(T, lo + 150_000)])
            hashers.append(h)
        n0 = blake3_tail.LAUNCHES
        got = b3.hash_leg(*(h.tail() for h in hashers))
        if blake3_tail.LAUNCHES - n0 != 1:
            raise AssertionError("blake3_tail: the hashers' leg took more than one launch")
        want = b3.hash_leg_ref(*(b3.stream_tail(buf, T) for T, buf in zip(T2, bufs)))
        check("blake3_tail", res, torch.cat(got, dim=1), torch.cat(want, dim=1),
              f"leg of four ColumnHashers R={R} "
              f"p0={[blake3_tail.stack_items(h.levels)[1] for h in hashers]}")

    for R in (256, 40, 216, 2048, 16_384) + TAIL_SHARD_WIDTHS:
        ins = [torch.randint(0, 256, (R, 32), dtype=torch.uint8, device=dev, generator=gen)
               for _ in range(4)]
        check("blake3_tail", res, b3.hash_rep_columns(*ins), b3.hash_rep_columns_ref(*ins),
              f"pairs H(H(a||b)||H(c||d)) R={R}")
        check("blake3_tail", res, b3.hash_pair_columns(ins[0], ins[1]),
              b3.hash_pair_columns_ref(ins[0], ins[1]), f"pair H(a||b) R={R}")
        if R == 256:
            pairs = {}
            set_bound(pairs, *blake3_pairs_work(R), clock)
            log("kernel", f"blake3_tail pairs R={R} " + timed(
                pairs, lambda: b3.hash_rep_columns(*ins), lambda: b3.hash_rep_columns_ref(*ins)))

    T, R = gf2.onl2, 256
    levels, rem, _ = stream(T, R)
    n = b3._last_chunk(T)[0]
    one = {}
    set_bound(one, *blake3_tail_work(n, T - (n - 1) * b3.CHUNK_LEN, R), clock)
    log("kernel", f"blake3_tail finalize T={T} R={R} n={n} queued_ms="
        f"{queued_ms(lambda: b3.finalize_columns(levels, rem, T), dev):.4f} " + timed(
            one, lambda: b3.finalize_columns(levels, rem, T),
            lambda: b3.finalize_columns_ref(levels, rem, T)))

    legs = leg_inputs(gf2, R, False)
    n_bytes = ops = 0
    for name in ("pre2", "onl2", "prez", "onlz"):
        T = getattr(gf2, name)
        n = b3._last_chunk(T)[0]
        b, o = blake3_tail_work(n, T - (n - 1) * b3.CHUNK_LEN, R)
        n_bytes, ops = n_bytes + b, ops + o
    b, o = blake3_pairs_work(R)
    set_bound(res, n_bytes + b, ops + o, clock)
    # the leg is shorter than its host call: its ms queued behind a spin of
    # the card (tail_times.queued_ms), the host's call beside it
    line = timed(res, lambda: b3.hash_leg(*legs), lambda: b3.hash_leg_ref(*legs))
    host_ms, res["ms"] = res["ms"], queued_ms(lambda: b3.hash_leg(*legs), dev)
    log("kernel", f"blake3_tail leg gf2_1M prove R={R} plan {leg_plan(legs)} "
        f"kernel_ms={res['ms']:.4f} (back to back on the host {host_ms:.4f}) "
        + line.split(" ", 1)[1])
    log("kernel", f"blake3_tail stream lengths {json.dumps(lengths)}")
    return res


def check_planes(dev, clock: float) -> dict:
    from reverie_tpu_torch.crypto.kernels import aes_planes
    from reverie_tpu_torch.roofline import AES_BLOCK_INT_OPS
    from reverie_tpu_torch.tools import r2_measure

    rk = r2_measure.round_keys(dev)
    K, B = rk.shape[0], PLANES_BLOCKS
    res = {}
    line = f"B={B} keys={K}"
    check("aes_ctr_planes", res, aes_planes.aes_ctr_planes(rk, B),
          aes_planes.aes_ctr_planes_ref(rk, B), line)
    log("kernel", f"aes_ctr_planes {line} plan {json.dumps(aes_planes.plan(B, K // 32))}")
    set_bound(res, 16 * 8 * B * (K // 32) * 4 + K * KEY_BYTES,
              B * K * AES_BLOCK_INT_OPS, clock)
    log("kernel", f"aes_ctr_planes {line} " + timed(
        res, lambda: aes_planes.aes_ctr_planes(rk, B),
        lambda: aes_planes.aes_ctr_planes_ref(rk, B)))
    return res


def check_copy(dev, clock: float) -> dict:
    """Both of the probe's 512 MB arrays; the kernels line takes the u8
    one's times."""
    from reverie_tpu_torch.tools import r4_bwroof

    res, first = {}, None
    for name, shape, dtype in r4_bwroof.CASES:
        x = r4_bwroof.random_tensor(shape, dtype, dev, 5)
        n_bytes = x.numel() * x.element_size()
        line = f"{name} shape={list(shape)}"
        check("copy", res, r4_bwroof.copy(x), r4_bwroof.copy_ref(x), line)
        case = {}
        set_bound(case, 2 * n_bytes, 0, clock)
        log("kernel", f"copy {line} " + timed(
            case, lambda: r4_bwroof.copy(x), lambda: r4_bwroof.copy_ref(x),
            lambda: torch.empty_like(x).copy_(x)))
        first = first or case
        del x
    return {**first, "max_abs_err": res["max_abs_err"]}


def check_u8emit(dev, clock: float) -> dict:
    """Both orders; the kernels line takes the sigma order's times (its
    library call is a real transposing copy)."""
    from reverie_tpu_torch.tools import r4_bwroof, r5_u8emit

    w = r4_bwroof.random_tensor((EMIT_T, 128), torch.int32, dev, 7)
    res = {}
    for perm in (False, True):
        line = f"T={EMIT_T} order={'sigma' if perm else 'exact'}"
        check("u32_to_u8_rows", res, r5_u8emit.u32_to_u8_rows(w, perm),
              r5_u8emit.u32_to_u8_rows_ref(w, perm), line)
        set_bound(res, 2 * w.numel() * 4, 0, clock)
        log("kernel", f"u32_to_u8_rows {line} " + timed(
            res, lambda: r5_u8emit.u32_to_u8_rows(w, perm),
            lambda: r5_u8emit.u32_to_u8_rows_ref(w, perm),
            lambda: r5_u8emit.u32_to_u8_rows_library(w, perm)))
    return res


def check_pack_shift(dev, clock: float) -> dict:
    from reverie_tpu_torch.tools import r4_bwroof, r4_extract_probe as rx

    n, R = PACK_N, PACK_R
    x = r4_bwroof.random_tensor((n, R), torch.uint8, dev, 11)
    sh = torch.from_numpy(np.random.RandomState(11).randint(0, 8, R).astype(np.uint8)).to(dev)
    res = {}
    line = f"n={n} R={R} shifts=random"
    check("pack_shift", res, rx.pack_shift(x, sh), rx.pack_shift_ref(x, sh), line)
    nc = n // 8 + 1
    set_bound(res, n * R + nc * R + R, nc * (R // 4) * rx.INT_OPS_PER_WORD, clock)
    log("kernel", f"pack_shift {line} " + timed(
        res, lambda: rx.pack_shift(x, sh), lambda: rx.pack_shift_ref(x, sh)))
    return res


def counters() -> dict:
    """The module and attribute that count each kernel's launches."""
    from reverie_tpu_torch.backend import scan
    from reverie_tpu_torch.crypto.kernels import aes_planes, aes_tape, aes_tape_z64, blake3 as b3
    from reverie_tpu_torch.crypto.kernels import blake3_tail
    from reverie_tpu_torch.tools import r4_bwroof, r4_extract_probe, r5_u8emit

    mods = {"aes_tape_gf2": aes_tape, "aes_tape_z64": aes_tape_z64,
            "blake3_chunk_cvs": b3, "blake3_tail": blake3_tail,
            "aes_ctr_planes": aes_planes, "copy": r4_bwroof,
            "u32_to_u8_rows": r5_u8emit, "pack_shift": r4_extract_probe, "scan_gf2": scan}
    return {**{name: (mod, "LAUNCHES") for name, mod in mods.items()},
            "scan_z64": (scan, "LAUNCHES_Z64")}


def reset_launches() -> None:
    for mod, attr in counters().values():
        setattr(mod, attr, 0)


def launch_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in counters().items()}


def main_path(dev, tag: str, make, domain: str, rng, executor_kernel: str = "") -> dict:
    """Prove and verify one circuit, cold then warm, through TorchKKW; a
    proof with one flipped recon byte in a `domain` online opening must
    not verify; with `executor_kernel`, each leg's executor phase must have
    launched it.  Returns the kernels' launch counts of the run
    ('launches'), the program, witnesses and compiled circuit ('prog',
    'w2', 'wz', 'cc'), the seeds and the proof."""
    from reverie_tpu_torch import TorchKKW

    t0 = time.perf_counter()
    prog, w2, wz = make()
    kkw = TorchKKW(prog, device=dev)
    cc = kkw.cc
    log(tag, f"compile host_s={time.perf_counter() - t0:.3f} m2={cc.m2} mz={cc.mz} "
        f"onl2={cc.onl2} pre2={cc.pre2} onlz={cc.onlz} prez={cc.prez} depth={cc.depth}")
    seeds = rng.randint(0, 256, (256, 16), dtype=np.uint8)

    reset_launches()
    for run in ("cold", "warm"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        proof = kkw.prove(w2, wz, seeds=seeds)
        torch.cuda.synchronize()
        prove_s = time.perf_counter() - t
        prove_t = kkw.last_timings
        t = time.perf_counter()
        ok = kkw.verify(proof)
        torch.cuda.synchronize()
        verify_s = time.perf_counter() - t
        verify_t = kkw.last_timings
        for name, tm, wall in (("prove", prove_t, prove_s), ("verify", verify_t, verify_s)):
            dev_ms = sum(v["device_ms"] for v in tm.values())
            log(tag, f"{run} {name} wall_s={wall:.4f} sum_phase_device_ms={dev_ms:.3f}")
            log(tag, f"{run} {name} phases " + json.dumps(
                {k: {"host_ms": round(v["host_ms"], 3),
                     "device_ms": round(v["device_ms"], 3),
                     "launches": {n: c for n, c in v["launches"].items() if c}}
                 for k, v in tm.items()}))
        if ok is not True:
            raise AssertionError(f"{tag}: the proof did not verify")
    launches = launch_counts()
    log(tag, f"verify=True launches={json.dumps(launches)}")

    tape = "aes_tape_gf2" if domain == "gf2" else "aes_tape_z64"
    per_leg = {
        "prove": (prove_t["tape_" + domain], prove_t["execute"], prove_t["hash"]),
        "verify_online": (verify_t["onl_tape"], verify_t["onl_exec"], verify_t["onl_hash"]),
        "verify_preprocessing": (verify_t["pre_tape"], verify_t["pre_exec"],
                                 verify_t["pre_hash"]),
    }
    for leg, (tp, ex, hsh) in per_leg.items():
        a, b = tp["launches"][tape], hsh["launches"]["blake3_chunk_cvs"]
        d = hsh["launches"]["blake3_tail"]
        c = ex["launches"][executor_kernel] if executor_kernel else 1
        log(tag, f"{leg} {tape}_launches={a} blake3_chunk_cvs_launches={b} "
            f"blake3_tail_launches={d}"
            + (f" {executor_kernel}_launches={c}" if executor_kernel else ""))
        if a < 1 or b < 1 or c < 1 or d < 1:
            raise AssertionError(f"{tag} {leg} did not launch every kernel of its path")
        if d != 1:
            raise AssertionError(f"{tag} {leg}: the tail launched {d} times, not once a leg")
    tail_routes(tag, kkw, w2, wz, seeds, proof)

    tampered = kkw.verify(flipped(proof, domain))
    log(tag, f"tampered {domain} online opening verify={tampered}")
    if tampered is not False:
        raise AssertionError(f"{tag}: a tampered proof verified")
    return dict(launches=launches, prog=prog, w2=w2, wz=wz, cc=cc, seeds=seeds, proof=proof)


@contextlib.contextmanager
def torch_tail():
    """The torch tail on the card, as the port ran it before the tail
    kernel, for its time beside the kernel's: while the block runs,
    blake3's entry points on CUDA tensors take their plain versions
    (finalize_columns_ref, _tree_reduce, hash_pair_columns_ref,
    hash_leg_ref) instead of csrc/blake3_tail.cu.
    Only for that measurement: the port itself never routes a CUDA tensor
    to a plain version."""
    from reverie_tpu_torch.crypto.kernels import blake3 as b3

    names = ("finalize_columns", "pair_levels", "hash_pair_columns", "hash_rep_columns", "hash_leg")
    saved = {k: getattr(b3, k) for k in names}
    b3.finalize_columns = b3.finalize_columns_ref
    b3.pair_levels = functools.partial(b3._tree_reduce, root=False)
    b3.hash_pair_columns = b3.hash_pair_columns_ref
    b3.hash_rep_columns = b3.hash_rep_columns_ref
    b3.hash_leg = b3.hash_leg_ref
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(b3, k, v)


def tail_routes(tag: str, kkw, w2, wz, seeds, proof) -> None:
    """The hash phases of a warm prove and verify with the tail kernel and
    with the torch tail (torch_tail), in turns (kernel, torch, torch,
    kernel), each proof equal to `proof` and verified: host and device ms
    of hash, onl_hash and pre_hash, the walls and the tail's launches."""
    from reverie_tpu_torch.crypto.kernels import blake3_tail

    for route in ("kernel", "torch", "torch", "kernel"):
        n0 = blake3_tail.LAUNCHES
        with torch_tail() if route == "torch" else contextlib.nullcontext():
            got, prove_s = wall(lambda: kkw.prove(w2, wz, seeds=seeds))
            pt = kkw.last_timings
            ok, verify_s = wall(lambda: kkw.verify(got))
            vt = kkw.last_timings
        phases = {"hash": pt["hash"], "onl_hash": vt["onl_hash"], "pre_hash": vt["pre_hash"]}
        log(tag, f"tail_route={route} prove_wall_ms={prove_s * 1e3:.3f} "
            f"verify_wall_ms={verify_s * 1e3:.3f} " + " ".join(
                f"{k}_ms(host/device)={v['host_ms']:.3f}/{v['device_ms']:.3f}"
                for k, v in phases.items())
            + f" blake3_tail_launches={blake3_tail.LAUNCHES - n0}")
        if got.to_bytes() != proof.to_bytes() or ok is not True:
            raise AssertionError(f"{tag}: the {route} tail's proof differs or does not verify")


def flipped(proof, domain: str):
    """The proof with one flipped bit in the first recon byte of its first
    `domain` online opening."""
    from reverie_tpu_torch.proof import Proof

    bad = copy.deepcopy(proof)
    o = getattr(bad, domain).online[0]
    o.recons = bytes([o.recons[0] ^ 1]) + o.recons[1:]
    return Proof.from_bytes(bad.to_bytes())


def parity(dev, name: str) -> None:
    """The port's proof of a committed parity case against the NumPy
    golden's length and SHA-256."""
    from reverie_tpu_torch import TorchKKW, parity as golden

    case = golden.CASES[name]
    prog, w2, wz, seeds = golden.inputs(case)
    t = time.perf_counter()
    got = TorchKKW(prog, device=dev).prove(w2, wz, seeds=seeds).to_bytes()
    ok = golden.matches(case, got)
    log("parity", f"{case.builder}{case.args} seeds=RandomState({case.seed}) "
        f"proof_bytes={len(got)} equal_to_numpy_golden_digest={ok} "
        f"port_s={time.perf_counter() - t:.3f}")
    if not ok:
        raise AssertionError(f"{name}: proof bytes differ from the NumPy golden's")


def golden_b2a(dev) -> None:
    """The committed B2A golden blob, byte for byte."""
    from reverie_tpu_torch import TorchKKW
    from reverie_tpu_torch.circuit import load_program
    from reverie_tpu_torch.circuit.builders import mixed_b2a_circuit
    from reverie_tpu_torch.proof import Proof

    prog = load_program((GOLDEN / "b2a_program.bin").read_bytes())
    seeds = np.frombuffer((GOLDEN / "b2a_seeds.bin").read_bytes(), np.uint8).reshape(256, 16)
    blob = (GOLDEN / "b2a_proof.bin").read_bytes()
    _, w2, wz = mixed_b2a_circuit()
    kkw = TorchKKW(prog, device=dev)
    t = time.perf_counter()
    got = kkw.prove(w2, wz, seeds=seeds).to_bytes()
    ok = kkw.verify(Proof.from_bytes(blob))
    log("parity", f"golden b2a_proof.bin depth={kkw.cc.depth} proof_bytes={len(got)} "
        f"equal={got == blob} verify={ok} port_s={time.perf_counter() - t:.3f} executor="
        f"{type(kkw._executor(0, 256)).__name__} onl_exec_launches="
        f"{json.dumps(kkw.last_timings['onl_exec']['launches'])}")
    if got != blob or ok is not True:
        raise AssertionError("the golden B2A proof was not reproduced")


#: the SHA-256 cell (trace.CELLS["sha256_1block"]): prove_batch_chunked of
#: this many chunks of its `most` (64) proofs, bench.py's config-5 shape
SHA256_CHUNKS = 8
#: the roles' names and the wave kernel's widths in each: a prove, the online
#: verify (random omits), the preprocessing verify
ROLES = {0: "prove", 1: "verify_online", 2: "verify_preprocessing"}
WAVE_WIDTHS = ((0, 256), (1, 40), (2, 216))


class OpCount(TorchDispatchMode):
    """Counts the torch ops dispatched inside a `with` block (each one a
    kernel launch or more on the card, views apart)."""

    n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def event_ms(fn):
    """(fn(), its stream ms from CUDA events): one run."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def wave_inputs(dev, rng, cc, mode: int, R: int):
    """Random inputs of the wave kernel in one role at R lanes, made on the
    card: a tape; 0/1 witness bits (prove); or a tape that is 0 at each
    rep's omitted player's bit, as the GF(2) tape kernel makes it with its
    omit, 0/1 input and correction records and the recon bits at that bit
    (online verify)."""
    gen = torch.Generator(device=dev).manual_seed(int(rng.randint(2**31)))

    def rows(n: int, high: int) -> torch.Tensor:
        return torch.randint(0, high, (n, R), dtype=torch.uint8, device=dev, generator=gen)

    tape, xin, co2, re2 = rows(cc.m2, 256), None, None, None
    if mode == 0:
        xin = rows(cc.n_wit2, 2)
    elif mode == 1:
        bit = torch.from_numpy((0x80 >> rng.randint(0, 8, R)).astype(np.uint8)).to(dev)
        tape &= ~bit[None, :]
        xin, co2 = rows(cc.n_inputs2, 2), rows(cc.n_corrs2, 2)
        re2 = rows(cc.n_recons2, 2) * bit[None, :]
    return tape, xin, co2, re2


def wave_plan_line(prog, mode: int, R: int) -> str:
    """The launch of a WaveProgram at R lanes: reps and threads per block,
    shared memory per block, resident blocks per SM and on the card, and
    its slots in shared memory and spilled; for W2 also the z64 half's
    staged chunk (its bytes, words and bits rows a chunk, the lanes a z64
    slot) and the kernel's own count of the block's shared memory, which
    must equal the host's and fit SMEM_PER_BLOCK."""
    from reverie_tpu_torch.backend import scan

    p = prog.plan
    per_sm = scan.resident_blocks(prog, mode, R)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = -(-R // p.reps)
    z = ""
    if prog.has_z64:
        W = prog.table.shape[1]
        staged = (scan.staged_bytes(p.reps, W, p.chunk, p.fields, p.Wz, p.zwords, p.zbits)
                  - scan.staged_bytes(p.reps, W, p.chunk, p.fields))
        kernel = scan.kernel_smem_bytes(prog, mode, R)
        z = (f" shared_slots_z64={prog.n_sharedz} spilled_slots_z64={prog.n_spillz} "
             f"staged_z64_bytes={staged} z64_words_per_chunk={p.zwords} "
             f"z64_bits_rows_per_chunk={p.zbits} z64_lanes={p.zlanes} "
             f"kernel_smem_bytes={kernel}")
        if kernel != prog.smem_bytes or kernel > scan.SMEM_PER_BLOCK:
            raise AssertionError(f"W2's shared memory: the kernel's {kernel} B, the host's "
                                 f"{prog.smem_bytes} B, at most {scan.SMEM_PER_BLOCK} B")
    return (f"reps_per_block={p.reps} threads={p.reps // 4 * p.threads_y} "
            f"slots_per_thread={p.k} chunk_waves={p.chunk} "
            f"chunk_fields={p.fields} smem_bytes_per_block={prog.smem_bytes} "
            f"blocks={blocks} resident_blocks={per_sm * sms} ({per_sm}/SM) "
            f"rounds={-(-blocks // (per_sm * sms))} shared_slots={prog.n_shared} "
            f"spilled_slots={prog.n_spill}" + z)


def check_waves(dev, rng, cc, clock: float, ptxas: list) -> dict:
    """The wave kernel (W1) on the SHA-256 tables, through the programs the
    executors run (scan.circuit_program: slots, launch plan), byte-equal to
    its plain version on the SSA table and the same inputs in each role at
    its width and at one chunk of proofs (R = 64 * 256), each timed (CUDA
    events: the kernel the mean of 5, the plain version one run) with its
    bound and its launch plan; at R = 256 and 16,384 each block width (32,
    16, 8 reps) timed, equal to the plan's; the dependency chain alone
    (chain_ms); a spill case (the two-block SHA-256 statement at 32 reps a
    block, its live set past shared memory); and the levelized Executor,
    built directly, on the same inputs in each role: equal streams and
    fail, its warm ms and the torch ops it dispatches.  The kernels line
    takes the prove's R = 256."""
    from reverie_tpu_torch.tools import wave_times

    from reverie_tpu_torch.backend import scan
    from reverie_tpu_torch.backend.executor import Executor
    from reverie_tpu_torch.roofline import wave_gf2_work
    from reverie_tpu_torch.tools._timing import cuda_ms
    from reverie_tpu_torch.trace import CELLS

    wv = scan.waves(cc)
    n_waves, W = wv.op.shape
    log("sha256", f"waves n_waves={n_waves} W={W} nop_share={float((wv.op == 127).mean()):.4f} "
        f"table_bytes={scan.table_bytes(cc)} live_set={scan.live_set(scan.wave_table(wv, 0))}")
    for row in ptxas:
        if "scan_gf2" in row["kernel"]:
            log("sha256", "ptxas " + json.dumps(row))
    rows = {0: cc.m2 + cc.n_wit2, 1: cc.m2 + cc.n_inputs2 + cc.n_corrs2 + cc.n_recons2,
            2: cc.m2}
    chunk_r = CELLS["sha256_1block"].most * 256
    res = {"max_abs_err": 0}
    for mode, R in (*WAVE_WIDTHS, (0, chunk_r)):
        prog = scan.circuit_program(cc, mode, dev, R)
        inputs = wave_inputs(dev, rng, cc, mode, R)
        args = (prog, mode, *inputs, cc.onl2, cc.pre2)
        got = scan.wave_run(*args)
        ssa = torch.from_numpy(scan.wave_table(wv, mode)).to(dev)
        want, plain_ms = event_ms(lambda: scan.wave_gf2_ref(
            ssa, mode, *inputs, cc.n_vals2, cc.onl2, cc.pre2))
        line = f"{ROLES[mode]} R={R} fail={int(got[2].sum())}/{R}"
        for name, g, w in zip(("onl2", "pre2", "fail"), got, want):
            check("scan_gf2", res, g.to(torch.uint8), w.to(torch.uint8), f"{line} {name}")
        del want, ssa
        case = {"plain_ms": plain_ms, "library_ms": None}
        set_bound(case, *wave_gf2_work(wv.op, mode, R, rows[mode], cc.onl2, cc.pre2), clock)
        case["ms"] = cuda_ms(lambda: scan.wave_run(*args), dev)
        log("sha256", f"scan_gf2 {line} kernel_ms={case['ms']:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms=null bound_ms={case['bound_ms']:.4f} ({case['bound_by']}) "
            f"us_per_wave={case['ms'] * 1e3 / n_waves:.4f} {wave_plan_line(prog, mode, R)}")
        if R == WAVE_WIDTHS[0][1]:
            res.update(case)
        if mode == 0 and R in (256, chunk_r):  # each block width, equal to the plan's
            for reps in scan.REPS_PER_BLOCK:
                other = scan.circuit_program(cc, mode, dev, R, reps=reps)
                oargs = (other, *args[1:])
                same = all(torch.equal(a, b) for a, b in zip(scan.wave_run(*oargs), got))
                ms = cuda_ms(lambda: scan.wave_run(*oargs), dev)
                log("sha256", f"scan_gf2 block width {ROLES[mode]} R={R} equal_to_plan={same} "
                    f"kernel_ms={ms:.4f} us_per_wave={ms * 1e3 / n_waves:.4f} "
                    f"{wave_plan_line(other, mode, R)}")
                if not same:
                    raise AssertionError(f"W1 at {reps} reps a block disagrees (R={R})")
        if R != chunk_r:  # the levelized executor on the same inputs
            inp = dict(zip(("tape", "wit2" if mode == 0 else "in2", "co2", "re2"), inputs))
            ex = Executor(cc, mode, R, dev)
            with OpCount() as ops:
                lev = ex({k: v for k, v in inp.items() if v is not None})
            torch.cuda.synchronize()
            _, lev_s = wall(lambda: ex({k: v for k, v in inp.items() if v is not None}))
            same = all(torch.equal(a, b) for a, b in zip(
                got, (lev["onl2"], lev["pre2"], lev["fail"])))
            log("sha256", f"levelized Executor {ROLES[mode]} R={R} equal_to_kernel={same} "
                f"warm_ms={lev_s * 1e3:.3f} torch_ops={ops.n} against kernel_ms="
                f"{case['ms']:.4f} launches=1")
            if not same:
                raise AssertionError(f"the levelized Executor and the wave kernel disagree "
                                     f"({ROLES[mode]} R={R})")
            del ex, lev
        del prog, inputs, args, got
    ms = wave_times.chain_ms(dev, n_waves, W)
    res["chain_ms"] = ms
    log("sha256", f"scan_gf2 chain n_waves={n_waves} W={W} R=256 one live slot per wave "
        f"kernel_ms={ms:.4f} us_per_wave={ms * 1e3 / n_waves:.4f}")
    spill_case(dev, rng, res)
    return res


def spill_case(dev, rng, res: dict) -> None:
    """The two-block SHA-256 statement (sha256_long_preimage_statement,
    its 4,786 live values past a 32-rep block's shared memory) at R = 256
    and 32 reps a block, so that its longest-lived values spill to the
    kernel's global arena: byte-equal to the plain version, timed."""
    import hashlib

    from reverie_tpu_torch.backend import scan
    from reverie_tpu_torch.circuit.compile import compile_program
    from reverie_tpu_torch.circuit.sha256 import sha256_long_preimage_statement
    from reverie_tpu_torch.tools._timing import cuda_ms

    prog2, _ = sha256_long_preimage_statement(hashlib.sha256(b"two blocks").digest(), 2)
    cc2 = compile_program(prog2)
    wv2 = scan.waves(cc2)
    prog = scan.circuit_program(cc2, 0, dev, 256, reps=32)
    if not prog.n_spill:
        raise AssertionError("the spill case did not spill")
    inputs = wave_inputs(dev, rng, cc2, 0, 256)
    args = (prog, 0, *inputs, cc2.onl2, cc2.pre2)
    got = scan.wave_run(*args)
    ssa = torch.from_numpy(scan.wave_table(wv2, 0)).to(dev)
    want, plain_ms = event_ms(lambda: scan.wave_gf2_ref(
        ssa, 0, *inputs, cc2.n_vals2, cc2.onl2, cc2.pre2))
    line = (f"two-block prove R=256 n_waves={wv2.op.shape[0]} "
            f"live_set={scan.live_set(ssa.cpu().numpy())}")
    for name, g, w in zip(("onl2", "pre2", "fail"), got, want):
        check("scan_gf2", res, g.to(torch.uint8), w.to(torch.uint8), f"{line} {name}")
    ms = cuda_ms(lambda: scan.wave_run(*args), dev)
    log("sha256", f"scan_gf2 spill {line} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"us_per_wave={ms * 1e3 / wv2.op.shape[0]:.4f} {wave_plan_line(prog, 0, 256)}")


def sha256_batch(dev, rng) -> None:
    """prove_batch_chunked of SHA256_CHUNKS chunks of the SHA-256 cell's
    proofs (its one witness, distinct seeds): proofs 0, 63, 64 and 511
    byte-equal to prove() with the same seeds, verify_many of one chunk's
    first 8, proofs/s, host counters (Python's collections and their
    pauses), per-proof hash, and the peak memory at most
    PEAK_OVER_FOOTPRINT x pipeline_footprint of one chunk (its
    device_footprint and the chunk before's streams)."""
    from reverie_tpu_torch import TorchKKW, largest_batch, pipeline_footprint
    from reverie_tpu_torch.trace import CELLS

    cell = CELLS["sha256_1block"]
    chunk = cell.most
    n = SHA256_CHUNKS * chunk
    prog, w2, wz = cell.make()
    kkw = TorchKKW(prog, device=dev)
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    fp = pipeline_footprint(kkw.cc, chunk * 256)
    most = largest_batch(kkw.cc, free, 4096)
    log("sha256", f"largest_batch free_bytes={free} most={most} (of 4096) "
        f"pipeline_footprint R={chunk * 256}: {fp}")
    if most < chunk:
        raise AssertionError(f"sha256: chunks of {chunk} proofs do not fit the card")
    seeds = rng.randint(0, 256, (n, 256, 16), dtype=np.uint8)
    jobs = [(w2, wz)] * n
    kkw.prove_batch(jobs[:chunk], seeds[:chunk])  # cold: the chunk's executor
    proofs, t, host = measured(lambda: peak_within_footprint(
        f"sha256 prove_batch_chunked N={n} chunk={chunk}", fp,
        lambda: kkw.prove_batch_chunked(jobs, seeds, chunk=chunk)))
    tm = kkw.last_timings
    log("sha256", f"prove_batch_chunked N={n} chunk={chunk} R={chunk * 256} wall_s={t:.4f} "
        f"proofs_per_s={n / t:.3f} host={json.dumps(host)} hash_ms_per_proof="
        f"{phase_sum(tm, 'hash', 'device_ms') / n:.4f} (device) "
        f"{phase_sum(tm, 'hash', 'host_ms') / n:.4f} (host) execute_ms_per_chunk="
        f"{phase_sum(tm, 'execute', 'device_ms') / SHA256_CHUNKS:.4f} phases "
        + json.dumps(phase_summary({k: v for k, v in tm.items() if k.endswith("[0]")})))
    picks = [0, chunk - 1, chunk, n - 1]
    same_bytes(f"sha256 prove_batch_chunked proofs {picks}", [proofs[i] for i in picks],
               [kkw.prove(w2, wz, seeds=seeds[i]) for i in picks])
    k = min(8, chunk)
    verdicts, t = wall(lambda: kkw.verify_many(proofs[chunk : chunk + k]))
    log("sha256", f"proofs {picks} equal to prove()'s; verify_many of chunk 1's first {k} "
        f"wall_s={t:.4f} verdicts={verdicts}")
    if verdicts != [True] * k:
        raise AssertionError("sha256: a chunked proof did not verify")


def sha256_phase(dev, rng, clock: float, ptxas: list):
    """The SHA-256 statement (parity.sha256_bench: 5,198 levels, pure GF(2),
    on the wave executor): the wave kernel against its plain version and
    the levelized Executor (check_waves); then, with the launches counted
    from 0, its main path (TorchKKW prove, verify, a tampered proof, the
    wave kernel in every leg's executor), the golden's digest, and the
    chunked batch.  Returns (W1's check, the launch counts)."""
    from reverie_tpu_torch.circuit.compile import compile_program
    from reverie_tpu_torch.parity import sha256_bench

    prog, _, _ = sha256_bench()
    res = check_waves(dev, rng, compile_program(prog), clock, ptxas)
    reset_launches()
    main_path(dev, "sha256", sha256_bench, "gf2", rng, executor_kernel="scan_gf2")
    parity(dev, "sha256_1block")
    sha256_batch(dev, rng)
    launches = launch_counts()
    log("sha256", f"launches={json.dumps(launches)}")
    return res, launches


#: the most proofs of the deep z64 chain in one prove_batch (R = N x 256),
#: and the width of W2's wide check
Z64_BATCH_MOST = 64
#: ops a segment of the chain in the segmented run (three segments)
Z64_SEG_OPS = 1_700
#: W2's one-lane width (past 8 x 132 reps, one thread a (rep, z64 slot)),
#: in each role
Z64_ONE_LANE = ((0, 2560), (1, 2560), (2, 2560))


WAVE_OUTS = ("onl2", "pre2", "fail", "onlz", "prez")


def z64_work(cc, mode: int, R: int):
    """(bytes, integer instructions) of one W2 call on cc's waves at R lanes:
    the GF(2) half's (wave_gf2_work) and the z64 half's (wave_z64_work)."""
    from reverie_tpu_torch.backend import scan
    from reverie_tpu_torch.roofline import wave_gf2_work, wave_z64_work

    wv = scan.waves(cc)
    rows2 = {0: cc.m2 + cc.n_wit2, 1: cc.m2 + cc.n_inputs2 + cc.n_corrs2 + cc.n_recons2,
             2: cc.m2}[mode]
    bytesz = {0: 64 * cc.mz + 8 * cc.n_witz,
              1: 64 * cc.mz + 8 * (cc.n_inputsz + cc.n_corrsz) + 64 * cc.n_reconsz,
              2: 64 * cc.mz}[mode]
    n_b2a = int(np.isin(wv.zop, (10, 11)).sum())
    g = wave_gf2_work(wv.op, mode, R, rows2, cc.onl2, cc.pre2)
    z = wave_z64_work(wv.zop, n_b2a, mode, R, bytesz, cc.onlz, cc.prez)
    return g[0] + z[0], g[1] + z[1]


def check_z64_waves(dev, rng, name: str, cc, clock: float, res: dict) -> None:
    """W2 on one statement's tables, through the programs the executors run
    (scan.circuit_program), byte-equal to the plain version on the SSA
    tables and the same inputs in each role at its width, at a ragged R
    (37) and at Z64_ONE_LANE: every stream and fail; each timed (CUDA
    events: the kernel the mean of 5, the plain version one run) with its
    bound and launch plan;
    the levelized Executor on the same inputs (equal outputs, its warm ms
    and torch ops); and a spill case (every z64 value but the zero and most
    GF(2) values in the global arenas).  The kernels line takes the chain's
    prove at R = 256."""
    from reverie_tpu_torch.tools import wave_times

    from reverie_tpu_torch.backend import scan
    from reverie_tpu_torch.backend.executor import Executor
    from reverie_tpu_torch.tools._timing import cuda_ms

    wv = scan.waves(cc)
    t2 = scan.wave_table(wv, 0)
    ztab, bits = scan.zwave_table(wv, 0)
    log("z64waves", f"{name} depth={cc.depth} n_waves={wv.op.shape[0]} W={wv.op.shape[1]} "
        f"Wz={wv.zop.shape[1]} mz={cc.mz} m2={cc.m2} onlz={cc.onlz} onl2={cc.onl2} "
        f"live_sets={list(scan.live_sets(t2, ztab, bits))} table_bytes={scan.table_bytes(cc)}")
    for mode, R in (*WAVE_WIDTHS, (0, 37), *Z64_ONE_LANE, (0, -256)):
        spill = R < 0
        R = abs(R)
        prog = (scan.circuit_program(cc, mode, dev, R, capacity=3, capacityz=1) if spill
                else scan.circuit_program(cc, mode, dev, R))
        if spill and not prog.n_spillz:
            raise AssertionError(f"{name}: the spill case did not spill")
        inp = wave_times.z64_wave_inputs(dev, rng, cc, mode, R)
        args = wave_times.z64_wave_args(prog, mode, cc, inp)
        got = scan.wave_run(*args)
        ssa = torch.from_numpy(scan.wave_table(wv, mode)).to(dev)
        zt, bt = (torch.from_numpy(a).to(dev) for a in scan.zwave_table(wv, mode))
        want, plain_ms = event_ms(lambda: scan.wave_ref(
            ssa, mode, *args[2:6], cc.n_vals2, cc.onl2, cc.pre2, zt, bt, cc.n_valsz, *args[8:]))
        line = (f"{name} {ROLES[mode]} R={R}{' spill' if spill else ''} "
                f"fail={int(got.fail.sum())}/{R}")
        for key in WAVE_OUTS:
            check("scan_z64", res, getattr(got, key).to(torch.uint8),
                  getattr(want, key).to(torch.uint8), f"{line} {key}")
        del want, ssa, zt, bt
        case = {"plain_ms": plain_ms, "library_ms": None}
        set_bound(case, *z64_work(cc, mode, R), clock)
        case["ms"] = cuda_ms(lambda: scan.wave_run(*args), dev)
        lev = ""
        if R in (256, 40, 216) and not spill:  # the levelized executor on the same inputs
            ex = Executor(cc, mode, R, dev)
            with OpCount() as ops:
                out = ex(inp)
            _, lev_s = wall(lambda: ex(inp))
            same = all(torch.equal(getattr(got, k), out[k]) for k in WAVE_OUTS)
            case["levelized_ms"] = lev_s * 1e3
            lev = (f" levelized_Executor_warm_ms={lev_s * 1e3:.3f} torch_ops={ops.n} "
                   f"levelized_equal={same}")
            if not same:
                raise AssertionError(f"{line}: the levelized Executor and W2 disagree")
            del ex, out
        log("z64waves", f"scan_z64 {line} kernel_ms={case['ms']:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms=null bound_ms={case['bound_ms']:.4f} ({case['bound_by']}) "
            f"us_per_wave={case['ms'] * 1e3 / wv.op.shape[0]:.4f}{lev} "
            f"{wave_plan_line(prog, mode, R)}")
        if name == "chain" and (mode, R) == (0, 256) and not spill:
            res.update(case)
        del prog, inp, args, got


def z64_chain_wide(dev, rng, cc, clock: float, res: dict) -> None:
    """W2 on the chain at R = Z64_BATCH_MOST x 256 (a batch's width: a 10.5
    GB tape), prove, against the plain version on the program's slot tables
    and the same inputs on the card, compared 256 columns at a time; timed
    with its bound and launch plan."""
    from reverie_tpu_torch.tools import wave_times

    from reverie_tpu_torch.backend import scan
    from reverie_tpu_torch.tools._timing import cuda_ms

    R = Z64_BATCH_MOST * 256
    prog = scan.circuit_program(cc, 0, dev, R)
    inp = wave_times.z64_wave_inputs(dev, rng, cc, 0, R)
    args = wave_times.z64_wave_args(prog, 0, cc, inp)
    got = scan.wave_run(*args)
    want, plain_ms = event_ms(lambda: scan.wave_plain(*args))
    err = 0
    for key in WAVE_OUTS:
        g, w = getattr(got, key), getattr(want, key)
        for p in range(Z64_BATCH_MOST):
            err = max(err, max_abs_err(g[..., p * 256 : (p + 1) * 256].to(torch.uint8),
                                       w[..., p * 256 : (p + 1) * 256].to(torch.uint8)))
    res["max_abs_err"] = max(res["max_abs_err"], err)
    del want
    case = {}
    set_bound(case, *z64_work(cc, 0, R), clock)
    ms = cuda_ms(lambda: scan.wave_run(*args), dev)
    log("z64waves", f"scan_z64 chain prove R={R} tapez_bytes={inp['tapez'].numel() * 8} "
        f"max_abs_err_per_256_columns={err} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={case['bound_ms']:.4f} ({case['bound_by']}) {wave_plan_line(prog, 0, R)}")
    if err:
        raise AssertionError(f"W2 at R={R} disagrees with its plain version")


def z64_segments(dev, rng, res: dict, R: int) -> None:
    """compile_segments of the chain into segments of Z64_SEG_OPS ops, each
    run through W2 (ScanExecutor on the card, prove, R lanes) with its
    carries chained from the segments before, against the plain version of
    each segment's program on the card (the same inputs and carried rows):
    streams, fail and carry outputs byte-equal."""
    from reverie_tpu_torch.tools import wave_times

    from reverie_tpu_torch.backend import scan
    from reverie_tpu_torch.circuit.compile import compile_program, compile_segments

    prog = wave_times.z64_statements()["chain"]()[0]
    segs = compile_segments(prog, Z64_SEG_OPS)
    whole = compile_program(prog)
    inp = wave_times.z64_wave_inputs(dev, rng, whole, 0, R)
    outs, err, n0, lanes = [], 0, scan.LAUNCHES_Z64, set()
    for seg in segs:
        cc = seg.cc
        sub = {"tapez": inp["tapez"][seg.tapez0 : seg.tapez0 + cc.mz],
               "witz": inp["witz"][seg.witz0 : seg.witz0 + cc.n_witz],
               "tape": inp["tape"][:0], "wit2": inp["wit2"][:0]}
        if seg.carry_srcz:
            for k in ("carry_maskz", "carry_corrz"):
                sub[k] = torch.stack([outs[s][k][row] for s, row in seg.carry_srcz])
        ex = scan.ScanExecutor(cc, 0, R, dev, carry_inz=len(seg.carry_inz),
                               carry_outz_vals=seg.carry_outz_vals)
        lanes.add(ex.program.plan.zlanes)
        got = ex(sub)
        want = scan.wave_plain(ex.program, 0, sub["tape"], sub["wit2"], None, None, cc.onl2,
                               cc.pre2, sub["tapez"], sub["witz"], None, None, cc.onlz, cc.prez,
                               None, None, sub.get("carry_maskz"), sub.get("carry_corrz"))
        for key in (*WAVE_OUTS, "carry_maskz", "carry_corrz"):
            if key in got:
                err = max(err, max_abs_err(got[key].to(torch.uint8) if key == "fail" else got[key],
                                           getattr(want, key).to(torch.uint8) if key == "fail"
                                           else getattr(want, key)))
        outs.append(got)
    res["max_abs_err"] = max(res["max_abs_err"], err)
    log("z64waves", f"segments of the chain R={R} z64_lanes={sorted(lanes)} "
        f"ops={Z64_SEG_OPS} n={len(segs)} carried_in="
        f"{[len(s.carry_inz) for s in segs]} carried_out={[len(s.carry_outz) for s in segs]} "
        f"launches={scan.LAUNCHES_Z64 - n0} max_abs_err_vs_plain={err}")
    if len(segs) < 3 or err or scan.LAUNCHES_Z64 - n0 != len(segs):
        raise AssertionError("the chain's segments on W2 disagree with the plain version")


def z64_routes(dev, rng) -> None:
    """The chain's proof on the wave route (W2) and on the levelized route
    (the threshold raised past its depth), the same seeds: equal bytes."""
    from reverie_tpu_torch.tools import wave_times

    from reverie_tpu_torch import TorchKKW
    from reverie_tpu_torch.backend import host

    prog, w2, wz = wave_times.z64_statements()["chain"]()
    seeds = rng.randint(0, 256, (256, 16), dtype=np.uint8)
    kkw = TorchKKW(prog, device=dev)
    kkw.prove(w2, wz, seeds=seeds)
    waves, t = wall(lambda: kkw.prove(w2, wz, seeds=seeds))
    ex_ms = kkw.last_timings["execute"]["device_ms"]
    threshold = host.SCAN_DEPTH_THRESHOLD
    host.SCAN_DEPTH_THRESHOLD = 10**9
    try:
        lev = TorchKKW(prog, device=dev)
        kind = type(lev._executor(0, 256)).__name__
        lev.prove(w2, wz, seeds=seeds)
        levelized, t_lev = wall(lambda: lev.prove(w2, wz, seeds=seeds))
        lev_ms = lev.last_timings["execute"]["device_ms"]
    finally:
        host.SCAN_DEPTH_THRESHOLD = threshold
    same = waves.to_bytes() == levelized.to_bytes()
    log("z64waves", f"chain prove on the waves wall_s={t:.4f} execute_device_ms={ex_ms:.3f}; "
        f"on the levelized route ({kind}) wall_s={t_lev:.4f} execute_device_ms={lev_ms:.3f}; "
        f"equal_proof_bytes={same}")
    if not same or kind != "Executor":
        raise AssertionError("the chain's proofs on the two routes differ")


def z64_batch(dev, rng) -> None:
    """prove_batch of N chain proofs (distinct witnesses and seeds) at R =
    N x 256, N = largest_batch capped at Z64_BATCH_MOST: a first run, then a
    timed one whose peak memory stays within PEAK_OVER_FOOTPRINT x
    device_footprint; proofs 0 and N - 1 equal prove()'s; verify_many of
    two."""
    from reverie_tpu_torch.tools import wave_times

    from reverie_tpu_torch import TorchKKW, device_footprint, largest_batch

    prog, w2, wz = wave_times.z64_statements()["chain"]()
    kkw = TorchKKW(prog, device=dev)
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    n = largest_batch(kkw.cc, free, Z64_BATCH_MOST)
    fp = device_footprint(kkw.cc, n * 256)
    log("z64waves", f"largest_batch free_bytes={free} N={n} (at most {Z64_BATCH_MOST}) "
        f"device_footprint R={n * 256}: {fp}")
    if n < 1:
        raise AssertionError("not one chain proof fits the card")
    wits = distinct_witnesses(rng, w2, wz, n)
    seeds = rng.randint(0, 256, (n, 256, 16), dtype=np.uint8)
    kkw.prove_batch(wits, seeds)  # cold: the R = N x 256 executor
    proofs, t = wall(lambda: peak_within_footprint(
        f"z64waves chain prove_batch N={n} R={n * 256}", fp,
        lambda: kkw.prove_batch(wits, seeds)))
    log("z64waves", f"chain prove_batch N={n} wall_s={t:.4f} proofs_per_s={n / t:.3f} phases "
        + json.dumps(phase_summary(kkw.last_timings)))
    picks = sorted({0, n - 1})
    same_bytes(f"z64waves prove_batch proofs {picks}", [proofs[i] for i in picks],
               [kkw.prove(*wits[i], seeds=seeds[i]) for i in picks])
    verdicts = kkw.verify_many(proofs[:2])
    log("z64waves", f"proofs {picks} equal to prove()'s; verify_many={verdicts}")
    if verdicts != [True] * len(proofs[:2]):
        raise AssertionError("a batched chain proof did not verify")


def z64_wave_phase(dev, rng, clock: float, ptxas: list):
    """Deep z64 and B2A circuits on the wave executor (W2, csrc/scan_z64.cu):
    the kernel against its plain version and the levelized Executor on the
    three statements and 64 chains side by side (check_z64_waves), the
    chain at a batch's width and its segments with their carries chained
    (at R = 256 and on one lane a z64 slot); then, with the launches
    counted from 0, the chain's main path (TorchKKW prove, verify, a
    tampered proof, W2 in every leg's executor), its proof on both routes,
    a prove_batch of chain proofs, and the golden B2A blob (190 levels, now
    on the waves).  Returns (W2's check, the launch counts)."""
    from reverie_tpu_torch.tools import wave_times

    from reverie_tpu_torch.circuit.builders import z64_chains_circuit
    from reverie_tpu_torch.circuit.compile import compile_program

    for row in ptxas:
        if "scan_z64" in row["kernel"]:
            log("z64waves", "ptxas " + json.dumps(row))
    res = {"max_abs_err": 0}
    made = wave_times.z64_statements()
    ccs = {name: compile_program(make()[0]) for name, make in made.items()}
    ccs["chains64"] = compile_program(z64_chains_circuit(64, 150)[0])
    for name, cc in ccs.items():
        check_z64_waves(dev, rng, name, cc, clock, res)
    z64_chain_wide(dev, rng, ccs["chain"], clock, res)
    for R in (256, Z64_ONE_LANE[0][1]):
        z64_segments(dev, rng, res, R)
    del ccs
    reset_launches()
    main_path(dev, "z64waves", made["chain"], "z64", rng, executor_kernel="scan_z64")
    z64_routes(dev, rng)
    z64_batch(dev, rng)
    golden_b2a(dev)
    launches = launch_counts()
    log("z64waves", f"launches={json.dumps(launches)}")
    return res, launches


#: the streaming phase's device budgets for make_system: a quarter of the
#: 1M-AND prove's device_footprint (2.05 GB), a quarter of the 50k-MUL one's
#: (4.40 GB)
STREAM_BUDGETS = {"gf2": 512 << 20, "z64": 1 << 30}
#: ops a segment of the 5,000-MUL z64 chain when streamed
STREAM_CHAIN_OPS = 1_000
#: the kernels a streamed proof must launch in the phase
STREAM_KERNELS = ("aes_tape_gf2", "aes_tape_z64", "blake3_chunk_cvs", "blake3_tail", "scan_gf2",
                  "scan_z64")


def stream_kernels(dev, rng, sk2, skz, checks: dict) -> None:
    """The kernels as a middle segment of each system launches them, each
    byte-equal to its plain version on the same inputs: K1 at the GF(2)
    window's start_block and K3 at the onl2 stream's chunk_base of the
    1M-AND system's middle segment, K4 at the z64 window's start_block of
    the 50k-MUL system's, each at the prover's R = 256, the online
    verifier's 40 (the tapes with random omits) and the preprocessing
    verifier's 216."""
    from reverie_tpu_torch.backend.streaming import Z64_REFILL_BLOCKS, Z64_REFILL_WORDS
    from reverie_tpu_torch.crypto.kernels import aes_tape, aes_tape_z64, blake3 as b3

    seg, segz = sk2.segments[len(sk2.segments) // 2], skz.segments[len(skz.segments) // 2]
    b0, bz = seg.tape0 // aes_tape.BATCH, segz.tapez0 // Z64_REFILL_WORDS
    windows = (("aes_tape_gf2", aes_tape.aes_ctr_tape_gf2, aes_tape.aes_ctr_tape_gf2_ref,
                b0, seg.tape0 - b0 * aes_tape.BATCH + seg.cc.m2),
               ("aes_tape_z64", aes_tape_z64.aes_ctr_tape_z64, aes_tape_z64.aes_ctr_tape_z64_ref,
                bz * Z64_REFILL_BLOCKS, segz.tapez0 - bz * Z64_REFILL_WORDS + segz.cc.mz))
    for name, kernel, plain, start, m in windows:
        if start == 0:
            raise AssertionError(f"{name}: the middle segment's window starts at block 0")
        for R in (256, 40, 216):
            rk = aes_tape.round_keys(rng.randint(0, 256, (R, 8, 16), dtype=np.uint8), dev)
            omit = None if R == 256 else torch.from_numpy(
                rng.randint(0, 8, R).astype(np.uint8)).to(dev)
            check(name, checks[name], kernel(rk, m, omit, start), plain(rk, m, omit, start),
                  f"streaming window start_block={start} m={m} R={R}")
    n, base = seg.cc.onl2 // b3.CHUNK_LEN, seg.onl0 // b3.CHUNK_LEN
    if n < 1 or base < 1:
        raise AssertionError("blake3_chunk_cvs: the middle segment holds no chunk past the first")
    for R in (256, 40, 216):
        buf = torch.from_numpy(rng.randint(0, 256, (seg.cc.onl2, R), dtype=np.uint8)).to(dev)
        check("blake3_chunk_cvs", checks["blake3_chunk_cvs"], b3.chunk_cvs(buf, n, base),
              b3.chunk_cvs_ref(buf, n, base), f"streaming absorb chunk_base={base} n={n} R={R}")


def stream_case(dev, tag: str, sk, w2, wz, seeds, equal, domain: str, acc: dict,
                budget=None) -> None:
    """A StreamingKKW's prove (cold, then warm), verify and a proof with a
    flipped `domain` online byte: walls, phases, segments, launches (added
    into acc) and the peak memory over all of it, which must stay within
    `budget` where one is given; equal(proof bytes) must hold, the proof
    verify and the flipped one not."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launches()
    for run in ("cold", "warm"):
        proof, t = wall(lambda: sk.prove(w2, wz, seeds=seeds))
        log(tag, f"{run} prove wall_s={t:.4f} phases "
            + json.dumps(phase_summary(sk.last_timings)))
    ok, t = wall(lambda: sk.verify(proof))
    log(tag, f"verify={ok} wall_s={t:.4f} phases " + json.dumps(phase_summary(sk.last_timings)))
    rejected = sk.verify(flipped(proof, domain))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v for k, v in launch_counts().items() if v}
    for k, v in launches.items():
        acc[k] = acc.get(k, 0) + v
    same = equal(proof.to_bytes())
    log(tag, f"segments={len(sk.segments)} depths(max)={max(s.cc.depth for s in sk.segments)} "
        f"equal={same} tampered_verify={rejected} peak_bytes={peak} allocated_before={base} "
        f"budget={budget} peak/budget={peak / budget if budget else None} "
        f"launches={json.dumps(launches)}")
    if not same or ok is not True or rejected is not False:
        raise AssertionError(f"{tag}: a streamed proof or verdict is wrong")
    if budget is not None and peak > budget:
        raise AssertionError(f"{tag}: peak {peak} B above the budget {budget} B")


def streaming_phase(dev, rng, checks: dict) -> dict:
    """make_system and StreamingKKW: the 1M-AND and 50k-MUL circuits under
    budgets that force streaming (proofs equal to TorchKKW's, peak memory
    within the budget); SHA-256 in thirds (every segment on W1 with carries;
    the proof equal to the golden's digest) and the 5,000-MUL z64 chain in
    segments of STREAM_CHAIN_OPS (W2 with carries; equal to TorchKKW's);
    make_system with no budget; the kernels at a middle segment's window
    and chunk base against their plain versions.  Returns the launches of
    the streamed runs, which must include every kernel of STREAM_KERNELS."""
    from reverie_tpu_torch import FREE_MARGIN, StreamingKKW, TorchKKW, device_budget, make_system
    from reverie_tpu_torch import parity as golden
    from reverie_tpu_torch.circuit.builders import mul_bench_circuit, z64_mul_bench_circuit
    from reverie_tpu_torch.tools import wave_times

    systems, acc = {}, {}
    for domain, make in (("gf2", lambda: mul_bench_circuit(N_MUL)),
                         ("z64", lambda: z64_mul_bench_circuit(N_MUL_Z64))):
        tag = f"stream_{domain}"
        prog, w2, wz = make()
        seeds = rng.randint(0, 256, (256, 16), dtype=np.uint8)
        t = time.perf_counter()
        if domain == "gf2":
            gc.collect()
            torch.cuda.empty_cache()
            free = device_budget(dev)
            whole = make_system(prog, device=dev)
            log(tag, f"make_system with no budget: {type(whole).__name__} budget={free} "
                f"(free bytes / {FREE_MARGIN}) host_s={time.perf_counter() - t:.3f}")
            if not isinstance(whole, TorchKKW):
                raise AssertionError("make_system with the card's budget did not give TorchKKW")
        else:
            whole = TorchKKW(prog, device=dev)
        want = whole.prove(w2, wz, seeds=seeds).to_bytes()
        del whole
        t = time.perf_counter()
        sk = make_system(prog, device=dev, hbm_budget_bytes=STREAM_BUDGETS[domain])
        log(tag, f"make_system budget={STREAM_BUDGETS[domain]}: {type(sk).__name__} "
            f"host_s={time.perf_counter() - t:.3f}")
        if not isinstance(sk, StreamingKKW) or len(sk.segments) < 2:
            raise AssertionError(f"{tag}: the budget did not force streaming")
        systems[domain] = (sk, w2, wz, seeds, want)
    stream_kernels(dev, rng, systems["gf2"][0], systems["z64"][0], checks)
    for domain, (sk, w2, wz, seeds, want) in systems.items():
        stream_case(dev, f"stream_{domain}", sk, w2, wz, seeds, lambda b, w=want: b == w,
                    domain, acc, STREAM_BUDGETS[domain])
        for route in ("kernel", "torch", "torch", "kernel"):
            with torch_tail() if route == "torch" else contextlib.nullcontext():
                proof, t = wall(lambda: sk.prove(w2, wz, seeds=seeds))
            log(f"stream_{domain}", f"tail_route={route} warm prove wall_s={t:.4f} phases "
                + json.dumps(phase_summary(sk.last_timings)))
            if proof.to_bytes() != want:
                raise AssertionError(f"stream_{domain}: the {route} tail's proof differs")
    del systems

    case = golden.CASES["sha256_1block"]
    prog, w2, wz, seeds = golden.inputs(case)
    sk = StreamingKKW(prog, -(-len(prog) // 3), device=dev)
    if min(s.cc.depth for s in sk.segments) <= 128:
        raise AssertionError("stream_sha256: a segment is not deeper than 128 levels")
    stream_case(dev, "stream_sha256", sk, w2, wz, seeds,
                functools.partial(golden.matches, case), "gf2", acc)
    prog, w2, wz = wave_times.z64_statements()["chain"]()
    seeds = rng.randint(0, 256, (256, 16), dtype=np.uint8)
    want = TorchKKW(prog, device=dev).prove(w2, wz, seeds=seeds).to_bytes()
    sk = StreamingKKW(prog, STREAM_CHAIN_OPS, device=dev)
    stream_case(dev, "stream_chain", sk, w2, wz, seeds, lambda b: b == want, "z64", acc)
    log("stream", f"launches={json.dumps(acc)}")
    missing = [k for k in STREAM_KERNELS if not acc.get(k)]
    if missing:
        raise AssertionError(f"the streamed runs did not launch {missing}")
    return acc


def wall(fn):
    """(fn(), seconds) between two synchronizations of the card."""
    from reverie_tpu_torch.trace import timed as timed_ms

    out, ms = timed_ms(fn)
    return out, ms / 1e3


#: Python's garbage collections (by generation) and their pause, in ms
GC = {"collections": [0, 0, 0], "ms": 0.0, "start": 0.0}


def gc_clock(phase: str, info: dict) -> None:
    """gc.callbacks entry that counts collections and their pauses."""
    if phase == "start":
        GC["start"] = time.perf_counter()
    else:
        GC["collections"][info["generation"]] += 1
        GC["ms"] += (time.perf_counter() - GC["start"]) * 1e3


def host_counters() -> dict:
    """The main thread's CPU seconds (against the wall: time it ran, not
    waited or was descheduled), Python's full collections and all its
    collections' pause ms, and the pinned host allocator's new blocks and
    the microseconds it spent making them."""
    stats = torch.cuda.memory.host_memory_stats()
    return {"thread_cpu_s": time.thread_time(), "gc_full": GC["collections"][2],
            "gc_ms": GC["ms"], "pinned_allocs": stats.get("num_host_alloc", 0),
            "pinned_alloc_us": stats.get("host_alloc_time.total", 0)}


def host_write_ms_per_mib(mib: int = 256) -> dict:
    """Host ms per MiB to write fresh memory (a new mapping, each page
    faulted in) and to write the same pages again."""
    t = time.perf_counter()
    a = np.ones(mib << 20, np.uint8)
    fresh = (time.perf_counter() - t) * 1e3 / mib
    t = time.perf_counter()
    a.fill(2)
    again = (time.perf_counter() - t) * 1e3 / mib
    return {"fresh": fresh, "again": again}


def measured(fn):
    """(fn(), its wall seconds, the change of host_counters over it)."""
    c0 = host_counters()
    out, t = wall(fn)
    c1 = host_counters()
    return out, t, {k: c1[k] - c0[k] for k in c0}


def peak_within_footprint(what: str, footprint: int, fn):
    """fn() with torch.cuda.max_memory_allocated over it, which must stay
    within PEAK_OVER_FOOTPRINT x footprint."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log("batch", f"{what} peak_bytes={peak} allocated_before={base} "
        f"footprint={footprint} peak/footprint={peak / footprint:.4f}")
    if peak > PEAK_OVER_FOOTPRINT * footprint:
        raise AssertionError(f"{what}: peak {peak} B above {PEAK_OVER_FOOTPRINT} x "
                             f"footprint {footprint} B")
    return out


def phase_summary(timings: dict) -> dict:
    """{phase: [host_ms, device_ms]} of a last_timings report."""
    return {k: [round(v["host_ms"], 3), round(v["device_ms"], 3)] for k, v in timings.items()}


def phase_sum(timings: dict, phase: str, key: str) -> float:
    """The sum of `key` over the rows of one phase ("hash", "hash[0]", ...)."""
    return sum(v[key] for k, v in timings.items() if k.split("[")[0] == phase)


def distinct_witnesses(rng, wit2, witz, n: int) -> list:
    """n witnesses of the shapes of (wit2, witz): random bits and words (the
    bench circuits assert nothing, so each is valid)."""
    return [([bool(b) for b in rng.randint(0, 2, len(wit2))],
             [int(v) for v in rng.randint(0, 2**63, len(witz), dtype=np.int64)])
            for _ in range(n)]


def same_bytes(what: str, got: list, want: list) -> None:
    bad = [i for i, (a, b) in enumerate(zip(got, want)) if a.to_bytes() != b.to_bytes()]
    if len(got) != len(want) or bad:
        raise AssertionError(f"{what}: proofs {bad} differ from prove()'s")


def batch_cell(dev, tag: str, cell: str, rng) -> dict:
    """One main-path circuit (trace.CELLS[cell]) through prove() x N,
    prove_batch and prove_many at the N that largest_batch allows: a first
    run of each, then two timed rounds in opposite orders, each run with its
    wall, phases and host counters; every proof equal to prove()'s and
    verified.  Returns the proofs and the system."""
    from reverie_tpu_torch import TorchKKW, device_footprint, largest_batch
    from reverie_tpu_torch.trace import CELLS

    most = CELLS[cell].most
    prog, w2, wz = CELLS[cell].make()
    kkw = TorchKKW(prog, device=dev)
    cc = kkw.cc
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    n = largest_batch(cc, free, most)
    fp = device_footprint(cc, n * 256)
    log("batch", f"{tag} mem_get_info free={free} total={total} N={n} (at most {most}) "
        f"device_footprint R={n * 256}: {fp} R=256: {device_footprint(cc, 256)}")
    if n < 4:
        raise AssertionError(f"{tag}: batches of 4 proofs do not fit the card")
    wits = distinct_witnesses(rng, w2, wz, n)
    seeds = rng.randint(0, 256, (n, 256, 16), dtype=np.uint8)

    kkw.prove(*wits[0], seeds=seeds[0])  # cold: the R = 256 executor
    peak_within_footprint(f"{tag} warm prove() R=256", device_footprint(cc, 256),
                          lambda: kkw.prove(*wits[0], seeds=seeds[0]))
    modes = {"prove_x_N": lambda: [kkw.prove(*wits[i], seeds=seeds[i]) for i in range(n)],
             "prove_batch": lambda: kkw.prove_batch(wits, seeds),
             "prove_many": lambda: kkw.prove_many(wits, seeds)}
    per = {"prove_x_N": 1, "prove_batch": n, "prove_many": n}  # proofs in last_timings
    first = {}
    for mode, fn in modes.items():  # prove_batch's R = N * 256 executor is cold
        first[mode], t, host = measured(fn)
        log("batch", f"{tag} {mode} N={n} first wall_s={t:.4f} host={json.dumps(host)} "
            "phases " + json.dumps(phase_summary(kkw.last_timings)))
    singles = first["prove_x_N"]
    log("batch", f"{tag} proof_bytes={len(singles[0].to_bytes())} host_write_ms_per_mib="
        + json.dumps(host_write_ms_per_mib()))
    same_bytes(f"{tag} prove_batch", first["prove_batch"], singles)
    same_bytes(f"{tag} prove_many", first["prove_many"], singles)
    rows = {mode: [] for mode in modes}
    for rnd, order in enumerate((list(modes), list(modes)[::-1])):
        for mode in order:
            fn = modes[mode]
            if mode == "prove_batch" and rnd == 0:  # and its peak memory
                fn = functools.partial(peak_within_footprint,
                                       f"{tag} warm prove_batch N={n} R={n * 256}", fp, fn)
            got, t, host = measured(fn)
            same_bytes(f"{tag} {mode} round {rnd}", got, singles)
            tm = kkw.last_timings
            rows[mode].append({
                "wall_s": t, "proofs_per_s": n / t, "host": host,
                "hash_ms_per_proof": {k: phase_sum(tm, "hash", k) / per[mode]
                                      for k in ("host_ms", "device_ms")}})
            log("batch", f"{tag} {mode} N={n} round={rnd} wall_s={t:.4f} "
                f"proofs_per_s={n / t:.3f} host={json.dumps(host)} phases "
                + json.dumps(phase_summary(tm)))
    verdicts, t = wall(lambda: kkw.verify_many(first["prove_batch"]))
    log("batch", f"{tag} verify_many of the batch wall_s={t:.4f} verdicts={verdicts}")
    if verdicts != [True] * n:
        raise AssertionError(f"{tag}: a batch proof did not verify")
    log("batch", "summary " + json.dumps({"cell": tag, "N": n, **rows}))
    return {"kkw": kkw, "wits": wits, "seeds": seeds, "proofs": singles}


def batch_parity(dev, name: str, rng) -> None:
    """A parity case's proof as proof 0 of a batch of 3, against the NumPy
    golden's digest."""
    from reverie_tpu_torch import TorchKKW, parity as golden

    case = golden.CASES[name]
    prog, w2, wz, seeds = golden.inputs(case)
    wits = [(w2, wz)] + distinct_witnesses(rng, w2, wz, 2)
    seeds3 = np.concatenate([seeds[None], rng.randint(0, 256, (2, 256, 16), dtype=np.uint8)])
    got = TorchKKW(prog, device=dev).prove_batch(wits, seeds3)[0].to_bytes()
    ok = golden.matches(case, got)
    log("batch", f"{name} as proof 0 of prove_batch N=3 equal_to_numpy_golden_digest={ok}")
    if not ok:
        raise AssertionError(f"{name}: proof 0 of a batch differs from the NumPy golden's")


def batch_widths(dev, rng, n2: int, nz: int, checks: dict) -> None:
    """K1 at (m2, n2 * 256), K4 at (mz, nz * 256) and K3 on the z64 cell's
    onlz rows at nz * 256 columns, each past 2**31 bytes: each block of 256
    columns against the plain version on the same inputs (the kernels
    line's max_abs_err), and against the kernel's own launch at R = 256
    (logged)."""
    from reverie_tpu_torch.crypto.kernels import aes_tape, aes_tape_z64, blake3 as b3

    def blocks(name, got, kernel, plain, inputs, n, nbytes):
        """inputs(p): the arguments of block p; nbytes: the kernel's widest
        tensor (a tape, or K3's stream)."""
        err = own = 0
        for p in range(n):
            block = got[..., p * 256 : (p + 1) * 256]
            err = max(err, max_abs_err(block, plain(*inputs(p))))
            own = max(own, max_abs_err(block, kernel(*inputs(p))))
        log("batch", f"{name} width R={n * 256} bytes={nbytes} over_2^31={nbytes > 2**31} "
            f"max_abs_err_vs_plain_per_block={err} max_abs_err_vs_{n}_launches_at_R=256={own}")
        if err or own:
            raise AssertionError(f"{name} at R={n * 256} differs from its plain version "
                                 "or its per-proof launches")
        if nbytes <= 2**31:
            raise AssertionError(f"{name} at R={n * 256}: {nbytes} B, not past 2**31")
        checks[name]["max_abs_err"] = max(checks[name]["max_abs_err"], err)

    for name, kernel, plain, m, n in (
            ("aes_tape_gf2", aes_tape.aes_ctr_tape_gf2, aes_tape.aes_ctr_tape_gf2_ref, M2, n2),
            ("aes_tape_z64", aes_tape_z64.aes_ctr_tape_z64, aes_tape_z64.aes_ctr_tape_z64_ref,
             MZ, nz)):
        rk = aes_tape.round_keys(rng.randint(0, 256, (n * 256, 8, 16), dtype=np.uint8), dev)
        tape = kernel(rk, m)
        blocks(name, tape, kernel, plain, lambda p: (rk[p * 2048 : (p + 1) * 2048], m), n,
               tape.numel() * tape.element_size())
        del rk, tape
    gen = torch.Generator(device=dev).manual_seed(6)
    buf = torch.randint(0, 256, (ONLZ, nz * 256), dtype=torch.uint8, device=dev, generator=gen)
    k = ONLZ // 1024
    blocks("blake3_chunk_cvs", b3.chunk_cvs(buf, k), b3.chunk_cvs, b3.chunk_cvs_ref,
           lambda p: (buf[:, p * 256 : (p + 1) * 256].contiguous(), k), nz, buf.numel())


def batch_phase(dev, rng, checks: dict) -> dict:
    """The batch and pipeline entry points on both main-path circuits,
    with the kernels' launches counted from 0; then the kernel widths."""
    from reverie_tpu_torch.proof import Proof

    reset_launches()
    gf2 = batch_cell(dev, "gf2", "gf2_mul_1M", rng)
    kkw, wits, seeds, singles = gf2["kkw"], gf2["wits"], gf2["seeds"], gf2["proofs"]
    # six proofs in chunks of 4: the second chunk is ragged
    extra = distinct_witnesses(rng, *wits[0], max(0, 6 - len(wits)))
    wits6 = (wits + extra)[:6]
    seeds6 = np.concatenate([seeds, rng.randint(0, 256, (len(extra), 256, 16), dtype=np.uint8)])[:6]
    want = singles[:6] + [kkw.prove(*wits6[i], seeds=seeds6[i]) for i in range(len(singles), 6)]
    chunked, t = wall(lambda: kkw.prove_batch_chunked(wits6, seeds6, chunk=4))
    same_bytes("gf2 prove_batch_chunked(6, chunk=4)", chunked, want)
    log("batch", f"gf2 prove_batch_chunked N=6 chunk=4 wall_s={t:.4f} phases "
        + json.dumps(phase_summary(kkw.last_timings)))
    # good, a flipped online recon byte, a flipped byte 40 (the first online omit), good
    bad = copy.deepcopy(singles[0])
    o = bad.gf2.online[0]
    o.recons = bytes([o.recons[0] ^ 1]) + o.recons[1:]
    blob = bytearray(singles[1].to_bytes())
    blob[40] ^= 0xFF
    stream = [singles[0], bad, Proof.from_bytes(bytes(blob)), singles[1]]
    got, t = wall(lambda: kkw.verify_many(stream))
    each = [kkw.verify(p) for p in stream]
    log("batch", f"gf2 verify_many(good, tampered, malformed, good) wall_s={t:.4f} "
        f"verdicts={got} verify_each={each}")
    if got != [True, False, False, True] or got != each:
        raise AssertionError("verify_many's verdicts are wrong")
    del gf2, kkw, singles, chunked, stream
    z64 = batch_cell(dev, "z64", "z64_mul_50k", rng)
    n2, nz = len(wits), len(z64["wits"])
    del z64
    batch_parity(dev, "gf2_50k", rng)
    batch_parity(dev, "z64_2k", rng)
    launches = launch_counts()
    log("batch", f"launches={json.dumps(launches)}")
    batch_widths(dev, rng, n2, nz, checks)
    return launches


def probes(dev) -> dict:
    """Run the four probes at the tools' shapes, counting the launches of
    their kernels from 0."""
    from reverie_tpu_torch.tools import r2_measure, r4_bwroof, r4_extract_probe, r5_u8emit

    reset_launches()
    rows = [*r2_measure.run(dev, blocks=(PLANES_BLOCKS,)), *r4_bwroof.run(dev),
            *r5_u8emit.run(dev, t_time=EMIT_T),
            r4_extract_probe.run(dev, n=PACK_N, r=PACK_R)]
    launches = launch_counts()
    for row in rows:
        log("probe", json.dumps(row))
    log("probe", f"launches={json.dumps(launches)}")
    return launches


#: the CLI phase's Bristol circuit: a ripple-carry adder of this many bits
ADDER_BITS = 64
#: the longest one CLI subprocess may take
CLI_TIMEOUT_S = 300
#: a fresh process's start, each stage timed (python -c)
CLI_START = """
import json, time
t0 = time.perf_counter()
import torch
t1 = time.perf_counter()
import reverie_tpu_torch.cli
t2 = time.perf_counter()
from reverie_tpu_torch import _build
_build.kernels()
t3 = time.perf_counter()
torch.empty(1, device="cuda")
torch.cuda.synchronize()
t4 = time.perf_counter()
print(json.dumps({"import_torch_s": t1 - t0, "import_cli_s": t2 - t1,
                  "kernel_library_load_s": t3 - t2, "cuda_init_s": t4 - t3}))
"""


def ripple_adder_bristol(n: int) -> str:
    """A Bristol-fashion n-bit adder, (a + b) mod 2^n: a on wires 0..n-1 and
    b on n..2n-1, least significant bit first; the sum's bits, least
    significant first, copied (EQW) to the last n wires."""
    wire = itertools.count(2 * n)
    gates, sums, carry = [], [], None
    for i in range(n):
        x = next(wire)
        gates.append(f"2 1 {i} {n + i} {x} XOR")
        if carry is None:
            sums.append(x)
        else:
            sums.append(next(wire))
            gates.append(f"2 1 {x} {carry} {sums[-1]} XOR")
        if i < n - 1:
            ab = next(wire)
            gates.append(f"2 1 {i} {n + i} {ab} AND")
            if carry is not None:
                cx, c = next(wire), next(wire)
                gates += [f"2 1 {carry} {x} {cx} AND", f"2 1 {ab} {cx} {c} XOR"]
                ab = c
            carry = ab
    out = next(wire)
    gates += [f"1 1 {w} {out + i} EQW" for i, w in enumerate(sums)]
    return "\n".join([f"{len(gates)} {out + n}", f"2 {n} {n}", f"1 {n}", "", *gates]) + "\n"


CLI = "reverie_tpu_torch.cli"


def cli_env() -> dict:
    """The environment of a fresh process that imports this checkout's
    reverie_tpu_torch."""
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])]))


def cli_runs(*jobs) -> list:
    """Run each job, (tag, argv, expect) or (tag, argv, expect, module), as
    `python -m module argv` (module: the CLI) in a fresh process on the
    card, all at once, and log each one's wall and last lines.  expect:
    "ok" (rc 0; for the CLI, "Ok(())" or "proof written" on stdout),
    "reject" (rc 1, stderr exactly "Unverifiable Proof": no traceback) or
    "fail" (non-zero).  Returns their stdouts."""
    runs = []
    try:
        for tag, argv, expect, *module in jobs:
            module = module[0] if module else CLI
            out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
            runs.append({"tag": tag, "expect": expect, "module": module, "out": out,
                         "err": err, "t": time.perf_counter(), "proc": subprocess.Popen(
                             [sys.executable, "-m", module, *map(str, argv)], cwd=ROOT,
                             env=cli_env(), stdout=out, stderr=err, text=True)})
        deadline = time.perf_counter() + CLI_TIMEOUT_S
        while any("rc" not in r for r in runs):
            if time.perf_counter() > deadline:
                raise AssertionError(f"cli: a run took more than {CLI_TIMEOUT_S} s")
            for r in runs:
                if "rc" not in r and r["proc"].poll() is not None:
                    r["rc"], r["wall_s"] = r["proc"].returncode, time.perf_counter() - r["t"]
            time.sleep(0.02)
    finally:
        for r in runs:
            if r["proc"].poll() is None:
                r["proc"].kill()
                r["proc"].wait()
    stdouts = []
    for r in runs:
        r["out"].seek(0)
        r["err"].seek(0)
        out, err = r["out"].read(), r["err"].read()
        r["out"].close()
        r["err"].close()
        rc, module = r["rc"], r["module"]
        last = " | ".join([*out.splitlines()[-2:], *err.splitlines()[-1:]])
        alone = "" if len(runs) == 1 else f" (one of {len(runs)} at once)"
        log("cli", f"{r['tag']} rc={rc} wall_s={r['wall_s']:.3f}{alone} | {last}")
        ok = {"ok": rc == 0 and (module != CLI or "Ok(())" in out or "proof written" in out),
              "reject": rc == 1 and err.strip() == "Unverifiable Proof",
              "fail": rc != 0}[r["expect"]]
        if not ok:
            raise AssertionError(f"cli {r['tag']}: expected {r['expect']}, rc {rc}\n"
                                 f"{out[-2000:]}\n{err[-4000:]}")
        stdouts.append(out)
    return stdouts


def cli_inprocess(tag: str, argv, urandom: bytes = b""):
    """cli.main(argv) in this process, its stages timed: load_program (and
    the witness), make_system (the system the CLI builds: the compile),
    prove or verify, and the rest (verify: Proof.from_bytes; prove:
    to_bytes and the write).  With `urandom`, os.urandom of its length
    returns it (the proof's rep seeds).  Returns the system the CLI built."""
    from reverie_tpu_torch import cli

    split, systems = {}, []

    def stage(name, fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                split[name] = split.get(name, 0.0) + time.perf_counter() - t
        return run

    def system(*args, **kwargs):
        s = saved["_backend_system"](*args, **kwargs)
        s.prove, s.verify = stage("prove", s.prove), stage("verify", s.verify)
        systems.append(s)
        return s

    saved = {n: getattr(cli, n) for n in ("_load_program", "_load_witness", "_backend_system")}
    real_urandom = os.urandom
    cli._load_program = stage("load_program", saved["_load_program"])
    cli._load_witness = stage("load_program", saved["_load_witness"])
    cli._backend_system = stage("make_system", system)
    if urandom:
        os.urandom = lambda n: urandom if n == len(urandom) else real_urandom(n)
    out = io.StringIO()
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main([str(a) for a in argv])
        total = time.perf_counter() - t
    finally:
        os.urandom = real_urandom
        for name, fn in saved.items():
            setattr(cli, name, fn)
    split["rest"] = total - sum(split.values())
    split = {"total": total, **split}
    log("cli", f"{tag} in-process rc={rc} system={type(systems[0]).__name__} split_s="
        + json.dumps({k: round(v, 4) for k, v in split.items()}) + " | "
        + " | ".join(out.getvalue().splitlines()))
    if rc != 0:
        raise AssertionError(f"cli {tag} in-process: rc {rc}")
    return systems[0]


def cli_verify_file(tag: str, kkw, path: Path) -> None:
    """A proof file read with Proof.from_bytes, verified here by `kkw`, a
    TorchKKW."""
    from reverie_tpu_torch import TorchKKW
    from reverie_tpu_torch.proof import Proof

    if not isinstance(kkw, TorchKKW):
        raise AssertionError(f"cli {tag}: make_system gave {type(kkw).__name__}")
    t = time.perf_counter()
    ok = kkw.verify(Proof.from_bytes(path.read_bytes()))
    torch.cuda.synchronize()
    log("cli", f"{tag}: the subprocess's proof file, verified in-process by TorchKKW: {ok} "
        f"verify_s={time.perf_counter() - t:.4f}")
    if ok is not True:
        raise AssertionError(f"cli {tag}: the proof file did not verify in-process")


def cli_phase(rng) -> dict:
    """The CLI on the card (phase 13 of the docstring).  Returns the launches
    of the in-process SHA-256 prove, which must include K1, K3 and W1."""
    import hashlib

    from reverie_tpu_torch import parity as golden
    from reverie_tpu_torch.circuit import dumps_program, format_witness_bits
    from reverie_tpu_torch.circuit.builders import mul_bench_circuit

    started = time.perf_counter()
    t = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", CLI_START], cwd=ROOT, capture_output=True,
                       text=True, timeout=CLI_TIMEOUT_S, env=cli_env())
    if r.returncode:
        raise AssertionError(f"cli start: {r.stderr[-4000:]}")
    log("cli", f"a fresh process's start wall_s={time.perf_counter() - t:.3f} "
        f"split_s={r.stdout.strip()}")
    with tempfile.TemporaryDirectory(prefix="reverie_cli_") as tmp:
        d = Path(tmp)
        from reverie_tpu_torch.proof import Proof
        from reverie_tpu_torch.tools import make_sha256_statement

        msg, out = golden.SHA256_MESSAGE, io.StringIO()
        with contextlib.redirect_stdout(out):
            make_sha256_statement.main(["--message", msg.decode(), str(d / "sha")])
        log("cli", "make_sha256_statement: " + " | ".join(out.getvalue().splitlines()))
        if hashlib.sha256(msg).hexdigest() not in out.getvalue():
            raise AssertionError("make_sha256_statement printed another digest")
        prog, wit, proof = d / "sha" / "program.bin", d / "sha" / "witness.txt", d / "sha.bin"
        n_ops = int.from_bytes(prog.read_bytes()[:8], "little")
        seg = -(-n_ops // 3)
        prove = ["--operation", "prove", "--program-path", prog, "--witness-path", wit]
        verify = ["--operation", "verify", "--program-path", prog]
        cli_runs(("sha256 prove", [*prove, "--proof-path", proof], "ok"))
        cli_runs(("sha256 verify", [*verify, "--proof-path", proof], "ok"))
        (d / "bad.bin").write_bytes(flipped(Proof.from_bytes(proof.read_bytes()),
                                            "gf2").to_bytes())
        n = ADDER_BITS
        a, b = (int.from_bytes(rng.bytes(8), "little") for _ in range(2))
        bits = lambda v: "".join(str((v >> i) & 1) for i in range(n))  # noqa: E731
        (d / "adder.txt").write_text(ripple_adder_bristol(n))
        (d / "adder_wit.txt").write_text(bits(a) + bits(b))
        right = bits((a + b) % (1 << n))
        wrong = right[:-1] + ("1" if right[-1] == "0" else "0")
        bristol = ["--operation", "oneshot-zk", "--program-path", d / "adder.txt",
                   "--witness-path", d / "adder_wit.txt", "--format", "bristol"]
        *_, out = cli_runs(
            (f"sha256 prove --segment-ops {seg} ({n_ops} ops)",
             [*prove, "--proof-path", d / "seg.bin", "--segment-ops", seg], "ok"),
            ("sha256 verify, a flipped GF(2) online byte", [*verify, "--proof-path",
                                                            d / "bad.bin"], "reject"),
            ("sha256 oneshot", ["--operation", "oneshot", "--program-path", prog,
                                "--witness-path", wit], "ok"),
            ("b2a golden verify", ["--operation", "verify", "--program-path",
                                   GOLDEN / "b2a_program.bin", "--proof-path",
                                   GOLDEN / "b2a_proof.bin"], "ok"),
            (f"bristol {n}-bit adder, its right output", [*bristol, "--bristol-output", right],
             "ok"),
            (f"bristol {n}-bit adder, a wrong output", [*bristol, "--bristol-output", wrong],
             "fail"),
            ("inspect_proof", [proof], "ok", "reverie_tpu_torch.tools.inspect_proof"))
        if "[gf2] 40 online openings, 216 preprocessing openings" not in out:
            raise AssertionError("inspect_proof printed another structure")

        case = golden.CASES["sha256_1block"]
        seeds = golden.inputs(case)[3]
        reset_launches()
        kkw = cli_inprocess("sha256 prove", [*prove, "--proof-path", d / "sha_golden.bin"],
                            seeds.tobytes())
        launches = launch_counts()
        equal = golden.matches(case, (d / "sha_golden.bin").read_bytes())
        log("cli", f"sha256 in-process proof (os.urandom: sha256_1block's seeds) "
            f"equal_to_numpy_golden_digest={equal} launches={json.dumps(launches)}")
        if not equal:
            raise AssertionError("the CLI's SHA-256 proof differs from the golden's digest")
        missing = [k for k in ("aes_tape_gf2", "blake3_chunk_cvs", "blake3_tail", "scan_gf2")
                   if not launches[k]]
        if missing:
            raise AssertionError(f"the CLI's prove did not launch {missing}")
        cli_verify_file("sha256", kkw, proof)
        cli_verify_file("sha256 streamed (--segment-ops), unsegmented", kkw, d / "seg.bin")
        del kkw

        prog, w2, _ = mul_bench_circuit(N_MUL)
        big, wit, proof = d / "mul1m.bin", d / "mul1m.txt", d / "mul1m_proof.bin"
        big.write_bytes(dumps_program(prog))
        wit.write_bytes(format_witness_bits(w2))
        del prog
        log("cli", f"mul_bench_circuit({N_MUL}) program file {big.stat().st_size} B")
        cli_runs(("1M-AND prove", ["--operation", "prove", "--program-path", big,
                                   "--witness-path", wit, "--proof-path", proof], "ok"))
        cli_runs(("1M-AND verify", ["--operation", "verify", "--program-path", big,
                                    "--proof-path", proof], "ok"))
        argv = ["--operation", "prove", "--program-path", big, "--witness-path", wit,
                "--proof-path", d / "mul1m_inproc.bin"]
        cache = os.environ["REVERIE_COMPILE_CACHE"]
        os.environ["REVERIE_COMPILE_CACHE"] = "0"
        try:
            cli_inprocess("1M-AND prove, compile cache off", argv)
        finally:
            os.environ["REVERIE_COMPILE_CACHE"] = cache
        kkw = cli_inprocess("1M-AND prove, compile cache on (the prove subprocess's entry)",
                            argv)
        cli_verify_file("1M-AND", kkw, proof)
        del kkw

    log("cli", f"phase_s={time.perf_counter() - started:.1f} launches={json.dumps(launches)}")
    return launches


# -- phase 14: the mesh --------------------------------------------------------

#: the lanes of a shard of the 12-shard mesh in each leg (256 -> 22 / 21,
#: 40 -> 4 / 3, 216 -> 18) and the role that runs them
SHARD_WIDTHS = ((0, 22), (0, 21), (1, 4), (1, 3), (2, 18))
#: the small GF(2) circuit of the 48-shard case (more shards than the 40
#: online reps): its streams fit one BLAKE3 chunk, so that each of the 48
#: shards' hash tails is short (25.5 s on an H100 at 2,000 ANDs)
MESH_SMALL_ANDS = 200
#: the two-process case: its processes (all on cuda:0) and the SHA-256
#: statements of its prove_batch_distributed (then one fewer: uneven slices)
MESH_PROCESSES, MESH_BATCH = 2, 8
#: the first argument that makes this script one of those processes
MESH_CHILD = "--mesh-child"
#: the card every shard of the one-card meshes runs on
MESH_DEVICE = "cuda:0"


def card_mesh(k: int):
    """k shards of this process on MESH_DEVICE."""
    from reverie_tpu_torch.parallel import make_mesh

    return make_mesh(devices=[torch.device(MESH_DEVICE)] * k)


def counted(acc: dict, fn):
    """fn(), with the launch counts set to 0 just before it and added into
    acc just after."""
    reset_launches()
    out = fn()
    for k, v in launch_counts().items():
        acc[k] = acc.get(k, 0) + v
    return out


def shard_inputs(rng, cc, mode: int, R: int) -> dict:
    """Random executor inputs of a role at R lanes on the host: both tapes;
    the witnesses (prove); or (online verify) the tapes zero at each rep's
    omitted player, the input and correction records, the GF(2) recon bits
    at that player's bit and the z64 recon words at its share."""
    def bits(n: int, high: int = 2):
        return rng.randint(0, high, (n, R), dtype=np.uint8)

    def words(*shape):
        return rng.randint(-2**63, 2**63 - 1, shape, dtype=np.int64)

    inp = {"tape": bits(cc.m2, 256), "tapez": words(cc.mz, 8, R)}
    if mode == 0:
        inp.update(wit2=bits(cc.n_wit2), witz=words(cc.n_witz, R))
    elif mode == 1:
        omit = rng.randint(0, 8, R)
        inp["tape"] &= ~(0x80 >> omit).astype(np.uint8)
        inp["tapez"] *= np.arange(8)[:, None] != omit
        inp.update(in2=bits(cc.n_inputs2), co2=bits(cc.n_corrs2),
                   re2=(bits(cc.n_recons2) << (7 - omit)).astype(np.uint8),
                   inz=words(cc.n_inputsz, R), coz=words(cc.n_corrsz, R),
                   rez=words(cc.n_reconsz, 1, R) * (np.arange(8)[:, None] == omit))
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in inp.items()}


def mesh_kernels(dev, rng, sha_cc, b2a_cc, checks: dict) -> None:
    """The kernels of the 12-shard path at its shard widths (SHARD_WIDTHS),
    each byte-equal to its plain version on the same inputs: K1 at the
    SHA-256 statement's m2 and K4 at the B2A golden's mz (random omits on
    the online widths), K3 on the SHA-256 onl2 rows; W1 on the SHA-256
    statement's and W2 on the B2A golden's wave programs in each width's
    role, every output against the plain version's on the CPU (one plain
    run a role over the lanes of all its widths side by side: the lanes
    are independent)."""
    from reverie_tpu_torch.backend import scan
    from reverie_tpu_torch.crypto.kernels import aes_tape, aes_tape_z64, blake3 as b3

    cpu = torch.device("cpu")
    for mode, R in SHARD_WIDTHS:
        line = f"shard width R={R} ({ROLES[mode]})"
        rk = aes_tape.round_keys(rng.randint(0, 256, (R, 8, 16), dtype=np.uint8), dev)
        omit = None if mode != 1 else torch.from_numpy(
            rng.randint(0, 8, R).astype(np.uint8)).to(dev)
        check("aes_tape_gf2", checks["aes_tape_gf2"], aes_tape.aes_ctr_tape_gf2(
            rk, sha_cc.m2, omit), aes_tape.aes_ctr_tape_gf2_ref(rk, sha_cc.m2, omit),
            f"{line} m2={sha_cc.m2}")
        check("aes_tape_z64", checks["aes_tape_z64"], aes_tape_z64.aes_ctr_tape_z64(
            rk, b2a_cc.mz, omit), aes_tape_z64.aes_ctr_tape_z64_ref(rk, b2a_cc.mz, omit),
            f"{line} mz={b2a_cc.mz}")
        n = sha_cc.onl2 // b3.CHUNK_LEN
        buf = torch.from_numpy(rng.randint(0, 256, (sha_cc.onl2, R), dtype=np.uint8)).to(dev)
        check("blake3_chunk_cvs", checks["blake3_chunk_cvs"], b3.chunk_cvs(buf, n),
              b3.chunk_cvs_ref(buf, n), f"{line} n={n}")
    for name, cc in (("scan_gf2", sha_cc), ("scan_z64", b2a_cc)):
        for mode in ROLES:
            widths = [R for m, R in SHARD_WIDTHS if m == mode]
            inp = shard_inputs(rng, cc, mode, sum(widths))
            want = scan.ScanExecutor(cc, mode, sum(widths), cpu)(inp)
            off = 0
            for R in widths:
                got = scan.ScanExecutor(cc, mode, R, dev)(
                    {k: v[..., off : off + R].contiguous().to(dev) for k, v in inp.items()})
                for key in WAVE_OUTS:
                    check(name, checks[name], got[key].cpu(), want[key][..., off : off + R],
                          f"shard width R={R} ({ROLES[mode]}) {key}")
                off += R


def mesh_prove(dev, tag: str, mesh, main: dict, acc: dict) -> None:
    """The GF(2) main path on a mesh (phase 14's cases 1 and 6): the proof
    of phase 4's circuit and seeds equal to phase 4's, verify True, a
    flipped byte False; sharded and unsharded walls in turns with their
    phases; the launches of the sharded prove and verify; the peak
    max_memory_allocated of a sharded prove against device_footprint (at
    most PEAK_OVER_FOOTPRINT x)."""
    from reverie_tpu_torch import TorchKKW, device_footprint

    prog, w2, wz, cc, seeds = (main[k] for k in ("prog", "w2", "wz", "cc", "seeds"))
    want = main["proof"].to_bytes()
    kkw = TorchKKW(prog, cc=cc, mesh=mesh)
    one = TorchKKW(prog, cc=cc, device=dev)
    launches: dict = {}
    proof, t = counted(launches, lambda: wall(lambda: kkw.prove(w2, wz, seeds=seeds)))
    log(tag, f"shards={len(mesh)} cold prove wall_s={t:.4f} equal_to_phase_4={proof.to_bytes() == want}")
    if proof.to_bytes() != want:
        raise AssertionError(f"{tag}: the sharded proof differs from the unsharded one")
    one.prove(w2, wz, seeds=seeds)  # warm
    walls = {"unsharded": [], "sharded": []}
    for who in ("unsharded", "sharded", "sharded", "unsharded"):
        system = one if who == "unsharded" else kkw
        _, t = wall(lambda: system.prove(w2, wz, seeds=seeds))
        walls[who].append(t)
        log(tag, f"warm prove {who} wall_s={t:.4f} phases "
            + json.dumps(phase_summary(system.last_timings)))
    for who, system in (("unsharded", one), ("sharded", kkw)):
        ok, t = wall(lambda: system.verify(proof))
        log(tag, f"verify {who}={ok} wall_s={t:.4f} phases "
            + json.dumps(phase_summary(system.last_timings)))
        if ok is not True:
            raise AssertionError(f"{tag}: the {who} verify rejected the proof")
    del one
    ok = counted(launches, lambda: kkw.verify(proof))
    for k, v in launches.items():
        acc[k] = acc.get(k, 0) + v
    log(tag, f"walls_s={json.dumps(walls)} launches(cold prove + verify)="
        f"{json.dumps({k: v for k, v in launches.items() if v})}")
    tampered = kkw.verify(flipped(proof, "gf2"))
    log(tag, f"tampered gf2 online opening verify={tampered}")
    if ok is not True or tampered is not False:
        raise AssertionError(f"{tag}: a sharded verdict is wrong")
    gc.collect()
    torch.cuda.empty_cache()
    fp = device_footprint(cc, 256)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kkw.prove(w2, wz, seeds=seeds)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(tag, f"sharded prove peak_bytes={peak} allocated_before={base} footprint={fp} "
        f"peak/footprint={peak / fp:.4f}")
    if peak > PEAK_OVER_FOOTPRINT * fp:
        raise AssertionError(f"{tag}: peak {peak} B above {PEAK_OVER_FOOTPRINT} x footprint")


def mesh_child(rank: str, nproc: str, port: str, out: str) -> int:
    """One process of phase 14's two-process case (started by mesh_phase
    with MESH_CHILD): joins the gloo group, proves the 1M-AND circuit on a
    global mesh of every process's cuda:0 (equal to phase 4's proof,
    verified), then prove_batch_distributed of MESH_BATCH and MESH_BATCH -
    1 SHA-256 statements (equal to TorchKKW.prove's with their seeds);
    writes its walls and verdicts to <out>/child_<rank>.json."""
    import datetime

    from reverie_tpu_torch import TorchKKW
    from reverie_tpu_torch import parity as golden
    from reverie_tpu_torch.circuit.builders import mul_bench_circuit
    from reverie_tpu_torch.parallel import distributed as dist

    d, rank = Path(out), int(rank)
    dist.initialize(f"127.0.0.1:{port}", int(nproc), rank,
                    timeout=datetime.timedelta(seconds=300))
    dev = torch.device(MESH_DEVICE)
    gm = dist.global_mesh(devices=[dev])
    res = {"rank": rank, "shards": len(gm), "multiprocess": dist.mesh_is_multiprocess(gm)}
    prog, w2, wz = mul_bench_circuit(N_MUL)
    seeds = np.load(d / "seeds.npy")
    kkw = TorchKKW(prog, mesh=gm)
    for run in ("cold", "warm"):
        proof, res[f"{run}_prove_s"] = wall(lambda: kkw.prove(w2, wz, seeds=seeds))
    res["prove_phases"] = phase_summary(kkw.last_timings)
    res["equal_to_phase_4"] = proof.to_bytes() == (d / "proof.bin").read_bytes()
    res["verify"], res["verify_s"] = wall(lambda: kkw.verify(proof))
    res["tampered_verify"] = kkw.verify(flipped(proof, "gf2"))
    del kkw
    sha, sha_w2, sha_wz, _ = golden.inputs(golden.CASES["sha256_1block"])
    sha_seeds = np.load(d / "sha_seeds.npy")
    system = TorchKKW(sha, device=dev)
    for n in (MESH_BATCH, MESH_BATCH - 1):
        got, res[f"batch{n}_s"] = wall(lambda: dist.prove_batch_distributed(
            system, [(sha_w2, sha_wz)] * n, sha_seeds[:n]))
        res[f"batch{n}_equal"] = [p.to_bytes() == (d / f"sha_{i}.bin").read_bytes()
                                  for i, p in enumerate(got)]
    (d / f"child_{rank}.json").write_text(json.dumps(res))
    ok = (res["equal_to_phase_4"] and res["verify"] is True and res["tampered_verify"] is False
          and all(res[f"batch{MESH_BATCH}_equal"]) and all(res[f"batch{MESH_BATCH - 1}_equal"]))
    return 0 if ok else 1


def mesh_processes(dev, main: dict) -> None:
    """Phase 14's two-process case: MESH_PROCESSES copies of this script on
    cuda:0 (mesh_child) over a gloo group on a free loopback port, handed
    phase 4's seeds and proof and the SHA-256 references
    (TorchKKW.prove with each seed) through a temporary directory; every
    child must exit 0 within its limit."""
    import socket

    from reverie_tpu_torch import TorchKKW
    from reverie_tpu_torch import parity as golden

    with tempfile.TemporaryDirectory() as tmp, socket.socket() as sock:
        d = Path(tmp)
        np.save(d / "seeds.npy", main["seeds"])
        (d / "proof.bin").write_bytes(main["proof"].to_bytes())
        sha, sha_w2, sha_wz, _ = golden.inputs(golden.CASES["sha256_1block"])
        sha_seeds = np.random.RandomState(14).randint(0, 256, (MESH_BATCH, 256, 16),
                                                      dtype=np.uint8)
        np.save(d / "sha_seeds.npy", sha_seeds)
        system = TorchKKW(sha, device=dev)
        for i, s in enumerate(sha_seeds):
            (d / f"sha_{i}.bin").write_bytes(system.prove(sha_w2, sha_wz, seeds=s).to_bytes())
        del system
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
        sock.close()
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        t = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), MESH_CHILD,
                                   str(i), str(MESH_PROCESSES), port, tmp], env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for i in range(MESH_PROCESSES)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=300)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        log("mesh_procs", f"processes={MESH_PROCESSES} on cuda:0 wall_s="
            f"{time.perf_counter() - t:.3f} rcs={[p.returncode for p in procs]}")
        for i, (p, text) in enumerate(zip(procs, outs)):
            res = d / f"child_{i}.json"
            log("mesh_procs", res.read_text() if res.exists() else "no result")
            if p.returncode != 0:
                raise AssertionError(f"mesh child {i} exited {p.returncode}:\n{text[-3000:]}")


def mesh_phase(dev, rng, checks: dict, main: dict) -> dict:
    """Phase 14, lanes sharded over a mesh (reverie_tpu_torch.parallel) on
    one card: 4 shards on phase 4's path; 12 shards (a non-divisor of 256,
    40 and 216) on the SHA-256 statement (W1) and the B2A golden (W2), and
    the kernels at those shard widths against their plain versions; 48
    shards (more than the 40 online reps) on a small GF(2) circuit;
    make_system's streaming on 4 shards (1M ANDs under 512 MiB, the z64
    chain in 1,000-op segments); two processes on cuda:0; 4 shards on two
    cards where there are two.  Each path's launches are counted from 0
    just before it and read just after; K1, K3, K4, the tail, W1 and W2
    must each launch.  Returns those launches."""
    from reverie_tpu_torch import StreamingKKW, TorchKKW, make_system
    from reverie_tpu_torch import parity as golden
    from reverie_tpu_torch.circuit import load_program
    from reverie_tpu_torch.circuit.builders import mixed_b2a_circuit, mul_bench_circuit
    from reverie_tpu_torch.parallel import lane_slices, make_mesh
    from reverie_tpu_torch.proof import Proof
    from reverie_tpu_torch.tools import wave_times

    started = time.perf_counter()
    acc: dict = {}
    steps = {}

    def step(name: str) -> None:
        steps[name] = round(time.perf_counter() - started - sum(steps.values()), 3)

    mesh4 = card_mesh(4)
    # 1. four shards on phase 4's circuit and seeds, and the 50k-AND digest
    mesh_prove(dev, "mesh4", mesh4, main, acc)
    case = golden.CASES["gf2_50k"]
    prog, w2, wz, seeds = golden.inputs(case)
    got = counted(acc, lambda: TorchKKW(prog, mesh=mesh4).prove(w2, wz, seeds=seeds).to_bytes())
    log("mesh4", f"gf2_50k equal_to_numpy_golden_digest={golden.matches(case, got)}")
    if not golden.matches(case, got):
        raise AssertionError("mesh4: the 50k-AND proof differs from the golden's")
    step("mesh4")

    # 2. twelve shards: SHA-256 (W1) and the B2A golden (W2)
    mesh12 = card_mesh(12)
    case = golden.CASES["sha256_1block"]
    prog, w2, wz, seeds = golden.inputs(case)
    kkw = TorchKKW(prog, mesh=mesh12)
    for run in ("cold", "warm"):
        proof, t = counted(acc, lambda: wall(lambda: kkw.prove(w2, wz, seeds=seeds)))
        log("mesh12", f"sha256 {run} prove wall_s={t:.4f} phases "
            + json.dumps(phase_summary(kkw.last_timings)))
    one = TorchKKW(prog, cc=kkw.cc, device=dev)
    one.prove(w2, wz, seeds=seeds)
    _, t = wall(lambda: one.prove(w2, wz, seeds=seeds))
    log("mesh12", f"sha256 unsharded warm prove wall_s={t:.4f} phases "
        + json.dumps(phase_summary(one.last_timings)))
    del one
    ok, t = counted(acc, lambda: wall(lambda: kkw.verify(proof)))
    log("mesh12", f"sha256 equal_to_golden_digest={golden.matches(case, proof.to_bytes())} "
        f"verify={ok} wall_s={t:.4f} launches={json.dumps({k: v for k, v in acc.items() if v})}")
    if not golden.matches(case, proof.to_bytes()) or ok is not True:
        raise AssertionError("mesh12: the SHA-256 proof or its verify is wrong")
    sha_cc = kkw.cc
    del kkw
    bprog = load_program((GOLDEN / "b2a_program.bin").read_bytes())
    bseeds = np.frombuffer((GOLDEN / "b2a_seeds.bin").read_bytes(), np.uint8).reshape(256, 16)
    blob = (GOLDEN / "b2a_proof.bin").read_bytes()
    _, bw2, bwz = mixed_b2a_circuit()
    kkw = TorchKKW(bprog, mesh=mesh12)
    got = counted(acc, lambda: kkw.prove(bw2, bwz, seeds=bseeds).to_bytes())
    ok = counted(acc, lambda: kkw.verify(Proof.from_bytes(blob)))
    log("mesh12", f"golden b2a_proof.bin equal={got == blob} verify={ok} executors="
        f"{sorted({type(e).__name__ for e in kkw._executors.values()})}")
    if got != blob or ok is not True:
        raise AssertionError("mesh12: the golden B2A proof was not reproduced")
    step("mesh12")
    mesh_kernels(dev, rng, sha_cc, kkw.cc, checks)
    del kkw
    step("mesh12_kernels")

    # 3. 48 shards: more than the 40 online reps
    mesh48 = card_mesh(48)
    prog, w2, wz = mul_bench_circuit(MESH_SMALL_ANDS)
    seeds = rng.randint(0, 256, (256, 16), dtype=np.uint8)
    want = TorchKKW(prog, device=dev).prove(w2, wz, seeds=seeds).to_bytes()
    kkw = TorchKKW(prog, mesh=mesh48)
    proof = counted(acc, lambda: kkw.prove(w2, wz, seeds=seeds))
    ok = counted(acc, lambda: kkw.verify(proof))
    empty = sum(sl.stop == sl.start for sl in lane_slices(40, mesh48))
    log("mesh48", f"mul_bench_circuit({MESH_SMALL_ANDS}) empty_online_shards={empty} "
        f"equal={proof.to_bytes() == want} verify={ok}")
    if proof.to_bytes() != want or ok is not True or empty != 8:
        raise AssertionError("mesh48: the proof or its verify is wrong")
    del kkw
    step("mesh48")

    # 4. streaming on four shards
    sk = make_system(main["prog"], hbm_budget_bytes=STREAM_BUDGETS["gf2"], mesh=mesh4)
    if not isinstance(sk, StreamingKKW) or sk.mesh is not mesh4:
        raise AssertionError("mesh_stream: make_system did not stream on the mesh")
    want = main["proof"].to_bytes()
    stream_case(dev, "mesh_stream_gf2", sk, main["w2"], main["wz"], main["seeds"],
                lambda b: b == want, "gf2", acc, STREAM_BUDGETS["gf2"])
    del sk
    prog, w2, wz = wave_times.z64_statements()["chain"]()
    seeds = rng.randint(0, 256, (256, 16), dtype=np.uint8)
    want = TorchKKW(prog, device=dev).prove(w2, wz, seeds=seeds).to_bytes()
    sk = StreamingKKW(prog, STREAM_CHAIN_OPS, mesh=mesh4)
    stream_case(dev, "mesh_stream_chain", sk, w2, wz, seeds, lambda b: b == want, "z64", acc)
    del sk
    step("mesh_stream")

    # 5. two processes on one card; 6. two cards
    mesh_processes(dev, main)
    step("mesh_procs")
    if torch.cuda.device_count() >= 2:
        mesh_prove(dev, "mesh2cards", make_mesh(2), main, acc)
    else:
        log("mesh2cards", f"skipped: {torch.cuda.device_count()} CUDA device visible")
    log("mesh", f"phase_s={time.perf_counter() - started:.1f} steps_s={json.dumps(steps)} "
        f"launches={json.dumps(acc)}")
    missing = [k for k in STREAM_KERNELS if not acc.get(k)]
    if missing:
        raise AssertionError(f"the mesh phase did not launch {missing}")
    return acc



# -- phase 15: past the card ---------------------------------------------------

#: phase 15's cases: (tools.past_card case, the kernels its streamed run must launch)
PAST_CARD_CASES = (("gf2", ("aes_tape_gf2", "blake3_chunk_cvs", "blake3_tail")),
                   ("z64", ("aes_tape_z64", "blake3_chunk_cvs", "blake3_tail")))
PAST_CARD_TIMEOUT_S = 600


def past_card_phase() -> dict:
    """Phase 15: each case of tools/past_card.py in a fresh process on the
    card (the module's docstring), its JSON line logged and checked here.
    Returns the launches of the cases' streamed runs."""
    started, acc = time.perf_counter(), {}
    for case, kernels in PAST_CARD_CASES:
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "reverie_tpu_torch.tools.past_card", case],
                             cwd=ROOT, env=cli_env(), capture_output=True, text=True,
                             timeout=PAST_CARD_TIMEOUT_S)
        lines = [ln for ln in run.stdout.splitlines() if ln.startswith("{")]
        if run.returncode != 0 or not lines:
            raise AssertionError(f"past_card {case}: rc {run.returncode}\n"
                                 f"{run.stdout[-4000:]}\n{run.stderr[-4000:]}")
        res = json.loads(lines[-1])
        tag = f"past_{case}"
        log(tag, f"ops={res['ops']} process_wall_s={time.perf_counter() - t:.1f} "
            f"device_footprint={res['device_footprint']} device_budget={res['device_budget']} "
            f"footprint/budget={res['footprint_over_budget']:.4f} "
            f"(whole compile {res['whole_compile_s']:.2f} s) free_bytes={res['free_bytes']}")
        log(tag, f"make_system gave {res['system']} segments={res['segments']} "
            f"seg_ops={res['seg_ops']} segment_footprint_max={res['segment_footprint_max']} "
            f"({res['segment_footprint_over_budget']:.4f} of the budget) "
            f"setup: build_s={res['build_s']:.3f} make_system_s={res['make_system_s']:.3f}")
        for run_name in ("cold_prove", "warm_prove"):
            log(tag, f"{run_name} wall_s={res[run_name + '_s']:.4f} phases [host_ms, device_ms] "
                + json.dumps(res[run_name + "_phases"]))
        log(tag, f"verify={res['verify']} wall_s={res['verify_s']:.4f} phases "
            + json.dumps(res["verify_phases"]))
        log(tag, f"flipped online byte verify={res['flipped_verify']} "
            f"cold/warm proofs equal={res['proofs_equal']} proof_bytes={res['proof_bytes']} "
            f"peak_bytes={res['peak_bytes']} peak/budget={res['peak_over_budget']:.4f} "
            f"host_peak_rss_bytes={res['host_peak_rss_bytes']} "
            f"launches={json.dumps(res['launches'])}")
        for c in res["kernel_checks"]:
            log(tag, "last segment " + json.dumps(c))
        log(tag, f"cut {json.dumps(res['cut'])}")
        if res["failures"] or any(res["launches"][k] < 1 for k in kernels):
            raise AssertionError(f"past_card {case}: {res['failures']}")
        for k, v in res["launches"].items():
            acc[k] = acc.get(k, 0) + v
    log("past", f"phase_s={time.perf_counter() - started:.1f} launches={json.dumps(acc)}")
    return acc


# -- phase 16: the CLI past the card -------------------------------------------

PAST_CLI_TIMEOUT_S = 900


def past_cli_phase() -> dict:
    """Phase 16: tools/past_card.py's cli case in a fresh process (the
    module's docstring), its JSON line logged and checked here.  Returns the
    launches of its three CLI processes."""
    started, acc = time.perf_counter(), {}
    gc.collect()
    torch.cuda.empty_cache()
    run = subprocess.run([sys.executable, "-m", "reverie_tpu_torch.tools.past_card", "cli"],
                         cwd=ROOT, env=cli_env(), capture_output=True, text=True,
                         timeout=PAST_CLI_TIMEOUT_S)
    lines = [ln for ln in run.stdout.splitlines() if ln.startswith("{")]
    if not lines:
        raise AssertionError(f"past_card cli: rc {run.returncode}\n{run.stdout[-4000:]}\n"
                             f"{run.stderr[-4000:]}")
    res = json.loads(lines[-1])
    log("past_cli", f"mul_bench_circuit({res['ops']}) file_bytes={res.get('file_bytes')} "
        f"build_s={res.get('build_s')} write_file_s={res.get('write_file_s')} (the C writer) "
        f"writer_cut={json.dumps(res.get('writer_cut'))}")
    for leg in ("prove", "verify", "tampered"):
        r = res.get(leg)
        if r is None:
            continue
        log("past_cli", f"{leg} rc={r['rc']} process_wall_s={r['process_wall_s']:.3f} "
            f"split_s={json.dumps({k: round(v, 4) for k, v in r['split_s'].items()})} "
            f"system={r['system']} segments={r['segments']}")
        log("past_cli", f"{leg} device_budget={r['device_budget']} peak_bytes={r['peak_bytes']} "
            f"peak/budget={r['peak_bytes'] / max(r['device_budget'] or 1, 1):.4f} "
            f"host_peak_rss_bytes={r['host_peak_rss_bytes']} launches={json.dumps(r['launches'])}"
            f" | {' | '.join(r['out'][-2:])} | stderr: {r['stderr_last']}")
        for k, v in r["launches"].items():
            acc[k] = acc.get(k, 0) + v
    log("past_cli", f"proof_bytes={res.get('proof_bytes')} tampered_at={res.get('tampered_at')} "
        f"cut {json.dumps(res.get('cut'))}")
    log("past_cli", f"phase_s={time.perf_counter() - started:.1f} rc={run.returncode} "
        f"failures={res['failures']} launches={json.dumps(acc)}")
    if run.returncode != 0 or res["failures"]:
        raise AssertionError(f"past_card cli: {res['failures']}\n{run.stderr[-4000:]}")
    return acc


KERNELS = (  # name, source, replaces (file:line of every TPU function)
    ("aes_tape_gf2", "reverie_tpu_torch/csrc/aes_tape.cu",
     "reverie_tpu/crypto/kernels/aes_pallas.py:128, reverie_tpu/crypto/kernels/aes_pallas.py:425"),
    ("aes_tape_z64", "reverie_tpu_torch/csrc/aes_tape_z64.cu",
     "reverie_tpu/crypto/kernels/aes_pallas.py:458"),
    ("blake3_chunk_cvs", "reverie_tpu_torch/csrc/blake3_chunks.cu",
     "reverie_tpu/crypto/kernels/blake3_pallas.py:74"),
    ("blake3_tail", "reverie_tpu_torch/csrc/blake3_tail.cu",
     "reverie_tpu/crypto/kernels/blake3_jax.py:293 _tree_reduce, :320 hash_columns (its tail, "
     ":333-363), :409 finalize_columns, :492 hash_pair_columns (XLA in TpuKKW._hash_fn, "
     "reverie_tpu/backend/tpu_host.py:920; no Pallas)"),
    ("aes_ctr_planes", "reverie_tpu_torch/csrc/aes_planes.cu",
     "reverie_tpu/crypto/kernels/aes_pallas.py:34"),
    ("copy", "reverie_tpu_torch/csrc/copy.cu", "tools/r4_bwroof.py:52"),
    ("u32_to_u8_rows", "reverie_tpu_torch/csrc/u8emit.cu",
     "tools/r5_u8emit.py:33, tools/r5_u8emit.py:42, tools/r5_u8emit.py:75, "
     "tools/r5_u8emit.py:124"),
    ("pack_shift", "reverie_tpu_torch/csrc/pack_shift.cu",
     "tools/r4_extract_probe.py:143, tools/r4_extract_probe.py:308, "
     "tools/r4_extract_probe.py:331"),
    ("scan_gf2", "reverie_tpu_torch/csrc/scan_gf2.cu",
     "reverie_tpu/backend/tpu_scan.py:247 _scan_trace_fast2 (lax.scan body; XLA, no Pallas)"),
    ("scan_z64", "reverie_tpu_torch/csrc/scan_z64.cu",
     "reverie_tpu/backend/tpu_scan.py:374 _scan_trace, its z64 and B2A half :430-804 "
     "(lax.scan body; XLA, no Pallas)"),
)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test "
              "runs on a CUDA card only", file=sys.stderr)
        return 2
    if sys.argv[1:2] == [MESH_CHILD]:
        return mesh_child(*sys.argv[2:])
    from reverie_tpu_torch import _build
    from reverie_tpu_torch.crypto import native
    from reverie_tpu_torch.device import default_device
    from reverie_tpu_torch.tools._timing import card, max_sm_clock_mhz

    dev = default_device()
    started = time.perf_counter()
    gc.callbacks.append(gc_clock)
    name = torch.cuda.get_device_name(0)
    smi, clock = card(), max_sm_clock_mhz()
    log("card", f"{name} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| count {torch.cuda.device_count()}")
    log("card", f"nvidia-smi: {smi} | clocks.max.sm {clock:.0f} MHz")

    t = time.perf_counter()
    out = _build.build(ptxas_verbose=True)
    _build.kernels()
    log("build", f"nvcc {' '.join(_build.NVCC_FLAGS)} "
        f"{[s.name for s in _build.sources()]} seconds={time.perf_counter() - t:.3f}")
    ptxas = _build.ptxas_summary(out)
    for row in ptxas:
        log("build", "ptxas " + json.dumps(row))
    t = time.perf_counter()
    native.build()
    native.get_lib()
    log("build", f"gcc {' '.join(native.CFLAGS)} {[s.name for s in native.sources()]} "
        f"seconds={time.perf_counter() - t:.3f}")

    from reverie_tpu_torch.circuit.builders import mul_bench_circuit, z64_mul_bench_circuit
    from reverie_tpu_torch.circuit.compile import compile_program
    from reverie_tpu_torch.parity import sha256_bench

    rng = np.random.RandomState(2026)
    checks = {"aes_tape_gf2": check_tape(dev, rng, "aes_tape_gf2", M2, clock),
              "aes_tape_z64": check_tape(dev, rng, "aes_tape_z64", MZ, clock),
              "blake3_chunk_cvs": check_blake3(dev, rng, T_STREAM, clock),
              "aes_ctr_planes": check_planes(dev, clock),
              "copy": check_copy(dev, clock),
              "u32_to_u8_rows": check_u8emit(dev, clock),
              "pack_shift": check_pack_shift(dev, clock)}
    main = main_path(dev, "main", lambda: mul_bench_circuit(N_MUL), "gf2", rng)
    gf2 = main.pop("launches")
    parity(dev, "gf2_50k")
    z64_main = main_path(dev, "z64", lambda: z64_mul_bench_circuit(N_MUL_Z64), "z64", rng)
    z64 = z64_main["launches"]
    parity(dev, "z64_2k")
    checks["blake3_tail"] = check_blake3_tail(dev, rng, clock, {
        "gf2_1M": main["cc"], "z64_50k": z64_main["cc"],
        "sha256": compile_program(sha256_bench()[0])})
    del z64_main
    checks["scan_gf2"], sha = sha256_phase(dev, rng, clock, ptxas)
    checks["scan_z64"], zw = z64_wave_phase(dev, rng, clock, ptxas)
    stream = streaming_phase(dev, rng, checks)
    batch = batch_phase(dev, rng, checks)
    tools = probes(dev)
    cli = cli_phase(rng)
    mesh = mesh_phase(dev, rng, checks, main)
    past = past_card_phase()
    past_cli = past_cli_phase()

    kernels = []
    for kname, source, replaces in KERNELS:
        c = checks[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(run.get(kname, 0) for run in (gf2, z64, sha, zw, stream, batch,
                                                          tools, cli, mesh, past, past_cli)),
            "max_abs_err": c["max_abs_err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"]})
        if kernels[-1]["launches"] < 1:
            raise AssertionError(f"{kname} was not launched on its path")
    log("done", f"seconds={time.perf_counter() - started:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


def run() -> int:
    """main() with the run's compile cache in a temporary directory (every
    CLI process inherits it), removed at the end."""
    if sys.argv[1:2] == [MESH_CHILD] or not torch.cuda.is_available():
        return main()
    cache = tempfile.mkdtemp(prefix="reverie_compile_cache_")
    os.environ["REVERIE_COMPILE_CACHE"] = cache
    try:
        return main()
    finally:
        shutil.rmtree(cache, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(run())
