"""Proving a circuit larger than the card: make_system with no budget, in
this process, on a bench circuit whose device_footprint passes the card's
free memory.

    python -m reverie_tpu_torch.tools.past_card gf2 [ANDs] [cut ANDs]
    python -m reverie_tpu_torch.tools.past_card z64 [MULs] [cut MULs]

    python -m reverie_tpu_torch.tools.past_card cli [ANDs] [cut ANDs]

Defaults: mul_bench_circuit(48,000,000) with a cut of 4,000,000 ANDs, and
z64_mul_bench_circuit(1,200,000) with a cut of 100,000 MULs.  Run it in a
fresh process, so that the free device memory and the host's peak RSS are
the case's own.  For the case: the setup split (the builder, make_system),
the system make_system returned (it must be a StreamingKKW), its segments
and the most ops a segment took, the budget it planned for; a cold and a
warm prove (walls, last_timings; the two proofs equal), verify (True), a
flipped byte in an online opening (False), the peak max_memory_allocated
over all of it (at most the budget), the host's peak RSS, and the launches
of K1, K3, K4 and the tail (csrc/blake3_tail.cu) in those runs, counted
from 0.  Then the tape kernel of the case's domain (K1 or K4) at the last
segment's window (the largest start_block) and K3 at its stream's chunk
base, each against its plain version on the same inputs; the cut under a
budget scaled by cut / ops (so about as many segments), its proof equal to
TorchKKW's with the same seeds; and last, the whole circuit compiled once to read its device_footprint,
which must pass the budget.  Prints one JSON line, then the card's name
and power limit; exits 1 if any check fails.

The `cli` case proves the GF(2) circuit from files through the command
line (`python -m reverie_tpu_torch.cli`, make_system with no budget):
mul_bench_circuit(48,000,000) written as a bincode file by the C writer
(bincode.dump_program_arrays; on a 1,000,000-AND cut its SHA-256 held to
dumps_program of mul_bench_circuit's list), then in fresh processes,
each the CLI's main with its stages timed (cli_split: import torch,
load_program with the witness, make_system, prove or verify, and the
rest, the proof's write or read): prove; verify (Ok(()), rc 0); and
verify of a copy with
one flipped byte in the first preprocessing opening's comm_online (rc 1).
For each process its system and segments, the budget make_system took,
the peak max_memory_allocated, the host's peak RSS (at most 16 GB) and
the launches of K1, K3, K4 and the tail; K1, K3 and the tail must
launch.  Last, on a 4,000,000-AND cut under the budget scaled by the
cut, the CLI's proof file equal to make_system's StreamingKKW's from
mul_bench_circuit's list in this process, with the same os.urandom.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import hashlib
import io
import json
import mmap
import os
import resource
import shutil
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from reverie_tpu_torch import StreamingKKW, TorchKKW, device_budget, make_system
from reverie_tpu_torch.backend import host
from reverie_tpu_torch.backend.streaming import Z64_REFILL_BLOCKS, Z64_REFILL_WORDS
from reverie_tpu_torch.circuit import dumps_program, format_witness_bits
from reverie_tpu_torch.circuit.bincode import dump_program_arrays
from reverie_tpu_torch.circuit.builders import mul_bench_circuit, z64_mul_bench_circuit
from reverie_tpu_torch.circuit.compile import compile_program
from reverie_tpu_torch.circuit.compile_native import OpArrays
from reverie_tpu_torch.params import KEY_SIZE, PLAYERS
from reverie_tpu_torch.crypto.kernels import aes_tape, aes_tape_z64, blake3 as b3, blake3_tail
from reverie_tpu_torch.proof import Proof
from reverie_tpu_torch.tools._timing import card

CASES = {"gf2": (mul_bench_circuit, 48_000_000, 4_000_000),
         "z64": (z64_mul_bench_circuit, 1_200_000, 100_000)}
#: the kernels of the streamed paths, by their launch counters
KERNELS = {"aes_tape_gf2": aes_tape, "aes_tape_z64": aes_tape_z64, "blake3_chunk_cvs": b3,
           "blake3_tail": blake3_tail}
#: the cli case: its ANDs, the cut held to StreamingKKW, the cut whose file
#: is held to dumps_program's, the seed of os.urandom in the cut's proofs
CLI_CASE = (48_000_000, 4_000_000)
WRITER_CUT = 1_000_000
CLI_SEED = 15
#: the longest a CLI process of the cli case may take
CLI_TIMEOUT_S = 900
#: the host memory a CLI process may peak at (PERF.md section 2)
HOST_RSS_LIMIT = 16 * 10**9
ROOT = Path(__file__).resolve().parents[2]
#: a fresh CLI process of the cli case: import torch timed, then the CLI's
#: main through cli_split; exits with the CLI's code
CLI_CHILD = """
import json, sys, time
t = time.perf_counter()
import torch
t = time.perf_counter() - t
from reverie_tpu_torch.tools.past_card import cli_split
res = cli_split(sys.argv[1:], t)
print(json.dumps(res), flush=True)
sys.exit(res["rc"])
"""


def wall(fn, dev):
    """(fn(), its seconds between two synchronizations of the card)."""
    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t


def free_cache() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def phases(timings: dict) -> dict:
    """{phase: [host ms, device ms]} of a last_timings report."""
    return {k: [v["host_ms"], v["device_ms"]] for k, v in timings.items()}


def flipped(proof: Proof, domain: str) -> Proof:
    """The proof with one flipped bit in the first recon byte of its first
    `domain` online opening."""
    bad = copy.deepcopy(proof)
    o = getattr(bad, domain).online[0]
    o.recons = bytes([o.recons[0] ^ 1]) + o.recons[1:]
    return Proof.from_bytes(bad.to_bytes())


def held(name: str, got: torch.Tensor, want: torch.Tensor, **where) -> dict:
    """The kernel's output against the plain version's: equal, and the
    largest absolute difference of an element (taken a block of rows at a
    time: the tapes pass 2**31 elements)."""
    same = got.shape == want.shape and bool(torch.equal(got, want))
    err = 0
    if not same and got.shape == want.shape:
        for lo in range(0, got.shape[0], 1 << 16):
            d = got[lo : lo + (1 << 16)].to(torch.int64) - want[lo : lo + (1 << 16)].to(
                torch.int64)
            err = max(err, int(d.abs().max()))
    elif not same:
        err = -1
    return {"kernel": name, **where, "shape": list(got.shape), "max_abs_err": err, "equal": same}


def kernel_checks(dev, sk: StreamingKKW, domain: str, rng) -> list:
    """The case's tape kernel at the last segment's window and K3 at its
    stream's chunk base, each against its plain version (R = 256)."""
    seg = sk.segments[-1]
    rk = aes_tape.round_keys(rng.randint(0, 256, (256, 8, 16), dtype=np.uint8), dev)
    free_cache()
    out = []
    if domain == "gf2":
        b0 = seg.tape0 // aes_tape.BATCH
        m = seg.tape0 - b0 * aes_tape.BATCH + seg.cc.m2
        out.append(held("aes_tape_gf2", aes_tape.aes_ctr_tape_gf2(rk, m, None, b0),
                        aes_tape.aes_ctr_tape_gf2_ref(rk, m, None, b0), start_block=b0, m=m))
        rows, base = seg.cc.onl2, seg.onl0
    else:
        bz = seg.tapez0 // Z64_REFILL_WORDS
        m = seg.tapez0 - bz * Z64_REFILL_WORDS + seg.cc.mz
        start = bz * Z64_REFILL_BLOCKS
        out.append(held("aes_tape_z64", aes_tape_z64.aes_ctr_tape_z64(rk, m, None, start),
                        aes_tape_z64.aes_ctr_tape_z64_ref(rk, m, None, start),
                        start_block=start, m=m))
        rows, base = seg.cc.onlz, seg.onlz0
    n, chunk_base = rows // b3.CHUNK_LEN, base // b3.CHUNK_LEN
    buf = torch.randint(0, 256, (n * b3.CHUNK_LEN, 256), dtype=torch.uint8, device=dev)
    out.append(held("blake3_chunk_cvs", b3.chunk_cvs(buf, n, chunk_base),
                    b3.chunk_cvs_ref(buf, n, chunk_base), chunk_base=chunk_base, n_chunks=n))
    return out


def run_case(domain: str, n: int, cut: int, seed: int = 14) -> dict:
    """The case of the module's docstring, on the CUDA device."""
    dev = torch.device("cuda")
    build, _, _ = CASES[domain]
    free_cache()
    res = {"case": domain, "ops": n, "free_bytes": torch.cuda.mem_get_info(dev)[0]}
    (prog, w2, wz), res["build_s"] = wall(lambda: build(n), dev)
    budget = device_budget(dev)
    sk, res["make_system_s"] = wall(lambda: make_system(prog, device=dev), dev)
    res.update(device_budget=budget, system=type(sk).__name__)
    if not isinstance(sk, StreamingKKW):
        raise AssertionError(f"{domain}: make_system gave {type(sk).__name__}, not StreamingKKW")
    fps = [host.device_footprint(s.cc, 256) for s in sk.segments]
    res.update(segments=len(sk.segments), seg_ops=sk.seg_ops, segment_footprint_max=max(fps),
               segment_footprint_over_budget=max(fps) / budget)

    seeds = np.random.RandomState(seed).randint(0, 256, (256, 16), dtype=np.uint8)
    for counter in KERNELS.values():
        counter.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats(dev)
    proof, res["cold_prove_s"] = wall(lambda: sk.prove(w2, wz, seeds=seeds), dev)
    res["cold_prove_phases"] = phases(sk.last_timings)
    again, res["warm_prove_s"] = wall(lambda: sk.prove(w2, wz, seeds=seeds), dev)
    res["warm_prove_phases"] = phases(sk.last_timings)
    res["proofs_equal"] = again.to_bytes() == proof.to_bytes()
    del again
    res["verify"], res["verify_s"] = wall(lambda: sk.verify(proof), dev)
    res["verify_phases"] = phases(sk.last_timings)
    res["flipped_verify"] = sk.verify(flipped(proof, domain))
    res["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    res["peak_over_budget"] = res["peak_bytes"] / budget
    res["launches"] = {name: mod.LAUNCHES for name, mod in KERNELS.items()}
    res["host_peak_rss_bytes"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    res["proof_bytes"] = len(proof.to_bytes())
    del proof

    rng = np.random.RandomState(seed)
    res["kernel_checks"] = kernel_checks(dev, sk, domain, rng)
    del sk
    free_cache()

    cprog, cw2, cwz = build(cut)
    cbudget = int(budget * cut / n)
    csk = make_system(cprog, device=dev, hbm_budget_bytes=cbudget)
    got = csk.prove(cw2, cwz, seeds=seeds).to_bytes()
    cseg = len(csk.segments) if isinstance(csk, StreamingKKW) else 0
    del csk
    free_cache()
    want = TorchKKW(cprog, device=dev).prove(cw2, cwz, seeds=seeds).to_bytes()
    res["cut"] = {"ops": cut, "budget": cbudget, "segments": cseg, "equal_to_torchkkw": got == want}
    del cprog, got, want
    free_cache()

    (cc, res["whole_compile_s"]) = wall(lambda: compile_program(prog), dev)
    res["device_footprint"] = host.device_footprint(cc, 256)
    res["footprint_over_budget"] = res["device_footprint"] / budget
    return res


@contextlib.contextmanager
def fixed_urandom(seed: Optional[int], n: int = 256 * KEY_SIZE):
    """os.urandom of n bytes (one proof's rep seeds) gives the first n bytes
    of RandomState(seed) while it is open; None leaves it as it is."""
    real = os.urandom
    if seed is not None:
        os.urandom = lambda k: np.random.RandomState(seed).bytes(k) if k == n else real(k)
    try:
        yield
    finally:
        os.urandom = real


def cli_split(argv, import_torch_s: Optional[float] = None,
              urandom_seed: Optional[int] = None) -> dict:
    """reverie_tpu_torch.cli's main(argv) in this process on the CUDA card,
    its stages timed (s): load_program (with the witness), make_system (the
    system the CLI builds), prove or verify, and the rest (prove: the
    proof's bytes and their write; verify: the proof's read), with
    import_torch_s where the caller timed it; the CLI's code and output,
    the system, its segments, the budget make_system took, the peak
    max_memory_allocated, the host's peak RSS and the kernels' launches."""
    import reverie_tpu_torch as pkg
    from reverie_tpu_torch import cli

    dev = torch.device("cuda")
    split, seen = {}, {}

    def stage(name, fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                if torch.cuda.is_initialized():
                    torch.cuda.synchronize(dev)
                split[name] = split.get(name, 0.0) + time.perf_counter() - t
        return run

    def system(*args, **kwargs):
        s = saved["_backend_system"](*args, **kwargs)
        seen["system"] = s
        s.prove, s.verify = stage("prove", s.prove), stage("verify", s.verify)
        return s

    def budget(*args, **kwargs):
        seen["budget"] = saved_budget(*args, **kwargs)
        return seen["budget"]

    saved = {n: getattr(cli, n) for n in ("_load_program", "_load_witness", "_backend_system")}
    saved_budget = pkg.device_budget
    cli._load_program = stage("load_program", saved["_load_program"])
    cli._load_witness = stage("load_program", saved["_load_witness"])
    cli._backend_system = stage("make_system", system)
    pkg.device_budget = budget
    if torch.cuda.is_initialized():
        torch.cuda.reset_peak_memory_stats(dev)
    before = {name: mod.LAUNCHES for name, mod in KERNELS.items()}
    out = io.StringIO()
    try:
        with fixed_urandom(urandom_seed), contextlib.redirect_stdout(out):
            t = time.perf_counter()
            rc = cli.main([str(a) for a in argv])
            total = time.perf_counter() - t
    finally:
        for name, fn in saved.items():
            setattr(cli, name, fn)
        pkg.device_budget = saved_budget
    rest = "write" if "prove" in split else "read"
    split[rest] = total - sum(split.values())
    if import_torch_s is not None:
        split = {"import_torch": import_torch_s, **split}
    sk = seen.get("system")
    return {"argv": [str(a) for a in argv], "rc": rc, "out": out.getvalue().splitlines(),
            "split_s": {**split, "total": total + (import_torch_s or 0.0)},
            "system": type(sk).__name__, "segments": len(getattr(sk, "segments", ())),
            "device_budget": seen.get("budget"),
            "peak_bytes": torch.cuda.max_memory_allocated(dev),
            "host_peak_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
            "launches": {name: mod.LAUNCHES - before[name] for name, mod in KERNELS.items()}}


def cli_process(argv) -> dict:
    """cli_split(argv) in a fresh process (CLI_CHILD), with its wall and the
    last line of its errors."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])]))
    t = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", CLI_CHILD, *map(str, argv)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
    lines = [ln for ln in run.stdout.splitlines() if ln.startswith("{")]
    if not lines:
        raise AssertionError(f"cli {argv[1]}: rc {run.returncode}, no result\n"
                             f"{run.stdout[-4000:]}\n{run.stderr[-4000:]}")
    res = json.loads(lines[-1])
    res.update(process_rc=run.returncode, process_wall_s=time.perf_counter() - t,
               stderr_last=(run.stderr.strip().splitlines() or [""])[-1])
    return res


def comm_online_offset(blob) -> int:
    """The offset of the first byte of the first GF(2) preprocessing
    opening's comm_online in a proof's bytes (proof.container's layout)."""
    pos = 32
    (n,) = struct.unpack_from("<Q", blob, pos)
    pos += 8
    for _ in range(n):
        pos += 1 + KEY_SIZE * PLAYERS
        for _ in range(3):
            (k,) = struct.unpack_from("<Q", blob, pos)
            pos += 8 + k
    return pos + 8 + KEY_SIZE


def sha256_of(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def write_program(path: Path, n: int) -> tuple:
    """mul_bench_circuit(n) written to path by the C writer: (its witness
    bits, mul_bench_circuit's s, the writer's s)."""
    t = time.perf_counter()
    prog, w2, _ = mul_bench_circuit(n)
    built = time.perf_counter() - t
    ops = OpArrays.from_program(prog)
    del prog
    t = time.perf_counter()
    with open(path, "wb") as f:
        dump_program_arrays(ops, f)
    return w2, built, time.perf_counter() - t


def run_cli_case(n: int, cut: int) -> dict:
    """The cli case of the module's docstring, on the CUDA card."""
    from reverie_tpu_torch import _build

    _build.kernels()  # built here, so that no CLI process's split holds the nvcc build
    res = {"case": "cli", "ops": n}
    with tempfile.TemporaryDirectory(prefix="reverie_past_cli_") as tmp:
        d = Path(tmp)
        write_program(d / "cut.bin", WRITER_CUT)
        want = hashlib.sha256(dumps_program(mul_bench_circuit(WRITER_CUT)[0])).hexdigest()
        res["writer_cut"] = {"ops": WRITER_CUT, "sha256": sha256_of(d / "cut.bin"),
                             "equal_to_dumps_program": sha256_of(d / "cut.bin") == want}
        prog, wit, proof, bad = d / "prog.bin", d / "wit.txt", d / "proof.bin", d / "bad.bin"
        w2, res["build_s"], res["write_file_s"] = write_program(prog, n)
        wit.write_bytes(format_witness_bits(w2))
        res["file_bytes"] = prog.stat().st_size
        gc.collect()
        res["prove"] = cli_process(["--operation", "prove", "--program-path", prog,
                                    "--witness-path", wit, "--proof-path", proof])
        verify = ["--operation", "verify", "--program-path", prog, "--proof-path"]
        res["verify"] = cli_process([*verify, proof])
        res["proof_bytes"] = proof.stat().st_size
        shutil.copyfile(proof, bad)
        with open(bad, "r+b") as f, mmap.mmap(f.fileno(), 0) as mm:
            at = comm_online_offset(mm)
            mm[at] ^= 1
        res["tampered_at"] = at
        res["tampered"] = cli_process([*verify, bad])
        for f in (bad, prog):
            f.unlink()

        dev = torch.device("cuda")
        budget = int(res["prove"]["device_budget"] * cut / n)
        cw2 = write_program(prog, cut)[0]
        os.environ["REVERIE_HBM_BUDGET"] = str(budget)
        try:
            got = cli_split(["--operation", "prove", "--program-path", prog, "--witness-path",
                             wit, "--proof-path", proof], urandom_seed=CLI_SEED)
        finally:
            del os.environ["REVERIE_HBM_BUDGET"]
        free_cache()
        cprog = mul_bench_circuit(cut)[0]
        sk = make_system(cprog, device=dev, hbm_budget_bytes=budget)
        with fixed_urandom(CLI_SEED):
            want = sk.prove(cw2, [0]).to_bytes()
        res["cut"] = {"ops": cut, "budget": budget, "cli_system": got["system"],
                      "cli_segments": got["segments"], "system": type(sk).__name__,
                      "segments": len(getattr(sk, "segments", ())),
                      "equal_to_streamingkkw": proof.read_bytes() == want}
    return res


def cli_failures(res: dict) -> list:
    """What the cli case got wrong."""
    checks = {"the C writer's 1M-AND file equals dumps_program's":
              res["writer_cut"]["equal_to_dumps_program"],
              "prove wrote the proof": res["prove"]["rc"] == 0 and any(
                  ln.startswith("proof written") for ln in res["prove"]["out"]),
              "verify printed Ok(())": res["verify"]["rc"] == 0 and res["verify"]["out"][-1:]
              == ["Ok(())"],
              "the tampered proof was refused": res["tampered"]["rc"] == 1
              and res["tampered"]["process_rc"] == 1
              and res["tampered"]["stderr_last"] == "Unverifiable Proof",
              "the cut equals StreamingKKW's proof": res["cut"]["equal_to_streamingkkw"],
              "the cut streams": res["cut"]["system"] == res["cut"]["cli_system"]
              == "StreamingKKW" and res["cut"]["segments"] > 1}
    for leg in ("prove", "verify", "tampered"):
        r = res[leg]
        checks[f"{leg}: make_system gave StreamingKKW"] = r["system"] == "StreamingKKW"
        checks[f"{leg}: peak within the budget"] = r["peak_bytes"] <= r["device_budget"]
        checks[f"{leg}: host peak RSS within 16 GB"] = r["host_peak_rss_bytes"] <= HOST_RSS_LIMIT
        checks[f"{leg}: K1, K3 and the tail launched"] = all(
            r["launches"][k] > 0 for k in ("aes_tape_gf2", "blake3_chunk_cvs", "blake3_tail"))
    return [name for name, ok in checks.items() if not ok]


def failures(res: dict) -> list:
    """What the case got wrong."""
    bad = []
    checks = {
        "device_footprint passes the budget": res["device_footprint"] > res["device_budget"],
        "make_system gave StreamingKKW": res["system"] == "StreamingKKW",
        "the cold and warm proofs are equal": res["proofs_equal"],
        "verify is True": res["verify"] is True,
        "a flipped byte verifies False": res["flipped_verify"] is False,
        "peak within the budget": res["peak_bytes"] <= res["device_budget"],
        "every kernel held to its plain version": all(c["equal"] and c["max_abs_err"] == 0
                                                      for c in res["kernel_checks"]),
        "the cut equals TorchKKW": res["cut"]["equal_to_torchkkw"],
        "the cut streams": res["cut"]["segments"] > 1,
    }
    kernels = ("aes_tape_gf2" if res["case"] == "gf2" else "aes_tape_z64", "blake3_chunk_cvs",
               "blake3_tail")
    checks[f"{' and '.join(kernels)} launched"] = all(res["launches"][k] > 0 for k in kernels)
    bad += [name for name, ok in checks.items() if not ok]
    return bad


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("past_card: needs a CUDA card", file=sys.stderr)
        return 2
    domain = argv[1] if len(argv) > 1 else "gf2"
    n, cut = CLI_CASE if domain == "cli" else CASES[domain][1:]
    n = int(argv[2]) if len(argv) > 2 else n
    cut = int(argv[3]) if len(argv) > 3 else cut
    if domain == "cli":
        res = run_cli_case(n, cut)
        res["failures"] = cli_failures(res)
    else:
        res = run_case(domain, n, cut)
        res["failures"] = failures(res)
    print(json.dumps(res), flush=True)
    print(card(), flush=True)
    return 1 if res["failures"] else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
