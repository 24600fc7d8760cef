"""Smoke test of reverie_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero and
prints no result line:

  1. the card: its name, and its name and power limit from nvidia-smi;
  2. the build of the CUDA kernels (csrc/*.cu, nvcc for sm_90a), timed;
  3. each kernel against its plain PyTorch version on the card at the main
     paths' shapes, byte for byte, with both times from CUDA events (the
     GF(2) tape, the z64 tape at mz = 100,002 for R = 256, then R = 40 with
     random omits and R = 216, the BLAKE3 chunks); then the per-column hash
     on the card against the host C blake3;
  4. the GF(2) main path: TorchKKW(mul_bench_circuit(1_000_000)).prove,
     then .verify (True), and a proof with one flipped byte in a GF(2)
     online opening (False), with the kernels' launch counts of that run;
  5. byte parity at 50,000 AND gates with reverie_tpu's NumPy golden prover;
  6. the Z64 main path: TorchKKW(z64_mul_bench_circuit(50_000)), the same
     legs, a flipped byte in a z64 online opening (False), and the z64 tape
     kernel launched in the prove, the online and the preprocessing verify;
  7. Z64 / B2A parity: tests/golden/b2a_proof.bin reproduced from
     b2a_seeds.bin, and 2,000 Z64 MULs byte-equal to the NumPy golden;
  8. one JSON line of kernels, the nvidia-smi line, and the last line
     {"ok": true, "device": {...}}.

Imports nothing of JAX.  Needs the CUDA toolkit (nvcc) and one card.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

#: the GF(2) main path's sizes (bench config 4: 1M AND gates, 256 reps)
N_MUL = 1_000_000
N_PARITY = 50_000
M2 = 2 * N_MUL + 2  # tape slots of mul_bench_circuit(N_MUL)
T_STREAM = N_MUL + 2  # onl2 rows of mul_bench_circuit(N_MUL)
REPS = (256, 40, 216)  # prove, online verify, preprocessing verify
#: the Z64 main path's sizes (bench.py's z64 cell, BASELINE config 3)
N_MUL_Z64 = 50_000
N_PARITY_Z64 = 2_000
MZ = 2 * N_MUL_Z64 + 2  # z64 tape slots of z64_mul_bench_circuit(N_MUL_Z64)
GOLDEN = Path(__file__).resolve().parent / "tests" / "golden"


def log(tag: str, msg: str) -> None:
    print(f"[{tag}] {msg}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean stream time of fn() over `reps` runs after one warm-up, from
    CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest absolute difference of two integer tensors, over their bytes
    for int64 (a difference of two int64 can overflow)."""
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.dtype == torch.int64:
        a, b = a.view(torch.uint8), b.view(torch.uint8)
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def check_aes(dev, rng, m2: int) -> dict:
    from reverie_tpu_torch.crypto.kernels import aes_tape

    res = {"max_abs_err": 0}
    for R in REPS:
        keys = rng.randint(0, 256, (R, 8, 16), dtype=np.uint8)
        rk = aes_tape.round_keys(keys, dev)
        omit = None
        if R == 40:  # the online verifier's shape: one omitted player per rep
            omit = torch.from_numpy(rng.randint(0, 8, R).astype(np.uint8)).to(dev)
        got = aes_tape.aes_ctr_tape_gf2(rk, m2, omit)
        ref = aes_tape.aes_ctr_tape_gf2_ref(rk, m2, omit)
        err = max_abs_err(got, ref)
        res["max_abs_err"] = max(res["max_abs_err"], err)
        line = f"aes_tape_gf2 m2={m2} R={R} omit={'random' if omit is not None else 'none'} max_abs_err={err}"
        if R == REPS[0]:
            res["ms"] = cuda_ms(lambda: aes_tape.aes_ctr_tape_gf2(rk, m2, omit), 5)
            res["plain_ms"] = cuda_ms(lambda: aes_tape.aes_ctr_tape_gf2_ref(rk, m2, omit), 1)
            line += f" kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f}"
        log("kernel", line)
        if err:
            raise AssertionError(f"aes_tape_gf2 disagrees with its plain version at R={R}")
        del got, ref
    return res


def check_aes_z64(dev, rng, mz: int) -> dict:
    from reverie_tpu_torch.crypto.kernels import aes_tape, aes_tape_z64

    res = {"max_abs_err": 0}
    for R in REPS:
        keys = rng.randint(0, 256, (R, 8, 16), dtype=np.uint8)
        rk = aes_tape.round_keys(keys, dev)
        omit = None
        if R == 40:  # the online verifier's shape, with one rep omitting no player
            om = rng.randint(0, 9, R).astype(np.uint8)
            om[0] = 8
            omit = torch.from_numpy(om).to(dev)
        got = aes_tape_z64.aes_ctr_tape_z64(rk, mz, omit)
        ref = aes_tape_z64.aes_ctr_tape_z64_ref(rk, mz, omit)
        err = max_abs_err(got, ref)
        res["max_abs_err"] = max(res["max_abs_err"], err)
        line = (f"aes_tape_z64 mz={mz} R={R} omit={'random' if omit is not None else 'none'} "
                f"byte_equal={torch.equal(got, ref)} max_abs_err={err}")
        if R == REPS[0]:
            res["ms"] = cuda_ms(lambda: aes_tape_z64.aes_ctr_tape_z64(rk, mz, omit), 5)
            res["plain_ms"] = cuda_ms(lambda: aes_tape_z64.aes_ctr_tape_z64_ref(rk, mz, omit), 1)
            line += f" kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f}"
        log("kernel", line)
        if err or not torch.equal(got, ref):
            raise AssertionError(f"aes_tape_z64 disagrees with its plain version at R={R}")
        del got, ref
    return res


def check_blake3(dev, rng, T: int) -> dict:
    from reverie_tpu.crypto import blake3_many
    from reverie_tpu_torch.crypto.kernels import blake3 as b3

    R = REPS[0]
    n = T // 1024
    buf = torch.from_numpy(rng.randint(0, 256, (T, R), dtype=np.uint8)).to(dev)
    got = b3.chunk_cvs(buf, n, 0)
    ref = b3.chunk_cvs_ref(buf, n, 0)
    err = max_abs_err(got, ref)
    res = {"max_abs_err": err,
           "ms": cuda_ms(lambda: b3.chunk_cvs(buf, n, 0), 5),
           "plain_ms": cuda_ms(lambda: b3.chunk_cvs_ref(buf, n, 0), 1)}
    log("kernel", f"blake3_chunk_cvs T={T} R={R} n={n} max_abs_err={err} "
        f"kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f}")
    if err:
        raise AssertionError("blake3_chunk_cvs disagrees with its plain version")
    del got, ref
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


def reset_launches() -> None:
    from reverie_tpu_torch.crypto.kernels import aes_tape, aes_tape_z64, blake3 as b3

    aes_tape.LAUNCHES = aes_tape_z64.LAUNCHES = b3.LAUNCHES = 0


def main_path(dev, tag: str, make, domain: str, rng) -> dict:
    """Prove and verify one circuit, cold then warm, through TorchKKW; a
    proof with one flipped recon byte in a `domain` online opening must
    not verify.  Returns the kernels' launch counts of the run."""
    from reverie_tpu.proof import Proof
    from reverie_tpu_torch import TorchKKW
    from reverie_tpu_torch.backend.host import launch_counts

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
        "prove": (prove_t["tape_" + domain], prove_t["hash"]),
        "verify_online": (verify_t["onl_tape"], verify_t["onl_hash"]),
        "verify_preprocessing": (verify_t["pre_tape"], verify_t["pre_hash"]),
    }
    for leg, (tp, hsh) in per_leg.items():
        a, b = tp["launches"][tape], hsh["launches"]["blake3_chunk_cvs"]
        log(tag, f"{leg} {tape}_launches={a} blake3_chunk_cvs_launches={b}")
        if a < 1 or b < 1:
            raise AssertionError(f"{tag} {leg} did not launch both kernels")

    bad = copy.deepcopy(proof)
    o = getattr(bad, domain).online[0]
    o.recons = bytes([o.recons[0] ^ 1]) + o.recons[1:]
    tampered = kkw.verify(Proof.from_bytes(bad.to_bytes()))
    log(tag, f"tampered {domain} online opening verify={tampered}")
    if tampered is not False:
        raise AssertionError(f"{tag}: a tampered proof verified")
    return launches


def parity(dev, n_mul: int, rng) -> None:
    from reverie_tpu.circuit.builders import mul_bench_circuit
    from reverie_tpu.proof import prove as golden_prove
    from reverie_tpu_torch import TorchKKW

    prog, w2, wz = mul_bench_circuit(n_mul)
    seeds = rng.randint(0, 256, (256, 16), dtype=np.uint8)
    t = time.perf_counter()
    got = TorchKKW(prog, device=dev).prove(w2, wz, seeds=seeds).to_bytes()
    t_port = time.perf_counter() - t
    t = time.perf_counter()
    want = golden_prove(prog, w2, wz, seeds=seeds.reshape(32, 8, 16)).to_bytes()
    t_gold = time.perf_counter() - t
    log("parity", f"mul_bench_circuit({n_mul}) proof_bytes={len(got)} "
        f"equal_to_numpy_golden={got == want} port_s={t_port:.3f} golden_s={t_gold:.3f}")
    if got != want:
        raise AssertionError("proof bytes differ from the NumPy golden")


def z64_parity(dev, n_mul: int, rng) -> None:
    """The committed B2A golden blob, and n_mul Z64 MULs against the NumPy
    golden prover, byte for byte."""
    from reverie_tpu.circuit import load_program
    from reverie_tpu.circuit.builders import mixed_b2a_circuit, z64_mul_bench_circuit
    from reverie_tpu.proof import Proof
    from reverie_tpu.proof import prove as golden_prove
    from reverie_tpu_torch import TorchKKW

    prog = load_program((GOLDEN / "b2a_program.bin").read_bytes())
    seeds = np.frombuffer((GOLDEN / "b2a_seeds.bin").read_bytes(), np.uint8).reshape(256, 16)
    blob = (GOLDEN / "b2a_proof.bin").read_bytes()
    _, w2, wz = mixed_b2a_circuit()
    kkw = TorchKKW(prog, device=dev)
    t = time.perf_counter()
    got = kkw.prove(w2, wz, seeds=seeds).to_bytes()
    ok = kkw.verify(Proof.from_bytes(blob))
    log("parity", f"golden b2a_proof.bin depth={kkw.cc.depth} proof_bytes={len(got)} "
        f"equal={got == blob} verify={ok} port_s={time.perf_counter() - t:.3f}")
    if got != blob or ok is not True:
        raise AssertionError("the golden B2A proof was not reproduced")

    prog, w2, wz = z64_mul_bench_circuit(n_mul)
    seeds = rng.randint(0, 256, (256, 16), dtype=np.uint8)
    t = time.perf_counter()
    got = TorchKKW(prog, device=dev).prove(w2, wz, seeds=seeds).to_bytes()
    t_port = time.perf_counter() - t
    t = time.perf_counter()
    want = golden_prove(prog, w2, wz, seeds=seeds.reshape(32, 8, 16)).to_bytes()
    t_gold = time.perf_counter() - t
    log("parity", f"z64_mul_bench_circuit({n_mul}) proof_bytes={len(got)} "
        f"equal_to_numpy_golden={got == want} port_s={t_port:.3f} golden_s={t_gold:.3f}")
    if got != want:
        raise AssertionError("z64 proof bytes differ from the NumPy golden")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test "
              "runs on a CUDA card only", file=sys.stderr)
        return 2
    from reverie_tpu_torch import _build
    from reverie_tpu_torch.device import default_device

    dev = default_device()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log("card", f"{name} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| count {torch.cuda.device_count()}")
    log("card", f"nvidia-smi: {smi}")

    t = time.perf_counter()
    out = _build.build(ptxas_verbose=True)
    _build.kernels()
    log("build", f"nvcc {' '.join(_build.NVCC_FLAGS)} "
        f"{[s.name for s in _build.sources()]} seconds={time.perf_counter() - t:.3f}")
    for line in out.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("build", line.strip())

    from reverie_tpu.circuit.builders import mul_bench_circuit, z64_mul_bench_circuit

    rng = np.random.RandomState(2026)
    aes = check_aes(dev, rng, M2)
    aesz = check_aes_z64(dev, rng, MZ)
    b3 = check_blake3(dev, rng, T_STREAM)
    gf2 = main_path(dev, "main", lambda: mul_bench_circuit(N_MUL), "gf2", rng)
    parity(dev, N_PARITY, rng)
    z64 = main_path(dev, "z64", lambda: z64_mul_bench_circuit(N_MUL_Z64), "z64", rng)
    z64_parity(dev, N_PARITY_Z64, rng)

    kernels = [
        {"name": "aes_tape_gf2", "route": "cuda",
         "source": "reverie_tpu_torch/csrc/aes_tape.cu",
         "replaces": "reverie_tpu/crypto/kernels/aes_pallas.py:128",
         "launches": gf2["aes_tape_gf2"] + z64["aes_tape_gf2"],
         "max_abs_err": aes["max_abs_err"], "ms": aes["ms"], "plain_ms": aes["plain_ms"]},
        {"name": "aes_tape_z64", "route": "cuda",
         "source": "reverie_tpu_torch/csrc/aes_tape_z64.cu",
         "replaces": "reverie_tpu/crypto/kernels/aes_pallas.py:458",
         "launches": gf2["aes_tape_z64"] + z64["aes_tape_z64"],
         "max_abs_err": aesz["max_abs_err"], "ms": aesz["ms"], "plain_ms": aesz["plain_ms"]},
        {"name": "blake3_chunk_cvs", "route": "cuda",
         "source": "reverie_tpu_torch/csrc/blake3_chunks.cu",
         "replaces": "reverie_tpu/crypto/kernels/blake3_pallas.py:74",
         "launches": gf2["blake3_chunk_cvs"] + z64["blake3_chunk_cvs"],
         "max_abs_err": b3["max_abs_err"], "ms": b3["ms"], "plain_ms": b3["plain_ms"]},
    ]
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} was not launched on the main paths")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
