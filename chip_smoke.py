"""Smoke test of reverie_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero and
prints no result line:

  1. the card: its name, and its name and power limit from nvidia-smi;
  2. the build of the CUDA kernels (csrc/*.cu, nvcc for sm_90a), timed;
  3. each kernel against its plain PyTorch version on the card at the main
     path's shapes, byte for byte, with both times from CUDA events; then
     the per-column hash on the card against the host C blake3;
  4. the main path: TorchKKW(mul_bench_circuit(1_000_000)).prove, then
     .verify (True), and a proof with one flipped byte in an online opening
     (False), with the kernels' launch counts of that run;
  5. byte parity at 50,000 AND gates with reverie_tpu's NumPy golden prover;
  6. one JSON line of kernels, the nvidia-smi line, and the last line
     {"ok": true, "device": {...}}.

Imports nothing of JAX.  Needs the CUDA toolkit (nvcc) and one card.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

#: the main path's sizes (bench config 4: 1M GF(2) AND gates, 256 reps)
N_MUL = 1_000_000
N_PARITY = 50_000
M2 = 2 * N_MUL + 2  # tape slots of mul_bench_circuit(N_MUL)
T_STREAM = N_MUL + 2  # onl2 rows of mul_bench_circuit(N_MUL)
REPS = (256, 40, 216)  # prove, online verify, preprocessing verify


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
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
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


def main_path(dev, n_mul: int, rng) -> dict:
    from reverie_tpu.circuit.builders import mul_bench_circuit
    from reverie_tpu.proof import Proof
    from reverie_tpu_torch import TorchKKW
    from reverie_tpu_torch.crypto.kernels import aes_tape, blake3 as b3

    t0 = time.perf_counter()
    prog, w2, wz = mul_bench_circuit(n_mul)
    kkw = TorchKKW(prog, device=dev)
    log("main", f"compile mul_bench_circuit({n_mul}) host_s="
        f"{time.perf_counter() - t0:.3f} m2={kkw.cc.m2} onl2={kkw.cc.onl2} "
        f"pre2={kkw.cc.pre2} depth={kkw.cc.depth}")
    seeds = rng.randint(0, 256, (256, 16), dtype=np.uint8)

    aes_tape.LAUNCHES = 0
    b3.LAUNCHES = 0
    legs = {}
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
        for name, tm in (("prove", prove_t), ("verify", verify_t)):
            dev_ms = sum(v["device_ms"] for v in tm.values())
            log("main", f"{run} {name} wall_s={prove_s if name == 'prove' else verify_s:.4f} "
                f"sum_phase_device_ms={dev_ms:.3f}")
            log("main", f"{run} {name} phases " + json.dumps(
                {k: {"host_ms": round(v["host_ms"], 3),
                     "device_ms": round(v["device_ms"], 3),
                     "launches": v["launches"]} for k, v in tm.items()}))
        if ok is not True:
            raise AssertionError("the 1M-AND proof did not verify")
        legs = {"prove": prove_t, "verify": verify_t}
    launches = {"aes_tape_gf2": aes_tape.LAUNCHES, "blake3_chunk_cvs": b3.LAUNCHES}
    log("main", f"verify=True launches={json.dumps(launches)}")

    per_leg = {
        "prove": (legs["prove"]["tape_gf2"], legs["prove"]["hash"]),
        "verify_online": (legs["verify"]["onl_tape"], legs["verify"]["onl_hash"]),
        "verify_preprocessing": (legs["verify"]["pre_tape"], legs["verify"]["pre_hash"]),
    }
    for leg, (tape, hsh) in per_leg.items():
        a, b = tape["launches"]["aes_tape_gf2"], hsh["launches"]["blake3_chunk_cvs"]
        log("main", f"{leg} aes_tape_gf2_launches={a} blake3_chunk_cvs_launches={b}")
        if a < 1 or b < 1:
            raise AssertionError(f"{leg} did not launch both kernels")

    bad = copy.deepcopy(proof)
    o = bad.gf2.online[0]
    o.recons = bytes([o.recons[0] ^ 1]) + o.recons[1:]
    tampered = kkw.verify(Proof.from_bytes(bad.to_bytes()))
    log("main", f"tampered online opening verify={tampered}")
    if tampered is not False:
        raise AssertionError("a tampered proof verified")
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

    rng = np.random.RandomState(2026)
    aes = check_aes(dev, rng, M2)
    b3 = check_blake3(dev, rng, T_STREAM)
    launches = main_path(dev, N_MUL, rng)
    parity(dev, N_PARITY, rng)

    kernels = [
        {"name": "aes_tape_gf2", "route": "cuda",
         "source": "reverie_tpu_torch/csrc/aes_tape.cu",
         "replaces": "reverie_tpu/crypto/kernels/aes_pallas.py:128",
         "launches": launches["aes_tape_gf2"], "max_abs_err": aes["max_abs_err"],
         "ms": aes["ms"], "plain_ms": aes["plain_ms"]},
        {"name": "blake3_chunk_cvs", "route": "cuda",
         "source": "reverie_tpu_torch/csrc/blake3_chunks.cu",
         "replaces": "reverie_tpu/crypto/kernels/blake3_pallas.py:74",
         "launches": launches["blake3_chunk_cvs"], "max_abs_err": b3["max_abs_err"],
         "ms": b3["ms"], "plain_ms": b3["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
