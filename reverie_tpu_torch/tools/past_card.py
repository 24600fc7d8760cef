"""Proving a circuit larger than the card: make_system with no budget, in
this process, on a bench circuit whose device_footprint passes the card's
free memory.

    python -m reverie_tpu_torch.tools.past_card gf2 [ANDs] [cut ANDs]
    python -m reverie_tpu_torch.tools.past_card z64 [MULs] [cut MULs]

Defaults: mul_bench_circuit(48,000,000) with a cut of 4,000,000 ANDs, and
z64_mul_bench_circuit(1,200,000) with a cut of 100,000 MULs.  Run it in a
fresh process, so that the free device memory and the host's peak RSS are
the case's own.  For the case: the setup split (the builder, make_system),
the system make_system returned (it must be a StreamingKKW), its segments
and the most ops a segment took, the budget it planned for; a cold and a
warm prove (walls, last_timings; the two proofs equal), verify (True), a
flipped byte in an online opening (False), the peak max_memory_allocated
over all of it (at most the budget), the host's peak RSS, and the launches
of K1, K3 and K4 in those runs, counted from 0.  Then the tape kernel of
the case's domain (K1 or K4) at the last segment's window (the largest
start_block) and K3 at its stream's chunk base, each against its plain
version on the same inputs; the cut under a budget scaled by cut / ops (so
about as many segments), its proof equal to TorchKKW's with the same seeds;
and last, the whole circuit compiled once to read its device_footprint,
which must pass the budget.  Prints one JSON line, then the card's name
and power limit; exits 1 if any check fails.
"""

from __future__ import annotations

import copy
import gc
import json
import resource
import sys
import time

import numpy as np
import torch

from reverie_tpu_torch import StreamingKKW, TorchKKW, device_budget, make_system
from reverie_tpu_torch.backend import host
from reverie_tpu_torch.backend.streaming import Z64_REFILL_BLOCKS, Z64_REFILL_WORDS
from reverie_tpu_torch.circuit.builders import mul_bench_circuit, z64_mul_bench_circuit
from reverie_tpu_torch.circuit.compile import compile_program
from reverie_tpu_torch.crypto.kernels import aes_tape, aes_tape_z64, blake3 as b3
from reverie_tpu_torch.proof import Proof
from reverie_tpu_torch.tools._timing import card

CASES = {"gf2": (mul_bench_circuit, 48_000_000, 4_000_000),
         "z64": (z64_mul_bench_circuit, 1_200_000, 100_000)}
#: the kernels of the streamed paths, by their launch counters
KERNELS = {"aes_tape_gf2": aes_tape, "aes_tape_z64": aes_tape_z64, "blake3_chunk_cvs": b3}


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
    kernels = ("aes_tape_gf2" if res["case"] == "gf2" else "aes_tape_z64", "blake3_chunk_cvs")
    checks[f"{' and '.join(kernels)} launched"] = all(res["launches"][k] > 0 for k in kernels)
    bad += [name for name, ok in checks.items() if not ok]
    return bad


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("past_card: needs a CUDA card", file=sys.stderr)
        return 2
    domain = argv[1] if len(argv) > 1 else "gf2"
    n = int(argv[2]) if len(argv) > 2 else CASES[domain][1]
    cut = int(argv[3]) if len(argv) > 3 else CASES[domain][2]
    res = run_case(domain, n, cut)
    res["failures"] = failures(res)
    print(json.dumps(res), flush=True)
    print(card(), flush=True)
    return 1 if res["failures"] else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
