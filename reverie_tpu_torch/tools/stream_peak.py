"""The streamed prover's peak device memory as its circuit grows, under one
budget: the GF(2) bench circuit (circuit.builders.mul_bench_circuit) at
several sizes through make_system.

    python -m reverie_tpu_torch.tools.stream_peak [budget MiB] [ANDs ...]

Defaults: 128 MiB and 2, 4 and 8 million ANDs, each past the budget by
make_system's lower bound (host.lower_footprint), so that all take
segments of about an eighth of the budget by their device_footprint.
`tools/past_card.py` runs the circuits past the card itself, under the
card's own budget.  For each size: the segments, the bound of each hash's held CVs
(nodes a lane), the CVs the whole stream would hold without the CV stack,
a prove's and a verify's wall, and the peak `max_memory_allocated` over
the prove, the verify and a verify of the proof with a flipped byte,
against the budget.  Fails if a verdict is wrong or a peak passes the
budget.  Prints one JSON line per size, then the card's name and power
limit.
"""

from __future__ import annotations

import gc
import json
import sys
import time

import numpy as np
import torch

from reverie_tpu_torch import StreamingKKW, make_system
from reverie_tpu_torch.circuit.builders import mul_bench_circuit
from reverie_tpu_torch.crypto.kernels import blake3 as b3
from reverie_tpu_torch.proof import Proof
from reverie_tpu_torch.tools._timing import card


def peak_row(dev: torch.device, n_ands: int, budget: int, seed: int) -> dict:
    t = time.perf_counter()
    prog, w2, wz = mul_bench_circuit(n_ands)
    sk = make_system(prog, device=dev, hbm_budget_bytes=budget)
    host_s = time.perf_counter() - t
    if not isinstance(sk, StreamingKKW):
        raise AssertionError(f"{n_ands} ANDs: the budget did not force streaming")
    R = sk.params.total_reps
    h = sk._hashers(R, ("onl2",))["onl2"]
    seeds = np.random.RandomState(seed).randint(0, 256, (R, 16), dtype=np.uint8)
    del prog
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    proof = sk.prove(w2, wz, seeds=seeds)
    torch.cuda.synchronize(dev)
    prove_s = time.perf_counter() - t
    phases = {k: round(v["host_ms"], 3) for k, v in sk.last_timings.items()}
    t = time.perf_counter()
    ok = sk.verify(proof)
    torch.cuda.synchronize(dev)
    verify_s = time.perf_counter() - t
    raw = bytearray(proof.to_bytes())
    raw[len(raw) // 2] ^= 0x40
    rejected = sk.verify(Proof.from_bytes(bytes(raw)))
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    row = {"ands": n_ands, "budget": budget, "segments": len(sk.segments),
           "stream_rows_per_lane": sk._stream_rows, "cv_bound_nodes": h.max_nodes,
           "onl2_chunks": h.n_chunks, "onl2_cvs_without_stack": b3.CV_BYTES * R * h.n_chunks,
           "host_setup_s": host_s, "prove_s": prove_s, "prove_phases_host_ms": phases,
           "verify_s": verify_s, "verify": ok, "flipped_verify": rejected,
           "peak_bytes": peak, "peak_over_budget": peak / budget}
    if ok is not True or rejected is not False:
        raise AssertionError(f"{n_ands} ANDs: a streamed verdict is wrong")
    if peak > budget:
        raise AssertionError(f"{n_ands} ANDs: peak {peak} B above the budget {budget} B")
    return row


def main(argv) -> int:
    budget = int(argv[1]) << 20 if len(argv) > 1 else 128 << 20
    sizes = [int(a) for a in argv[2:]] or [2_000_000, 4_000_000, 8_000_000]
    dev = torch.device("cuda")
    for i, n in enumerate(sizes):
        print(json.dumps(peak_row(dev, n, budget, i)), flush=True)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
