"""The BLAKE3 tail's time a hash leg on the card, to set two trees side by
side in one call.

    python -m reverie_tpu_torch.tools.tail_times

A hash leg is what TorchKKW._hash_fn does after K3: the tails of the four
streams (pre2, onl2, prez, onlz; with the committed online hashes given in
a preprocessing verify, two) and the three pair hashes.  Each case's
streams are random bytes on the card whose whole chunks K3 hashes once,
outside the timing; then the leg is timed as the tree runs it: with
`blake3.hash_leg`, one launch, where the package has it, else the
`finalize_columns` of each stream and `hash_rep_columns`, a launch each.
The cases: the GF(2) 1M-AND streams proved at R = 256, verified online at
40 and preprocessing at 216, a batch of 8 proofs (R = 2,048); the Z64
50k-MUL streams at 256; the SHA-256 statement's in a chunk of 64 proofs
(R = 16,384).  Each case: three means of 20 legs queued behind a spin of
the card (`queued_ms`: the card's time, not the host's enqueue rate, which
is longer than a leg), the launches a leg, the bound
(roofline.blake3_tail_work over the streams plus blake3_pairs_work) and,
with hash_leg, its launch plan.  One JSON line
a case, then the card's name and power limit.

The module imports its own package by name and uses only what the tail had
before hash_leg, so another tree's package can be timed with this file
(from that tree's root):

    PYTHONPATH=. python <this tree>/reverie_tpu_torch/tools/tail_times.py
"""

from __future__ import annotations

import json

import torch

from reverie_tpu_torch.crypto.kernels import blake3 as b3, blake3_tail
from reverie_tpu_torch.roofline import blake3_pairs_work, blake3_tail_work, bound_ms
from reverie_tpu_torch.tools._timing import card, max_sm_clock_mhz

#: stream lengths (pre2, onl2, prez, onlz) of the three cells
GF2_1M = (1_000_000, 1_000_002, 0, 0)
Z64_50K = (0, 0, 400_000, 3_200_016)
SHA256 = (22_385, 23_153, 0, 0)

#: (case, lengths, R, committed online hashes given)
CASES = (("gf2_1M prove", GF2_1M, 256, False), ("gf2_1M online", GF2_1M, 40, False),
         ("gf2_1M preprocessing", GF2_1M, 216, True), ("gf2_1M batch of 8", GF2_1M, 2048, False),
         ("z64_50k prove", Z64_50K, 256, False), ("sha256 chunk of 64", SHA256, 16_384, False))


def leg_inputs(dev, gen, lengths, R: int, comm: bool):
    """Each stream's (levels, rem, total_len) after K3, or for onl2 and onlz
    with comm their given (R, 32) hashes."""
    legs = []
    for i, T in enumerate(lengths):
        if comm and i in (1, 3):
            legs.append(torch.randint(0, 256, (R, 32), dtype=torch.uint8, device=dev,
                                      generator=gen))
            continue
        buf = torch.randint(0, 256, (max(T, 1), R), dtype=torch.uint8, device=dev, generator=gen)
        n = max(1, -(-T // b3.CHUNK_LEN))
        levels = [b3.chunk_cvs(buf, n - 1)] if n > 1 else []
        legs.append((levels, buf[(n - 1) * b3.CHUNK_LEN : T], T))
    return legs


def leg_fn(legs):
    """The tree's hash leg on these inputs (hash_leg, else a launch a
    stream and one for the pair hashes)."""
    if hasattr(b3, "hash_leg"):
        return lambda: b3.hash_leg(*legs)

    def five():
        h = [x if isinstance(x, torch.Tensor) else b3.finalize_columns(*x) for x in legs]
        return b3.hash_rep_columns(*h)
    return five


def leg_bound(lengths, R: int, comm: bool, clock: float):
    n_bytes = ops = 0
    for i, T in enumerate(lengths):
        if comm and i in (1, 3):
            continue
        n = max(1, -(-T // b3.CHUNK_LEN))
        b, o = blake3_tail_work(n, T - (n - 1) * b3.CHUNK_LEN, R)
        n_bytes, ops = n_bytes + b, ops + o
    b, o = blake3_pairs_work(R)
    return bound_ms(n_bytes + b, ops + o, clock)


def queued_ms(fn, dev, reps: int = 20) -> float:
    """Mean device time of fn() over `reps` runs queued behind a ~20 ms spin
    of the card (torch.cuda._sleep), so that the host has enqueued them all
    before the card reaches the first: the card's time, where
    _timing.cuda_ms of a launch shorter than its host call times the host."""
    fn()
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps


def main() -> int:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    clock = max_sm_clock_mhz()
    for name, lengths, R, comm in CASES:
        legs = leg_inputs(dev, gen, lengths, R, comm)
        fn = leg_fn(legs)
        n0 = blake3_tail.LAUNCHES
        fn()
        launches = blake3_tail.LAUNCHES - n0
        ms = [queued_ms(fn, dev, 20) for _ in range(3)]
        bound, by = leg_bound(lengths, R, comm, clock)
        row = {"case": name, "R": R, "lengths": list(lengths), "committed": comm,
               "route": "hash_leg" if hasattr(b3, "hash_leg") else "finalize x streams + pairs",
               "launches": launches, "ms": ms, "bound_ms": bound, "bound_by": by,
               "bound_share": bound / min(ms)}
        if hasattr(blake3_tail, "launch_plan"):
            row["plan"] = blake3_tail.launch_plan([
                x if isinstance(x, torch.Tensor) else (x[0], x[1], b3._last_chunk(x[2])[1])
                for x in legs]).line()
        print(json.dumps(row), flush=True)
        del legs, fn
        torch.cuda.empty_cache()
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
