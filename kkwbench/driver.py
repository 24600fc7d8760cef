"""The one generator of traffic: a mix's file (kkwbench/traffic/<mix>.json)
names the system's entry and its numbers, and this drives it, closed loop,
call after call.

Entries and their keys:
  prove_batch_chunked  statements_per_call, chunk: each call proves that
      many fresh statements in chunks of `chunk` (prove_batch_chunked);
  prove_many  statements_per_call: each call proves them one after another
      (prove_many);
  verify_many  proofs_per_call, pool: set-up proves `pool` statements
      (prove_many); each call verifies the next proofs_per_call of them, in
      turn (verify_many).
Every mix: warmup_calls, the calls set-up makes at the window's own sizes.
An entry that is not one of these is a module of its own,
kkwbench/traffic/<entry>.py (kkwbench.spec.entry), with `KIND` and
`call(mix, i)`.

Call i's statements and rep seeds are drawn from the run's seed and i
alone, so a seed's calls are the same work whatever ran before them.
The proofs compared with the reference are a sample drawn from the seed:
in a prove mix one reservoir a slot of a chunk (`chunk`, else one), so
every lane group of a batch has its proofs compared; in a verify mix a
sample of the pool, whose every verdict in the window has to be True.
After a verify mix's window one more call verifies pool proofs mixed with
tampered copies (kkwbench.tamper), each of which has to come back False.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple

import numpy as np

from kkwbench import spec as specs
from kkwbench import tamper

#: executor roles of a leg (reverie_tpu_torch.backend.executor)
PROVER, VERIFY_ONL, VERIFY_PRE = 0, 1, 2
KIND = {"prove_batch_chunked": "prove", "prove_many": "prove", "verify_many": "verify"}


class Call(NamedTuple):
    t0: float  # perf_counter at the call
    t1: float  # perf_counter at its return
    n: int  # statements proved or proofs verified, asked
    returned: int  # proofs or verdicts returned
    legs: list  # [(executor role, lanes)] each leg of the call's device work
    timings: dict  # the system's last_timings: {phase: {host_ms, device_ms, launches}}


class Job(NamedTuple):
    """A statement as both sides get it: its witness bits and rep seeds."""

    witness: np.ndarray
    seeds: np.ndarray


class Reservoir:
    """A uniform sample of `size` of the items offered, drawn from its own
    generator (Algorithm R): the same seed and count keep the same ones."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size, self.rng, self.seen, self.items = size, rng, 0, []

    def offer(self, item) -> None:
        if self.seen < self.size:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.items[j] = item
        self.seen += 1


class Mix:
    def __init__(self, system, statement, traffic: dict, seed: int, sample: int,
                 total_reps: int, online_reps: int, root=specs.ROOT):
        self.system, self.statement, self.t = system, statement, traffic
        self.seed, self.R, self.online = seed, total_reps, online_reps
        if traffic["entry"] in KIND:
            self.kind = KIND[traffic["entry"]]
            self._entry = {"prove": _prove, "verify": _verify}[self.kind]
        else:
            mod = specs.entry(traffic["entry"], root)
            self.kind, self._entry = mod.KIND, mod.call
        self.sample_size = sample
        slots = int(traffic.get("chunk", 1))
        self.slots = [Reservoir(-(-sample // slots), np.random.default_rng([seed, 4, s]))
                      for s in range(slots)]
        self.pool: List = []
        self.verdicts: dict = {}  # pool index -> verdicts returned in the window

    def jobs(self, stream: int, i: int, n: int) -> List[Job]:
        rng = np.random.default_rng([self.seed, stream, i])
        wit = self.statement.witnesses(rng, n)
        seeds = rng.integers(0, 256, (n, self.R, 16), dtype=np.uint8)
        return [Job(w, s) for w, s in zip(wit, seeds)]

    def setup(self) -> None:
        """The verify mixes' pool, then the warm-up calls."""
        if self.kind == "verify":
            jobs = self.jobs(3, 0, int(self.t["pool"]))
            proofs = self.system.prove_many([(j.witness, []) for j in jobs],
                                            np.stack([j.seeds for j in jobs]))
            self.pool = list(zip(jobs, proofs))
        for i in range(int(self.t["warmup_calls"])):
            self.call(-1 - i)

    def call(self, i: int) -> Call:
        """Call i of the window (a negative i: a warm-up call, not sampled)."""
        return self._entry(self, i)

    def offer(self, jobs, proofs) -> None:
        """A window call's statements and proofs, to the sample: the proof
        at position k of the call to the reservoir of its slot k mod chunk."""
        for k, item in enumerate(zip(jobs, proofs)):
            self.slots[k % len(self.slots)].offer(item)

    def compared(self) -> list:
        """[(job, proof)] the reference proves again: the prove sample, or a
        sample of a verify mix's pool."""
        if self.kind == "prove":
            return [item for r in self.slots for item in r.items]
        rng = np.random.default_rng([self.seed, 5])
        pick = rng.choice(len(self.pool), size=min(self.sample_size, len(self.pool)),
                          replace=False)
        return [self.pool[k] for k in sorted(pick)]

    def wrong_verdicts(self) -> int:
        """Verdicts of the window that are not True (every pool proof is
        valid)."""
        return sum(v is not True for vs in self.verdicts.values() for v in vs)

    def tampered_check(self) -> tuple:
        """After a verify mix's window: one call of verify_many at the
        window's proofs_per_call on pool proofs drawn from the seed, half of
        them replaced by tampered copies (the KINDS in turn) -> (verdicts
        other than expected, verdicts missing, the tampered kinds)."""
        if self.kind != "verify":
            return 0, 0, []
        n = int(self.t["proofs_per_call"])
        rng = np.random.default_rng([self.seed, 6])
        picks = rng.choice(len(self.pool), size=n, replace=len(self.pool) < n)
        bad = set(rng.permutation(n)[: n // 2].tolist())
        first = int(rng.integers(len(tamper.KINDS)))
        proofs, want, kinds = [], [], []
        for pos, k in enumerate(picks):
            proof = self.pool[k][1]
            if pos in bad:
                kind = tamper.KINDS[(first + len(kinds)) % len(tamper.KINDS)]
                kinds.append(kind)
                proof = type(proof).from_bytes(tamper.tamper(proof.to_bytes(), kind))
            proofs.append(proof)
            want.append(pos not in bad)
        out = self.system.verify_many(proofs)
        return sum(v is not w for v, w in zip(out, want)), n - len(out), kinds

    def window(self, seconds: float, span=None) -> tuple:
        """Calls back to back until `seconds` have passed since the first:
        every call begun in the window is taken whole -> (the window's
        start, its calls)."""
        calls: List[Call] = []
        start = time.perf_counter()
        while not calls or time.perf_counter() - start < seconds:
            if span is None:
                calls.append(self.call(len(calls)))
            else:
                with span():
                    calls.append(self.call(len(calls)))
        return start, calls


def _prove(mix: Mix, i: int) -> Call:
    t = mix.t
    n = int(t["statements_per_call"])
    jobs = mix.jobs(1 if i < 0 else 2, abs(i), n)
    args = ([(j.witness, []) for j in jobs], np.stack([j.seeds for j in jobs]))
    if t["entry"] == "prove_many":
        width, t0 = 1, time.perf_counter()
        out = mix.system.prove_many(*args)
    else:
        width, t0 = int(t["chunk"]), time.perf_counter()
        out = mix.system.prove_batch_chunked(*args, chunk=width)
    t1 = time.perf_counter()
    legs = [(PROVER, mix.R * min(width, n - lo)) for lo in range(0, n, width)]
    if i >= 0:
        mix.offer(jobs, out)
    return Call(t0, t1, n, len(out), legs, dict(mix.system.last_timings))


def _verify(mix: Mix, i: int) -> Call:
    n = int(mix.t["proofs_per_call"])
    first = (abs(i) * n) % len(mix.pool)
    idx = [(first + k) % len(mix.pool) for k in range(n)]
    t0 = time.perf_counter()
    out = mix.system.verify_many([mix.pool[k][1] for k in idx])
    t1 = time.perf_counter()
    legs = [(VERIFY_ONL, mix.online), (VERIFY_PRE, mix.R - mix.online)] * n
    if i >= 0:
        for k, v in zip(idx, out):
            mix.verdicts.setdefault(k, []).append(v)
    return Call(t0, t1, n, len(out), legs, dict(mix.system.last_timings))
