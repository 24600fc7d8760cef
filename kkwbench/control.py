"""The control of `correct`: the plain reference put in the program's place
with one guarantee of the configuration broken, which has to come out as
not correct.  It proves with one online rep fewer than the configuration
opens (guarantees.online_reps - 1), the step that would tempt a faster
prover; its verifier accepts every proof.  A proof is computed only when
its bytes are first read, so a window of it costs what the checks cost.

    python -m kkwbench.control --workload <cell> --seeds 11,12,13 [--seconds 2]

prints each seed's checks and `correct`, and exits 1 unless every run came
out not correct.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


class LazyProof:
    def __init__(self, system, witness=None, seeds=None, data: bytes = None):
        self.system, self.witness, self.seeds, self.data = system, witness, seeds, data

    @staticmethod
    def from_bytes(data: bytes) -> "LazyProof":
        return LazyProof(None, data=data)

    def to_bytes(self) -> bytes:
        if self.data is None:
            s = self.system
            self.data = s.reference.prove(s.program, np.asarray(self.witness)[None],
                                          self.seeds[None], s.device, s.total_reps,
                                          s.online_reps - 1, s.plan)[0]
        return self.data


class ControlSystem:
    """The entries kkwbench.driver calls, answered by the reference."""

    def __init__(self, statement, params, device, reference):
        self.program, self.device, self.reference = statement.program, device, reference
        self.total_reps, self.online_reps = params.total_reps, params.online_reps
        self.plan = reference.plan(self.program, device)
        self.last_timings = {}

    def prove_many(self, jobs, seeds):
        return [LazyProof(self, w, s) for (w, _), s in zip(jobs, seeds)]

    def prove_batch_chunked(self, jobs, seeds, chunk=64):
        return self.prove_many(jobs, seeds)

    def verify_many(self, proofs):
        return [True] * len(proofs)


def make(statement, ops, params, key, device, reference):
    return ControlSystem(statement, params, device, reference)


def main(argv=None) -> int:
    from kkwbench import run

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    ok = True
    for seed in map(int, args.seeds.split(",")):
        result, lines = run.run(args.workload, seed, args.seconds, False, make=make)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": result["correct"],
                          "checks": result["checks"]}), flush=True)
        ok &= result["correct"] is False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
