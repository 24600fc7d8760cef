"""The wave kernels' times on the card, to set two trees side by side in one
call.

    python -m reverie_tpu_torch.tools.wave_times [w1|w2]

w1: W1 (csrc/scan_gf2.cu) on the SHA-256 statement (parity.sha256_bench),
prove, at R = 256 and 16,384, three means of 10 launches each (CUDA
events), and the one-slot chain (chain_ms: 5,874 waves of 32 slots) twice.
w2: W2 (csrc/scan_z64.cu) on the deep z64 statements (the 5,000-MUL z64
chain proved at R = 256 and 16,384, verified online at 40 and
preprocessing at 216; deep B2A and every z64 kind proved at 256), two
means of 20 each, with each launch plan (reps, threads_y, k).  Both without
an argument.  w2chunk: W2 on the chain at R = 16,384, prove and online
verify, under launch_plan's chunk (the fewest rounds of blocks over the
card's shared memory) and under the longest chunk that fits (its plan at
R = 0), two means of 20 each.  Prints one JSON line, then the card's name
and power limit.

The module imports its own package by name and w1 uses only what the
wave executor had before W2, so another tree's package can be timed with
this file (from that tree's root):

    PYTHONPATH=. python <this tree>/reverie_tpu_torch/tools/wave_times.py w1
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from reverie_tpu_torch import _build
from reverie_tpu_torch.backend import scan
from reverie_tpu_torch.circuit.compile import compile_program
from reverie_tpu_torch.tools._timing import card, cuda_ms

#: the deep z64 statements' chain: 5,000 MULs (SHA-256's depth class)
Z64_CHAIN_MULS = 5_000


def chain_ms(dev: torch.device, n_waves: int, W: int) -> float:
    """W1's dependency chain alone: n_waves waves of W slots at R = 256 (one
    proof), each with one live slot (an ADDC of the value the wave before
    made) and W - 1 NOP slots; mean CUDA-event ms."""
    from reverie_tpu_torch.circuit.compile import _NOP, G_ADDC

    t = np.zeros((n_waves, W, len(scan.SLOT_COLS)), dtype=np.int32)
    t[..., 0] = _NOP
    t[..., 1] = n_waves + 1  # the trash row of build_waves
    t[:, 0, 0], t[:, 0, 11] = G_ADDC, 1
    t[:, 0, 1] = np.arange(1, n_waves + 1)
    t[:, 0, 2] = np.arange(n_waves)
    prog = scan.wave_program(t, 0, dev, 256)
    tape = torch.zeros((1, 256), dtype=torch.uint8, device=dev)
    return cuda_ms(lambda: scan.wave_run(prog, 0, tape, None, None, None, 0, 0), dev)


def z64_statements() -> dict:
    """reverie_tpu's scan-executor test statements (tests/test_tpu_backend.py),
    each deeper than 128 levels: the serial z64 MUL chain at Z64_CHAIN_MULS,
    every z64 kind on a 200-level accumulator, deep B2A (mixed_b2a with a
    200-MUL GF(2) chain).  name -> builder of (program, wit2, witz)."""
    from reverie_tpu_torch.circuit.builders import (
        deep_b2a_circuit, z64_all_ops_circuit, z64_chain_circuit)

    return {"chain": lambda: z64_chain_circuit(Z64_CHAIN_MULS),
            "all_ops": lambda: z64_all_ops_circuit(200), "deep_b2a": lambda: deep_b2a_circuit(200)}


def z64_wave_inputs(dev, rng, cc, mode: int, R: int) -> dict:
    """Random executor inputs of a role at R lanes, made on the card, in the
    executors' names: both tapes; the witnesses (prove); or (online verify)
    tapes that are 0 at each rep's omitted player, as the tape kernels make
    them with their omit, and the injected records: the GF(2) recon bits at
    that player's bit, the z64 recon words at its share."""
    gen = torch.Generator(device=dev).manual_seed(int(rng.randint(2**31)))

    def rows(shape, high=None):
        if high is None:
            return torch.randint(-2**63, 2**63 - 1, shape, dtype=torch.int64, device=dev,
                                 generator=gen)
        return torch.randint(0, high, shape, dtype=torch.uint8, device=dev, generator=gen)

    inp = {"tape": rows((cc.m2, R), 256), "tapez": rows((cc.mz, 8, R))}
    if mode == 0:
        inp.update(wit2=rows((cc.n_wit2, R), 2), witz=rows((cc.n_witz, R)))
    elif mode == 1:
        om = rng.randint(0, 8, R)
        bit = torch.from_numpy((0x80 >> om).astype(np.uint8)).to(dev)
        onehot = torch.arange(8, device=dev)[:, None] == torch.from_numpy(om).to(dev)[None, :]
        inp["tape"] &= ~bit
        inp["tapez"] *= ~onehot
        inp.update(in2=rows((cc.n_inputs2, R), 2), co2=rows((cc.n_corrs2, R), 2),
                   re2=rows((cc.n_recons2, R), 2) * bit, inz=rows((cc.n_inputsz, R)),
                   coz=rows((cc.n_corrsz, R)), rez=rows((cc.n_reconsz, 1, R)) * onehot)
    return inp


def z64_wave_args(prog, mode: int, cc, inp: dict) -> tuple:
    """scan.wave_run's arguments for a program and executor inputs."""
    xin = {0: inp.get("wit2"), 1: inp.get("in2")}.get(mode)
    xinz = {0: inp.get("witz"), 1: inp.get("inz")}.get(mode)
    return (prog, mode, inp["tape"], xin, inp.get("co2"), inp.get("re2"), cc.onl2, cc.pre2,
            inp["tapez"], xinz, inp.get("coz"), inp.get("rez"), cc.onlz, cc.prez)


def w1_times(dev: torch.device) -> dict:
    from reverie_tpu_torch.parity import sha256_bench

    cc = compile_program(sha256_bench()[0])
    rng = np.random.RandomState(1)
    out = {}
    for R in (256, 16_384):
        prog = scan.circuit_program(cc, 0, dev, R)
        tape = torch.from_numpy(rng.randint(0, 256, (cc.m2, R), dtype=np.uint8)).to(dev)
        wit = torch.from_numpy(rng.randint(0, 2, (cc.n_wit2, R), dtype=np.uint8)).to(dev)
        out[f"sha256@{R}"] = [cuda_ms(lambda: scan.wave_run(
            prog, 0, tape, wit, None, None, cc.onl2, cc.pre2), dev, 10) for _ in range(3)]
    out["chain"] = [chain_ms(dev, 5874, 32) for _ in range(2)]
    return out


#: W2's cases: (statement, role, R)
W2_CASES = (("chain", 0, 256), ("chain", 1, 40), ("chain", 2, 216), ("chain", 0, 16_384),
            ("deep_b2a", 0, 256), ("all_ops", 0, 256))


def w2_times(dev: torch.device) -> dict:
    rng = np.random.RandomState(3)
    out = {}
    made = z64_statements()
    ccs = {name: compile_program(made[name]()[0]) for name in {c[0] for c in W2_CASES}}
    for name, mode, R in W2_CASES:
        cc = ccs[name]
        prog = scan.circuit_program(cc, mode, dev, R)
        args = z64_wave_args(prog, mode, cc, z64_wave_inputs(dev, rng, cc, mode, R))
        out[f"{name}@{R}"] = [cuda_ms(lambda: scan.wave_run(*args), dev, 20) for _ in range(2)]
        out[f"{name}@{R}/plan"] = [prog.plan.reps, prog.plan.threads_y, prog.plan.k]
    return out


#: w2chunk's cases: (role, R) of the chain
W2_CHUNK_CASES = ((0, 16_384), (1, 16_384))


def w2_chunk_times(dev: torch.device) -> dict:
    rng = np.random.RandomState(4)
    cc = compile_program(z64_statements()["chain"]()[0])
    out = {}
    for mode, R in W2_CHUNK_CASES:
        inp = z64_wave_inputs(dev, rng, cc, mode, R)
        for tag, plan_r in (("plan", R), ("longest", 0)):
            prog = scan.circuit_program(cc, mode, dev, plan_r)
            args = z64_wave_args(prog, mode, cc, inp)
            key = f"chain@{R}/{mode}/{tag}"
            out[key] = [cuda_ms(lambda: scan.wave_run(*args), dev, 20) for _ in range(2)]
            out[key + "/chunk"] = prog.plan.chunk
            del prog, args
        del inp
    return out


def main(argv) -> int:
    which = argv[1:] or ["w1", "w2"]
    dev = torch.device("cuda")
    _build.kernels()
    out = {}
    for part in which:
        out.update({"w1": w1_times, "w2": w2_times, "w2chunk": w2_chunk_times}[part](dev))
    print(json.dumps(out), flush=True)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
