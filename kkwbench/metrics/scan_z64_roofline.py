"""scan_z64_roofline.prove / .verify: W2, the wave kernel of circuits with
Z_2^64 or B2A gates deeper than 128 levels (scan_z64_kernel,
csrc/scan_z64.cu), against its bound: one launch a leg, its GF(2) half
and its Z_2^64 half.  Each half reads its gate table once (12 int32 a
GF(2) gate, 16 a Z_2^64 one and 64 more a B2A step's bits: the least
table, with no empty slot) and per lane its input rows once (the tapes,
and the witness or the online verifier's injected records), writes the
online (not in a preprocessing verify) and preprocessing streams once and
the GF(2) half the fail flag; integer instructions a gate by role and
compiled kind as roofline.WAVE_GF2_INT_OPS and WAVE_Z64_INT_OPS count
them (frozen copies).  The sizes are the executor rows' counter w2_work
(the compiled circuit's gates by kind, B2As and bytes a rep, in the row's
role), which the tests hold to `sizes`, the benchmark's own count of the
program with B2A's expansion; a program without the counter reads
nothing."""

from __future__ import annotations

import re

from kkwbench.driver import PROVER, VERIFY_ONL, VERIFY_PRE
from kkwbench.metrics._roofline import legs, share
from kkwbench.program import (ADD, ADDC, ASSERT_ZERO, B2A, CONST, GF2, INPUT, MUL, MULC, RANDOM,
                              SUB, SUBC, Z64, Program)

KERNEL = "scan_z64_kernel"
PHASES = {"execute": PROVER, "onl_exec": VERIFY_ONL, "pre_exec": VERIFY_PRE}
#: compiled gate kinds (the port's circuit/compile.py): a program op's,
#: and a B2A's two Z_2^64 steps
KIND = {INPUT: 0, ADD: 1, ADDC: 2, SUBC: 3, MULC: 4, MUL: 5, ASSERT_ZERO: 6, RANDOM: 7, CONST: 8}
Z_SUB, B2A_CORR, B2A_OUT = 9, 10, 11
#: a B2A's GF(2) gates (combine.rs:132-219): 64 fresh masks, the adder's
#: 1 + 62 MULs and XORs (bit 0: 1; bits 1..62: 4 each; bit 63: 2)
B2A_GF2 = {KIND[RANDOM]: 64, KIND[MUL]: 63, KIND[ADD]: 1 + 4 * 62 + 2}

#: integer instructions a rep of a GF(2) gate by compiled kind
GF2_OPS = {0: 4, 1: 1, 2: 1, 3: 1, 4: 1, 5: 16, 6: 3, 7: 0, 8: 0}
#: those of a Z_2^64 gate by role and compiled kind
Z64_OPS = {
    PROVER: {0: 24, 1: 18, 9: 18, 2: 2, 3: 2, 4: 27, 8: 0, 7: 0, 5: 236, 6: 82, 10: 280, 11: 402},
    VERIFY_ONL: {0: 8, 1: 18, 9: 18, 2: 2, 3: 2, 4: 27, 8: 0, 7: 0, 5: 205, 6: 98, 10: 8, 11: 466},
    VERIFY_PRE: {0: 0, 1: 18, 9: 18, 2: 2, 3: 2, 4: 27, 8: 0, 7: 0, 5: 156, 6: 0, 10: 280, 11: 210},
}


def gf2_work(gates: dict, role: int, R: int, input_bytes: int, n_onl: int, n_pre: int):
    """(bytes, integer instructions) of the GF(2) half of one call over R
    lanes (roofline.wave_gf2_work on the gates alone)."""
    per_lane = sum(GF2_OPS.get(k, 0) * c for k, c in gates.items()
                   if not (role == VERIFY_PRE and k == KIND[ASSERT_ZERO]))
    lane_bytes = input_bytes + (n_onl if role != VERIFY_PRE else 0) + n_pre + 1
    return sum(gates.values()) * 12 * 4 + lane_bytes * R, per_lane * R


def z64_work(gates: dict, b2a_steps: int, role: int, R: int, input_bytes: int, n_onlz: int,
             n_prez: int):
    """(bytes, integer instructions) of the Z_2^64 half of one call over R
    lanes (roofline.wave_z64_work on the gates alone; b2a_steps its n_b2a,
    the B2A_CORR and B2A_OUT slots)."""
    per_lane = sum(Z64_OPS[role].get(k, 0) * c for k, c in gates.items())
    lane_bytes = input_bytes + (n_onlz if role != VERIFY_PRE else 0) + n_prez
    return sum(gates.values()) * 16 * 4 + b2a_steps * 64 * 4 + lane_bytes * R, per_lane * R


def work(sizes: dict, R: int):
    """(bytes, integer instructions) of one W2 launch over R lanes of the
    circuit of `sizes` (a row's w2_work) in its role."""
    role = sizes["role"]
    g = gf2_work(sizes["gf2_gates"], role, R, sizes["gf2_input_bytes"], sizes["onl2"],
                 sizes["pre2"])
    z = z64_work(sizes["z64_gates"], 2 * sizes["b2a"], role, R, sizes["z64_input_bytes"],
                 sizes["onlz"], sizes["prez"])
    return g[0] + z[0], g[1] + z[1]


def _add(counts: dict, kind: int, n: int) -> None:
    if n:
        counts[kind] = counts.get(kind, 0) + n


def sizes(p: Program, role: int) -> dict:
    """The benchmark's own count of w2_work for a program: its gates by
    compiled kind with each B2A expanded (B2A_GF2, B2A_CORR, B2A_OUT), and
    the bytes a rep of the input rows and streams (GF(2) events 1 byte;
    Z_2^64 inputs and corrections 8, broadcasts 64)."""
    g2, gz = {}, {}
    for kind, counts in ((GF2, g2), (Z64, gz)):
        for op, compiled in KIND.items():
            _add(counts, compiled, p.count(kind, op))
    _add(g2, KIND[ADD], p.count(GF2, SUB))
    _add(gz, Z_SUB, p.count(Z64, SUB))
    n_b2a = int((p.kind == B2A).sum())
    for k, n in B2A_GF2.items():
        _add(g2, k, n * n_b2a)
    _add(gz, B2A_CORR, n_b2a)
    _add(gz, B2A_OUT, n_b2a)

    def c(kind, op):
        return p.count(kind, op)

    m2 = c(GF2, INPUT) + c(GF2, RANDOM) + 2 * c(GF2, MUL) + n_b2a * (64 + 2 * 63)
    mz = c(Z64, INPUT) + c(Z64, RANDOM) + 2 * c(Z64, MUL) + n_b2a
    inputs2, corrs2 = c(GF2, INPUT), c(GF2, MUL) + 63 * n_b2a
    recons2 = c(GF2, MUL) + c(GF2, ASSERT_ZERO) + (63 + 64) * n_b2a
    inputsz, corrsz = c(Z64, INPUT), c(Z64, MUL) + n_b2a
    reconsz = c(Z64, MUL) + c(Z64, ASSERT_ZERO)
    rows2 = {PROVER: m2 + inputs2, VERIFY_ONL: m2 + inputs2 + corrs2 + recons2,
             VERIFY_PRE: m2}[role]
    bytesz = {PROVER: 64 * mz + 8 * inputsz,
              VERIFY_ONL: 64 * mz + 8 * (inputsz + corrsz) + 64 * reconsz,
              VERIFY_PRE: 64 * mz}[role]
    return {"role": role, "gf2_gates": g2, "z64_gates": gz, "b2a": n_b2a,
            "gf2_input_bytes": rows2, "z64_input_bytes": bytesz,
            "onl2": inputs2 + recons2, "pre2": corrs2,
            "onlz": 8 * inputsz + 64 * reconsz, "prez": 8 * corrsz}


def _by_role(window, part) -> dict:
    """{role: w2_work} of the window's executor rows; None where a row
    lacks it or two rows of one role differ."""
    out = {}
    for call in window.calls:
        for name, row in call.timings.items():
            role = PHASES.get(re.sub(r"\[\d+\]$", "", name))
            if role is None:
                continue
            if "w2_work" not in row or out.setdefault(role, row["w2_work"]) != row["w2_work"]:
                return None
    return out


def read(window, part):
    by_role = _by_role(window, part)
    if not by_role:
        return None
    bounds = []
    for role, R in legs(window, part):
        if role not in by_role:
            return None
        bounds.append(work(by_role[role], R))
    return share(window, KERNEL, bounds)

