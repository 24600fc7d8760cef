"""scan_gf2_roofline.prove / .verify: W1, the GF(2) wave kernel
(scan_gf2_kernel, csrc/scan_gf2.cu) of circuits deeper than 128 levels,
against its bound: one launch a leg, reading its gate table once (12 int32
a gate: the least table, with no empty slot) and per lane its input rows
(the tape, and the witness or the online verifier's injected inputs,
corrections and broadcasts) once, writing the online (not in a
preprocessing verify) and preprocessing streams and the fail flag once;
integer instructions a gate by kind as roofline.WAVE_GF2_INT_OPS counts
them.  A window with no W1 launch (a shallow circuit) reads nothing."""

from kkwbench.driver import PROVER, VERIFY_ONL, VERIFY_PRE
from kkwbench.metrics._roofline import legs, share
from kkwbench.program import (ADD, ADDC, ASSERT_ZERO, CONST, INPUT, MUL, MULC, RANDOM, SUB,
                              SUBC)

KERNEL = "scan_gf2_kernel"
#: integer instructions a rep by gate: the tape byte's parity and the
#: event (INPUT 4), one LOP3 or select (ADD, SUB, ADDC, SUBC, MULC), a move
#: (RANDOM, CONST), the three parities, delta, the share and its parity,
#: corr and the bytes (MUL 16), the parity test and the fail OR (ASSERT_ZERO 3)
OPS = {INPUT: 4, ADD: 1, SUB: 1, ADDC: 1, SUBC: 1, MULC: 1, MUL: 16, ASSERT_ZERO: 3,
       RANDOM: 0, CONST: 0}


def work(shape, role: int, R: int):
    g = shape.gates
    per_lane = sum(OPS[k] * c for k, c in g.items() if not (role == VERIFY_PRE and k == ASSERT_ZERO))
    rows = {PROVER: shape.m2 + shape.n_inputs,
            VERIFY_ONL: shape.m2 + shape.n_inputs + shape.n_muls + shape.n_muls + shape.n_asserts,
            VERIFY_PRE: shape.m2}[role]
    lane_bytes = rows + (shape.n_onl if role != VERIFY_PRE else 0) + shape.n_pre + 1
    return sum(g.values()) * 12 * 4 + lane_bytes * R, per_lane * R


def read(window, part):
    tr = window.trace
    if tr is None or not any(KERNEL in name for name in tr.kernels):
        return None
    return share(window, KERNEL, [work(window.shape, role, R) for role, R in legs(window, part)])
