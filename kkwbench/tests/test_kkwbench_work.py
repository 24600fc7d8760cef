"""The benchmark's frozen work counts equal the port's own at the cells'
shapes: the program's stream shape against the compiled circuit's,
K1's against chip_smoke.py's check_tape, K3's against
tools/k3_times.py's case_bound, the tail's against roofline.py and
tools/tail_times.py, and W1's against roofline.wave_gf2_work on the
SHA-256 statement's wave table (its gates, without the empty slots)."""

from __future__ import annotations

import numpy as np
import pytest

from kkwbench import peaks, program, spec as specs
from kkwbench.driver import PROVER, VERIFY_ONL, VERIFY_PRE
from kkwbench.metrics import aes_tape_gf2_roofline, blake3_roofline, scan_gf2_roofline

SPEC = specs.load()
CLOCK = 1980.0


def _statement(name):
    cfg = specs.config(SPEC, name)
    return specs.statement(cfg["statement"]).make(cfg["args"], np.random.default_rng([2**31, 0]))


@pytest.fixture(scope="module")
def sha256():
    from reverie_tpu_torch.circuit.bincode import load_program_arrays
    from reverie_tpu_torch.circuit.compile import compile_program

    st = _statement("sha256_preimage")
    return st, compile_program(load_program_arrays(program.to_bincode(st.program)))


def test_constants_equal_the_port():
    from reverie_tpu_torch import roofline

    assert peaks.AES_BLOCK_INT_OPS == roofline.AES_BLOCK_INT_OPS
    assert peaks.BLAKE3_NODE_INT_OPS == roofline.BLAKE3_NODE_INT_OPS
    assert peaks.BLAKE3_COMPRESSION_INT_OPS == roofline.BLAKE3_COMPRESSION_INT_OPS
    assert (peaks.HBM_BYTES_PER_S, peaks.SMS, peaks.ISSUE_LANES_PER_SM) == (
        roofline.HBM_BYTES_PER_S, roofline.SMS, roofline.ISSUE_LANES_PER_SM)
    for b, o in ((1e9, 1e6), (1e3, 1e12)):
        assert peaks.bound_s(b, o, CLOCK) * 1e3 == pytest.approx(roofline.bound_ms(b, o, CLOCK)[0])


def test_shapes_equal_the_compiled_circuit(sha256):
    from reverie_tpu_torch.circuit.bincode import load_program_arrays
    from reverie_tpu_torch.circuit.builders import mul_bench_circuit
    from reverie_tpu_torch.circuit.compile import compile_program

    st, cc = sha256
    cases = [(program.shape(st.program), cc)]
    small = _statement("gf2_mul_1M").program
    cases.append((program.shape(small), compile_program(mul_bench_circuit(small.count(
        program.GF2, program.MUL))[0])))
    for s, c in cases:
        assert (s.m2, s.n_onl, s.n_pre) == (c.m2, c.onl2, c.pre2)
        assert (s.n_inputs, s.n_muls, s.n_muls + s.n_asserts) == (c.n_inputs2, c.n_corrs2,
                                                                   c.n_recons2)
        assert s.n_inputs == c.n_wit2


@pytest.mark.parametrize("cfg", ["gf2_mul_1M", "sha256_preimage"])
def test_tape_work_equals_check_tape(cfg, monkeypatch):
    import torch

    import chip_smoke
    from reverie_tpu_torch.crypto.kernels import aes_tape

    m2 = program.shape(_statement(cfg).program).m2
    seen = []
    monkeypatch.setattr(chip_smoke, "set_bound", lambda res, b, o, c: seen.append((b, o)))
    monkeypatch.setattr(chip_smoke, "timed", lambda *a, **k: "")
    monkeypatch.setattr(chip_smoke, "log", lambda *a, **k: None)
    monkeypatch.setattr(aes_tape, "aes_ctr_tape_gf2", lambda rk, m, omit: torch.zeros(1))
    monkeypatch.setattr(aes_tape, "aes_ctr_tape_gf2_ref", lambda rk, m, omit: torch.zeros(1))
    monkeypatch.setattr(aes_tape, "plan", lambda m, R: {})
    chip_smoke.check_tape(torch.device("cpu"), np.random.RandomState(0), "aes_tape_gf2", m2, CLOCK)
    assert len(seen) == len(chip_smoke.REPS)
    for R, (b, o) in zip(chip_smoke.REPS, seen):
        live = o // (-(-m2 // 128) * peaks.AES_BLOCK_INT_OPS)
        assert aes_tape_gf2_roofline.work(m2, R, live) == (b, o)
    # the legs' live keys: every key but the online verifier's omitted one
    assert seen[0][1] == aes_tape_gf2_roofline.work(m2, 256, 8 * 256)[1]


@pytest.mark.parametrize("cfg", ["gf2_mul_1M", "sha256_preimage"])
def test_hash_work_equals_the_port(cfg):
    from reverie_tpu_torch.roofline import blake3_pairs_work, blake3_tail_work
    from reverie_tpu_torch.tools import k3_times, tail_times

    s = program.shape(_statement(cfg).program)
    for R in (40, 216, 256, 2048):
        for T in (s.n_pre, s.n_onl, 0):
            n = max(1, -(-T // 1024))
            assert blake3_roofline.tail_work(n, T - (n - 1) * 1024, R) == blake3_tail_work(
                n, T - (n - 1) * 1024, R)
            if n > 1:
                b, o = blake3_roofline.chunks_work(n - 1, R)
                assert peaks.bound_s(b, o, CLOCK) * 1e3 == pytest.approx(
                    k3_times.case_bound(R, n - 1, CLOCK)[0])
        assert blake3_roofline.pairs_work(R) == blake3_pairs_work(R)
        for comm, lengths in ((False, (s.n_pre, s.n_onl, 0, 0)), (True, (s.n_pre, 0))):
            tb, to = blake3_roofline.leg_work(lengths, R)[-1]
            want = tail_times.leg_bound((s.n_pre, s.n_onl, 0, 0), R, comm, CLOCK)[0]
            assert peaks.bound_s(tb, to, CLOCK) * 1e3 == pytest.approx(want)


def test_wave_work_equals_the_port(sha256):
    from reverie_tpu_torch.backend import scan
    from reverie_tpu_torch.roofline import wave_gf2_work

    st, cc = sha256
    s = program.shape(st.program)
    ops = scan.waves(cc).op
    gates = ops[ops != scan._NOP]
    rows = {PROVER: cc.m2 + cc.n_wit2, VERIFY_ONL: cc.m2 + cc.n_inputs2 + cc.n_corrs2 + cc.n_recons2,
            VERIFY_PRE: cc.m2}
    for role, R in ((PROVER, 256), (VERIFY_ONL, 40), (VERIFY_PRE, 216)):
        assert scan_gf2_roofline.work(s, role, R) == wave_gf2_work(gates, role, R, rows[role],
                                                                   cc.onl2, cc.pre2)
