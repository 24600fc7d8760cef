"""The segment carries of streaming in the port (reverie_tpu_torch
`circuit.compile.compile_segments`, `Segment`, `compile_program`'s
carry_in / out_val_map, and the carries of the levelized `Executor` and of
the wave executor `scan.ScanExecutor`) on the CPU, against reverie_tpu:
every Segment field and each segment's compiled tables, and each segment
run with its carries chained from the segments before, in each executor
and role, against reverie_tpu's Executor and ScanExecutor given the same
carry arguments.  reverie_tpu carries z64 rows as lo / hi u32 pairs, the
port as int64: the test joins them.  Streams and carries are bytes and
words: the tolerance is 0."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reverie_tpu.backend.tpu import Executor as JExecutor
from reverie_tpu.backend.tpu_scan import ScanExecutor as JScanExecutor
from reverie_tpu.circuit import load_program as j_load
from reverie_tpu.circuit.compile import compile_segments as j_compile_segments
from reverie_tpu_torch.backend import executor as tex, scan
from reverie_tpu_torch.circuit import dumps_program as t_dumps
from reverie_tpu_torch.circuit.compile import compile_program, compile_segments

from test_torch_package import (
    CARRY_KEYS, MODES, SEGMENT_ROWS, deep_b2a, deep_chain, executor_inputs, on, random_mixed,
    run_segments, segment_executor, z64_chain)
from test_torch_wave_z64 import jax_inputs
from torch_threads import one_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
#: (program, ops a segment); the levelized executor's cases are short, as
#: reverie_tpu's Executor compiles each segment's levels unrolled
CASES = {"z64_chain": (lambda: z64_chain(150)[0], 40), "deep_b2a": (lambda: deep_b2a(200)[0], 61),
         "gf2_chain": (lambda: deep_chain(200), 50), "random2": (lambda: random_mixed(2)[0], 17),
         "z64_chain12": (lambda: z64_chain(12)[0], 5), "b2a8": (lambda: deep_b2a(8)[0], 70)}


def assert_cc_equal(got, want) -> None:
    for f in dataclasses.fields(want):
        if f.name == "wave_tables":
            continue
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "levels":
            assert len(a) == len(b)
            for la, lb in zip(a, b):
                assert la.keys() == lb.keys()
                for key in lb:
                    assert la[key].keys() == lb[key].keys()
                    for col in lb[key]:
                        assert la[key][col].dtype == lb[key][col].dtype, (key, col)
                        np.testing.assert_array_equal(la[key][col], lb[key][col])
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.fixture(scope="module")
def segments():
    """(reverie_tpu's segments, the port's, the port's whole circuit) per
    case, once."""
    cache = {}

    def get(name):
        if name not in cache:
            make, seg_ops = CASES[name]
            prog = make()
            cache[name] = (j_compile_segments(j_load(t_dumps(prog)), seg_ops),
                           compile_segments(prog, seg_ops), compile_program(prog))
        return cache[name]
    return get


@pytest.mark.parametrize("name", list(CASES))
def test_compile_segments_matches_reverie_tpu(segments, name):
    """Every Segment field and each segment's compiled circuit; every case
    carries wires across its segments."""
    want, got, _ = segments(name)
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        for f in dataclasses.fields(w):
            a, b = getattr(g, f.name), getattr(w, f.name)
            if f.name == "cc":
                assert_cc_equal(a, b)
            elif isinstance(b, (np.ndarray, list)):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f.name)
            else:
                assert a == b, f.name
    assert any(s.carry_in or s.carry_inz for s in got)


def join(lo, hi) -> np.ndarray:
    return (np.asarray(hi).astype(np.uint64) << 32 | np.asarray(lo).astype(np.uint64)).view(
        np.int64)


def run_jax(segs, cls, mode: int, R: int, inp: dict) -> list:
    """run_segments for reverie_tpu's executors: the same inputs and chained
    carries, the z64 carries as lo / hi pairs."""
    outs = []
    for seg in segs:
        cc = seg.cc
        sub = {k: inp[k][getattr(seg, base): getattr(seg, base) + getattr(cc, n)]
               for k, base, n in SEGMENT_ROWS if k in inp}
        j = jax_inputs(sub)
        for names, src in ((("carry_mask2", "carry_corr2"), seg.carry_src),
                           (("carry_mzlo", "carry_mzhi", "carry_czlo", "carry_czhi"),
                            seg.carry_srcz)):
            for name in names if src else ():
                j[name] = jnp.stack([outs[s][name][row] for s, row in src])
        ex = cls(cc, mode, total_reps=R, carry_in=len(seg.carry_in),
                 carry_out_vals=seg.carry_out_vals, carry_inz=len(seg.carry_inz),
                 carry_outz_vals=seg.carry_outz_vals)
        outs.append(ex(j))
    return outs


def check_segments(got: list, want: list, segs) -> None:
    """Per segment: the port's streams, fail and carry outputs against
    reverie_tpu's (z64 carries joined from lo / hi pairs), and no carry
    output the segment does not have."""
    for s, (g, w, seg) in enumerate(zip(got, want, segs)):
        cc = seg.cc
        for key, n in (("onl2", cc.onl2), ("pre2", cc.pre2), ("onlz", cc.onlz),
                       ("prez", cc.prez)):
            np.testing.assert_array_equal(g[key][:n].numpy(), np.asarray(w[key])[:n],
                                          err_msg=f"segment {s} {key}")
        np.testing.assert_array_equal(g["fail"].numpy(), np.asarray(w["fail"]))
        if seg.carry_out:
            for key in ("carry_mask2", "carry_corr2"):
                np.testing.assert_array_equal(g[key].numpy(), np.asarray(w[key]), err_msg=key)
        if seg.carry_outz:
            np.testing.assert_array_equal(g["carry_maskz"].numpy(),
                                          join(w["carry_mzlo"], w["carry_mzhi"]))
            np.testing.assert_array_equal(g["carry_corrz"].numpy(),
                                          join(w["carry_czlo"], w["carry_czhi"]))
        assert [k in g for k in CARRY_KEYS] == [bool(seg.carry_out)] * 2 + [
            bool(seg.carry_outz)] * 2


@pytest.mark.parametrize("name, mode", [("z64_chain", m) for m in MODES] + [
    ("deep_b2a", MODES[1]), ("gf2_chain", MODES[2]), ("random2", MODES[0])])
def test_wave_segment_carries_match_reverie_tpu(segments, name, mode):
    """Each segment on the wave executor, with the carries of the segments
    before, equals reverie_tpu's ScanExecutor given the same carry
    arguments; the segments' streams put end to end equal the whole
    circuit's."""
    jsegs, segs, whole = segments(name)
    R = 24
    inp = executor_inputs(whole, mode, R, seed=5 + mode)
    got = run_segments(segs, segment_executor(scan.ScanExecutor, mode, R, CPU), on(inp, CPU))
    check_segments(got, run_jax(jsegs, JScanExecutor, mode, R, inp), segs)
    flat = tex.Executor(whole, mode, R, CPU)(on(inp, CPU))
    for key in ("onl2", "pre2", "onlz", "prez"):
        n = getattr(whole, key)
        cat = torch.cat([g[key][: getattr(seg.cc, key)] for g, seg in zip(got, segs)])
        assert torch.equal(cat, flat[key][:n]), key


@pytest.mark.parametrize("name", ["z64_chain12", "b2a8"])
def test_levelized_segment_carries_match_reverie_tpu(segments, name):
    """Each segment on the levelized Executor, with the carries of the
    segments before: reverie_tpu's Executor's streams and carries given the
    same carry arguments (PROVER), and in every role the wave executor's."""
    jsegs, segs, whole = segments(name)
    R = 24
    for mode in MODES:
        inp = executor_inputs(whole, mode, R, seed=9 + mode)
        got = run_segments(segs, segment_executor(tex.Executor, mode, R, CPU), on(inp, CPU))
        waves = run_segments(segs, segment_executor(scan.ScanExecutor, mode, R, CPU),
                             on(inp, CPU))
        for g, w in zip(got, waves):
            assert g.keys() == w.keys() and all(torch.equal(g[k], w[k]) for k in w)
        if mode == tex.PROVER:
            check_segments(got, run_jax(jsegs, JExecutor, mode, R, inp), segs)
