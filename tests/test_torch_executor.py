"""The port's levelized GF(2) executor (reverie_tpu_torch.backend.executor)
against reverie_tpu's JAX Executor on the CPU, in all three roles, on the
same compiled circuit and the same random inputs.  onl2, pre2 and fail are
bytes / booleans: the tolerance is 0."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reverie_tpu.backend import tpu as jtpu
from reverie_tpu.circuit import CombineOp, Gate, Op
from reverie_tpu.circuit.builders import mul_bench_circuit, wide_and_circuit
from reverie_tpu.circuit.compile import compile_program
from reverie_tpu_torch.backend import executor as tex
from reverie_tpu_torch.circuit.compile import compile_program as port_compile

from test_torch_prove import carry
from torch_threads import one_thread  # noqa: F401  (autouse)

R = 24


def all_kinds_circuit():
    """Every GF(2) kind: INPUT, ADD, ADDC, SUBC, MULC, MUL, ASSERT, RANDOM,
    CONST, over a few levels, with live and dead destinations."""
    g = CombineOp.gf2
    prog = [g(Gate(Op.INPUT, dst=w)) for w in range(6)]
    prog += [
        g(Gate(Op.RANDOM, dst=6)),
        g(Gate(Op.CONST, dst=7, const=1)),
        g(Gate(Op.CONST, dst=8, const=0)),
        g(Gate(Op.ADD, dst=9, src1=0, src2=1)),
        g(Gate(Op.SUB, dst=10, src1=2, src2=6)),
        g(Gate(Op.ADDC, dst=11, src1=3, const=1)),
        g(Gate(Op.SUBC, dst=12, src1=4, const=1)),
        g(Gate(Op.MULC, dst=13, src1=5, const=1)),
        g(Gate(Op.MULC, dst=14, src1=9, const=0)),
        g(Gate(Op.MUL, dst=15, src1=9, src2=10)),
        g(Gate(Op.MUL, dst=16, src1=11, src2=7)),
        g(Gate(Op.MUL, dst=17, src1=15, src2=16)),
        g(Gate(Op.ADD, dst=18, src1=17, src2=13)),
        g(Gate(Op.MUL, dst=19, src1=18, src2=12)),
        g(Gate(Op.ASSERT_ZERO, src1=14)),
        g(Gate(Op.ASSERT_ZERO, src1=19)),
        g(Gate(Op.ASSERT_ZERO, src1=8)),
        g(Gate(Op.MUL, dst=20, src1=12, src2=6)),
    ]
    return prog


CIRCUITS = {
    "mul300": lambda: mul_bench_circuit(300)[0],
    "wide_and": lambda: wide_and_circuit(120, width=32, seed=5)[0],
    "all_kinds": all_kinds_circuit,
}


def _inputs(cc, mode, seed):
    rng = np.random.RandomState(seed)
    inp = {"tape": rng.randint(0, 256, (cc.m2, R), dtype=np.uint8)}
    if mode == tex.PROVER:
        w = rng.randint(0, 2, (cc.n_wit2, 1), dtype=np.uint8)
        inp["wit2"] = np.repeat(w, R, axis=1)
    elif mode == tex.VERIFY_ONL:
        omit = rng.randint(0, 8, R).astype(np.uint8)
        inp["in2"] = rng.randint(0, 2, (cc.n_inputs2, R), dtype=np.uint8)
        inp["co2"] = rng.randint(0, 2, (cc.n_corrs2, R), dtype=np.uint8)
        re = rng.randint(0, 2, (cc.n_recons2, R), dtype=np.uint8)
        inp["re2"] = (re << (7 - omit)[None, :]).astype(np.uint8)
    return inp


@pytest.mark.parametrize("mode", [tex.PROVER, tex.VERIFY_ONL, tex.VERIFY_PRE])
@pytest.mark.parametrize("name", list(CIRCUITS))
def test_executor_matches_jax(name, mode):
    prog = CIRCUITS[name]()
    cc = compile_program(prog)
    inp = _inputs(cc, mode, seed=mode + 10 * len(name))
    got = tex.Executor(port_compile(carry(prog)), mode, R, torch.device("cpu"))(
        {k: torch.from_numpy(v) for k, v in inp.items()})
    jinp = {("tape2" if k == "tape" else k): jnp.asarray(v) for k, v in inp.items()}
    want = jtpu.Executor(cc, mode, total_reps=R)(jinp)
    for key in ("onl2", "pre2", "fail"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    assert got["onl2"].shape == (max(cc.onl2, 1), R)
    assert got["pre2"].shape == (max(cc.pre2, 1), R)


def test_tables_to_device_lowering():
    """Constant and arithmetic columns lower to slices; only irregular
    columns become device index tensors."""
    cc = port_compile(carry(wide_and_circuit(40, width=16, seed=2)[0]))
    meta, tables = tex.tables_to_device(cc, torch.device("cpu"))
    kinds = {m[0] for m in meta.values()}
    assert {"arith", "gather"} <= kinds
    for name, m in meta.items():
        if m[0] == "gather" and m[2]:
            assert tables[name].dtype == torch.int64
        else:
            assert name not in tables
