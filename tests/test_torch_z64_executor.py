"""The port's levelized executor on Z_2^64 and B2A circuits against
reverie_tpu's JAX Executor on the CPU, in all three roles, on the same
compiled circuit and the same random inputs.  onl2, pre2, onlz, prez and
fail are bytes / booleans: the tolerance is 0."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reverie_tpu.backend import tpu as jtpu
from reverie_tpu.circuit import CombineOp, Gate, Op
from reverie_tpu.circuit.builders import mixed_b2a_circuit, z64_mul_bench_circuit
from reverie_tpu.circuit.compile import compile_program
from reverie_tpu_torch.backend import executor as tex
from reverie_tpu_torch.circuit.compile import compile_program as port_compile

from test_torch_prove import carry

from test_torch_z64_prove import z64_kinds_circuit
from torch_threads import one_thread  # noqa: F401  (autouse)

R = 24


def all_z64_kinds_circuit():
    """Every z64 kind (z64_kinds_circuit: INPUT, ADD, SUB, ADDC, SUBC,
    MULC, MUL, ASSERT, RANDOM, CONST, live and dead destinations, constants
    near 2^63) and both B2A kinds, fed by 64 GF(2) inputs."""
    z, g = CombineOp.z64, CombineOp.gf2
    prog = z64_kinds_circuit()[0]
    prog += [g(Gate(Op.INPUT, dst=w)) for w in range(64)]
    prog += [
        CombineOp.b2a(18, 0),
        z(Gate(Op.MUL, dst=19, src1=18, src2=13)),
        z(Gate(Op.ASSERT_ZERO, src1=19)),
    ]
    return prog


CIRCUITS = {
    "all_z64_kinds": all_z64_kinds_circuit,
    "mixed_b2a": lambda: mixed_b2a_circuit()[0],
    "z64_mul40": lambda: z64_mul_bench_circuit(40)[0],
}


def _u64(rng, shape):
    return rng.randint(0, 2**63, shape, dtype=np.int64) * 2 + rng.randint(0, 2, shape)


def _inputs(cc, mode, seed):
    """Random executor inputs: the port's names and dtypes (int64 for
    Z_2^64).  The JAX Executor takes the same values as u32 lo/hi pairs."""
    rng = np.random.RandomState(seed)
    inp = {"tape": rng.randint(0, 256, (cc.m2, R), dtype=np.uint8),
           "tapez": _u64(rng, (cc.mz, 8, R))}
    if mode == tex.PROVER:
        inp["wit2"] = np.repeat(rng.randint(0, 2, (cc.n_wit2, 1), dtype=np.uint8), R, 1)
        inp["witz"] = np.repeat(_u64(rng, (cc.n_witz, 1)), R, 1)
    elif mode == tex.VERIFY_ONL:
        omit = rng.randint(0, 8, R).astype(np.uint8)
        inp["in2"] = rng.randint(0, 2, (cc.n_inputs2, R), dtype=np.uint8)
        inp["co2"] = rng.randint(0, 2, (cc.n_corrs2, R), dtype=np.uint8)
        re = rng.randint(0, 2, (cc.n_recons2, R), dtype=np.uint8)
        inp["re2"] = (re << (7 - omit)[None, :]).astype(np.uint8)
        inp["inz"] = _u64(rng, (cc.n_inputsz, R))
        inp["coz"] = _u64(rng, (cc.n_corrsz, R))
        inp["rez"] = _u64(rng, (cc.n_reconsz, 8, R))
    return inp


def _jax_inputs(inp):
    out = {}
    for k, v in inp.items():
        if v.dtype == np.int64:  # z64 -> u32 (lo, hi)
            u = v.view(np.uint64)
            out[k + "_lo"] = jnp.asarray((u & 0xFFFFFFFF).astype(np.uint32))
            out[k + "_hi"] = jnp.asarray((u >> np.uint64(32)).astype(np.uint32))
        else:
            out["tape2" if k == "tape" else k] = jnp.asarray(v)
    return out


@pytest.mark.parametrize("mode", [tex.PROVER, tex.VERIFY_ONL, tex.VERIFY_PRE])
@pytest.mark.parametrize("name", list(CIRCUITS))
def test_z64_executor_matches_jax(name, mode):
    prog = CIRCUITS[name]()
    cc = compile_program(prog)
    inp = _inputs(cc, mode, seed=mode + 10 * len(name))
    got = tex.Executor(port_compile(carry(prog)), mode, R, torch.device("cpu"))(
        {k: torch.from_numpy(v) for k, v in inp.items()})
    want = jtpu.Executor(cc, mode, total_reps=R)(_jax_inputs(inp))
    for key in ("onl2", "pre2", "onlz", "prez", "fail"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    assert got["onlz"].shape == (max(cc.onlz, 1), R)
    assert got["prez"].shape == (max(cc.prez, 1), R)


def test_b2a_reads_keep_gf2_values_live():
    """B2A gates read GF(2) values through 'bits' and a z64 value through
    'zr': those writes are live, and the arenas cover the rows read."""
    cc = port_compile(carry(mixed_b2a_circuit()[0]))
    dead = tex._dead_dst_columns(cc)
    bits = set()
    zr = set()
    for li, table in enumerate(cc.levels):
        for key, cols in table.items():
            if "bits" in cols:
                bits |= set(np.asarray(cols["bits"]).reshape(-1).tolist())
            if "zr" in cols:
                zr |= set(np.asarray(cols["zr"]).tolist())
    for li, table in enumerate(cc.levels):
        for key, cols in table.items():
            vals = set(np.asarray(cols.get("dst", [])).tolist())
            is_z64 = key // tex.N_KINDS != tex.GF2
            if vals & (zr if is_z64 else bits):
                assert dead[(li, key)] is False
    L2, Lz = tex._arena_rows(cc, dead)
    assert L2 > max(bits) and Lz > max(zr)
