"""The port's wave executor for deep GF(2) circuits
(reverie_tpu_torch.backend.scan) and its SHA-256 statements, on the CPU,
against reverie_tpu: `build_waves` and `default_wave_width`, the SHA-256
builders, `ScanExecutor` (the plain version `wave_gf2_ref`) against
reverie_tpu's ScanExecutor (JAX on the CPU) and against the port's
levelized Executor in all three roles, TorchKKW's routing, and a SHA-256
proof against the golden's committed digest.  Streams and fail are bytes
and booleans: the tolerance is 0."""

import copy
import dataclasses
import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import reverie_tpu.circuit.sha256 as jsha
from reverie_tpu.backend.tpu_host import TpuKKW
from reverie_tpu.backend.tpu_scan import ScanExecutor as JScanExecutor
from reverie_tpu.backend.tpu_scan import default_wave_width as j_default_wave_width
from reverie_tpu.circuit import CombineOp, Gate, Op, dumps_program
from reverie_tpu.circuit.builders import mixed_b2a_circuit, wide_and_circuit
from reverie_tpu.circuit.compile import build_waves as j_build_waves
from reverie_tpu.circuit.compile import compile_program as j_compile
from reverie_tpu_torch import TorchKKW, parity
from reverie_tpu_torch.backend import executor as tex, host, scan
from reverie_tpu_torch.circuit import dumps_program as t_dumps, load_program
from reverie_tpu_torch.circuit import sha256 as tsha
from reverie_tpu_torch.circuit.compile import build_waves, compile_program
from torch_threads import one_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
MODES = [tex.PROVER, tex.VERIFY_ONL, tex.VERIFY_PRE]


def carry(prog):
    """A reverie_tpu program as the port's own, through bincode bytes."""
    return load_program(dumps_program(prog))


def deep_circuit(depth=200, failing=True, seed=5):
    """A GF(2) chain `depth` levels deep over every GF(2) opcode: INPUT,
    RANDOM and CONST (at the start and on side branches), ADD, SUB, ADDC,
    SUBC, MULC and MUL on the chain, ASSERT_ZERO of x + x (passing) every
    29 levels and, with `failing`, of the chain's end (failing in the reps
    where it is 1)."""
    rng = np.random.RandomState(seed)
    g = CombineOp.gf2
    prog = [g(Gate(Op.INPUT, dst=w)) for w in range(4)]
    prog += [g(Gate(Op.RANDOM, dst=4)), g(Gate(Op.CONST, dst=5, const=1)),
             g(Gate(Op.CONST, dst=6, const=0))]
    wit, n, chain = [bool(b) for b in rng.randint(0, 2, 4)], 7, 0
    kinds = [Op.ADD, Op.MUL, Op.ADDC, Op.SUB, Op.SUBC, Op.MULC, Op.MUL]
    for i in range(depth):
        op, other = kinds[i % len(kinds)], int(rng.randint(n))
        if op in (Op.ADD, Op.SUB, Op.MUL):
            prog.append(g(Gate(op, dst=n, src1=chain, src2=other)))
        else:
            const = 1 if op == Op.MULC and i % 3 else int(rng.randint(2))
            prog.append(g(Gate(op, dst=n, src1=chain, const=const)))
        chain, n = n, n + 1
        if i % 29 == 7:
            prog += [g(Gate(Op.ADD, dst=n, src1=chain, src2=chain)),
                     g(Gate(Op.ASSERT_ZERO, src1=n))]
            n += 1
        if i % 41 == 3:  # side branches: a fresh input, a random and a const
            prog += [g(Gate(Op.INPUT, dst=n)), g(Gate(Op.RANDOM, dst=n + 1)),
                     g(Gate(Op.CONST, dst=n + 2, const=i & 1)),
                     g(Gate(Op.MUL, dst=n + 3, src1=n, src2=n + 1)),
                     g(Gate(Op.ADD, dst=n + 4, src1=n + 3, src2=n + 2))]
            wit.append(bool(rng.randint(2)))
            n += 5
    if failing:
        prog.append(g(Gate(Op.ASSERT_ZERO, src1=chain)))
    return prog, wit, []


def sha256_program():
    return jsha.sha256_preimage_statement(hashlib.sha256(parity.SHA256_MESSAGE).digest())[0]


@pytest.fixture(scope="module")
def sha256_cc():
    return compile_program(tsha.sha256_preimage_statement(
        hashlib.sha256(parity.SHA256_MESSAGE).digest())[0])


def inputs(cc, mode, R, seed):
    """Random executor inputs of a role, as numpy: the tape, and the
    witness (PROVER) or the injected records (VERIFY_ONL, each rep's recon
    bits at its omitted player's bit)."""
    rng = np.random.RandomState(seed)
    inp = {"tape": rng.randint(0, 256, (cc.m2, R), dtype=np.uint8)}
    if mode == tex.PROVER:
        inp["wit2"] = rng.randint(0, 2, (cc.n_wit2, R), dtype=np.uint8)
    elif mode == tex.VERIFY_ONL:
        omit = rng.randint(0, 8, R)
        inp["in2"] = rng.randint(0, 2, (cc.n_inputs2, R), dtype=np.uint8)
        inp["co2"] = rng.randint(0, 2, (cc.n_corrs2, R), dtype=np.uint8)
        re = rng.randint(0, 2, (cc.n_recons2, R))
        inp["re2"] = (re << (7 - omit)[None, :]).astype(np.uint8)
    return inp


def run_port(cc, mode, R, inp, make=scan.ScanExecutor):
    return make(cc, mode, R, CPU)({k: torch.from_numpy(v) for k, v in inp.items()})


# -- wave packing and the SHA-256 statements --------------------------------

WAVE_PROGRAMS = {
    "deep": lambda: deep_circuit()[0],
    "wide_and": lambda: wide_and_circuit(120, width=32, seed=5)[0],
    "mixed_b2a": lambda: mixed_b2a_circuit()[0],
    "sha256": sha256_program,
}


@pytest.mark.parametrize("name", list(WAVE_PROGRAMS))
def test_build_waves_matches_reverie_tpu(name):
    """Every column of the WaveTable (the z64 ones too) at the default and
    at two other widths, and default_wave_width."""
    prog = WAVE_PROGRAMS[name]()
    jcc, cc = j_compile(prog), compile_program(carry(prog))
    W = scan.default_wave_width(cc)
    assert W == j_default_wave_width(jcc)
    for width in (W, 8, 13):
        want, got = j_build_waves(jcc, width), build_waves(cc, width)
        assert got.has_z64 == want.has_z64 == (name == "mixed_b2a")
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if b is None:
                assert a is None, f.name
            else:
                assert a.dtype == b.dtype, f.name
                np.testing.assert_array_equal(a, b, err_msg=f"{f.name} W={width}")


def test_sha256_statements_match_reverie_tpu():
    """The one-block and two-block preimage statements are bincode-equal,
    and the padding and witness helpers agree."""
    msg = b"x" * 70  # two blocks once padded
    digest = hashlib.sha256(parity.SHA256_MESSAGE).digest()
    got, n = tsha.sha256_preimage_statement(digest)
    want, jn = jsha.sha256_preimage_statement(digest)
    assert (dumps_program(want), jn) == (t_dumps(got), n)
    got2, n2 = tsha.sha256_long_preimage_statement(hashlib.sha256(msg).digest(), 2)
    want2, jn2 = jsha.sha256_long_preimage_statement(hashlib.sha256(msg).digest(), 2)
    assert (dumps_program(want2), jn2) == (t_dumps(got2), n2)
    assert tsha.count_and_gates(got) == jsha.count_and_gates(want)
    for m in (b"", parity.SHA256_MESSAGE, b"y" * 55):
        block = tsha.sha256_pad_one_block(m)
        assert block == jsha.sha256_pad_one_block(m)
        assert tsha.block_to_witness_bits(block) == jsha.block_to_witness_bits(block)
    padded = tsha.sha256_pad_message(msg)
    assert padded == jsha.sha256_pad_message(msg) and len(padded) == 128
    prog, w2, wz = parity.sha256_bench()
    assert t_dumps(prog) == dumps_program(want)
    assert w2 == jsha.block_to_witness_bits(jsha.sha256_pad_one_block(parity.SHA256_MESSAGE))


# -- the executor -------------------------------------------------------------


@pytest.fixture(scope="module")
def deep():
    prog = deep_circuit()[0]
    return j_compile(prog), compile_program(carry(prog))


@pytest.mark.parametrize("R", [256, 40, 216, 512])
@pytest.mark.parametrize("mode", MODES)
def test_scan_executor_matches_reverie_tpu(deep, mode, R):
    """onl2, pre2 and fail equal reverie_tpu's ScanExecutor's (JAX on the
    CPU) on the same inputs; R = 40 is the online verifier's width, with
    each rep's omitted player in re2."""
    jcc, cc = deep
    assert cc.depth > host.SCAN_DEPTH_THRESHOLD
    inp = inputs(cc, mode, R, seed=mode + R)
    got = run_port(cc, mode, R, inp)
    jinp = {("tape2" if k == "tape" else k): jnp.asarray(v) for k, v in inp.items()}
    want = JScanExecutor(jcc, mode, total_reps=R)(jinp)
    for key, n in (("onl2", cc.onl2), ("pre2", cc.pre2)):
        assert got[key].shape == (max(n, 1), R)
        np.testing.assert_array_equal(got[key][:n].numpy(), np.asarray(want[key])[:n],
                                      err_msg=key)
    np.testing.assert_array_equal(got["fail"].numpy(), np.asarray(want["fail"]))
    if mode == tex.PROVER:  # the chain's last ASSERT_ZERO fails in some reps only
        assert 0 < int(got["fail"].sum()) < R
    elif mode == tex.VERIFY_ONL:  # random records fail every rep's asserts
        assert bool(got["fail"].any())


@pytest.mark.parametrize("R, W", [(256, 0), (40, 8), (216, 13), (512, 64)])
@pytest.mark.parametrize("mode", MODES)
def test_scan_executor_matches_levelized(deep, mode, R, W):
    """Every output of the levelized Executor, at several wave widths."""
    _, cc = deep
    inp = {k: torch.from_numpy(v) for k, v in inputs(cc, mode, R, seed=3 * mode + R).items()}
    got = scan.ScanExecutor(cc, mode, R, CPU, wave_width=W)(inp)
    want = tex.Executor(cc, mode, R, CPU)(inp)
    for key in ("onl2", "pre2", "onlz", "prez", "fail"):
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("mode", MODES)
def test_scan_executor_matches_levelized_on_sha256(sha256_cc, mode):
    cc = sha256_cc
    assert cc.depth == 5198 and scan.default_wave_width(cc) == 32
    inp = {k: torch.from_numpy(v) for k, v in inputs(cc, mode, 256, seed=mode).items()}
    got = scan.ScanExecutor(cc, mode, 256, CPU)(inp)
    want = tex.Executor(cc, mode, 256, CPU)(inp)
    for key in ("onl2", "pre2", "onlz", "prez", "fail"):
        assert torch.equal(got[key], want[key]), key


def test_wave_wrapper_takes_plain_path_on_cpu(deep):
    """A CPU tensor goes to wave_gf2_ref without a launch; the wave table
    is built once per circuit and width."""
    _, cc = deep
    n0 = scan.LAUNCHES
    ex = scan.ScanExecutor(cc, tex.PROVER, 8, CPU)
    W = scan.default_wave_width(cc)
    assert scan.waves(cc) is ex.waves is scan.waves(cc, W)
    assert scan.waves(cc, 2 * W) is not ex.waves
    assert ex.table.dtype == torch.int32 and ex.table.shape[2] == len(scan.SLOT_COLS)
    out = ex({k: torch.from_numpy(v) for k, v in inputs(cc, tex.PROVER, 8, 1).items()})
    assert out["fail"].dtype == torch.bool and scan.LAUNCHES == n0
    with pytest.raises(ValueError, match="lanes"):
        ex({"tape": torch.zeros((cc.m2, 9), dtype=torch.uint8)})


def test_wave_table_rejects_z64():
    """A WaveTable with z64 columns is no longer refused: wave_table lays
    out its GF(2) slots and zwave_table its z64 slots, one row of ZSLOT_COLS
    words a slot, the event columns as the first rows of their runs and the
    B2A bits as rows of a bits table; a pure-GF(2) table has no z64 side."""
    cc = compile_program(carry(mixed_b2a_circuit()[0]))
    wv = build_waves(cc, 8)
    t = scan.wave_table(wv, tex.PROVER)
    assert t.shape == wv.op.shape + (len(scan.SLOT_COLS),)
    np.testing.assert_array_equal(t[..., scan.SLOT_COLS.index("dst")], wv.dst)
    zt, bits = scan.zwave_table(wv, tex.PROVER)
    assert zt.shape == wv.zop.shape + (len(scan.ZSLOT_COLS),) and zt.dtype == np.int32
    col = {c: scan.ZSLOT_COLS.index(c) for c in scan.ZSLOT_COLS}
    for name in ("op", "dst", "a", "t0", "t1", "rec", "corr"):
        np.testing.assert_array_equal(zt[..., col[name]], getattr(wv, "z" + name), err_msg=name)
    op = wv.zop
    out, b2a = op == 11, np.isin(op, (10, 11))
    np.testing.assert_array_equal(zt[..., col["b"]], np.where(out, wv.zzr, wv.zb))
    np.testing.assert_array_equal(zt[..., col["xin"]], np.where(op == 0, wv.zwit, 0))
    np.testing.assert_array_equal(zt[..., col["clo"]].view(np.uint32), wv.zclo)
    for name, kinds, n in (("zonl", (5, 6), 64), ("zonl", (0,), 8), ("zpre", (5, 10), 8),
                           ("brec", (11,), 64), ("bonl", (11,), 64)):
        sel = np.isin(op, kinds)
        base = zt[..., col[name.lstrip("z")]][sel]
        np.testing.assert_array_equal(getattr(wv, name)[sel][:, :n], base[:, None] + np.arange(n))
    assert b2a.sum() == len(bits) == 2
    np.testing.assert_array_equal(bits[zt[..., col["bits"]][b2a]], wv.bbits[b2a])
    with pytest.raises(ValueError, match="no z64"):
        scan.zwave_table(build_waves(compile_program(carry(deep_circuit()[0])), 8), tex.PROVER)


def test_routing():
    """Circuits deeper than 128 levels take the wave executor, pure GF(2)
    or mixed (as TpuKKW._executor routes them); shallow ones keep the
    levelized Executor."""
    g = CombineOp.gf2
    deep_mixed = mixed_b2a_circuit()[0] + [
        g(Gate(Op.ADDC, dst=2, src1=2, const=1)) for _ in range(150)]
    cases = {"deep": (deep_circuit()[0], scan.ScanExecutor),
             "shallow": (wide_and_circuit(60, width=16, seed=1)[0], tex.Executor),
             "deep_mixed": (deep_mixed, scan.ScanExecutor)}
    for name, (prog, kind) in cases.items():
        port = TorchKKW(carry(prog), device=CPU)
        assert (port.cc.depth > host.SCAN_DEPTH_THRESHOLD) == (name != "shallow"), name
        assert host.uses_waves(port.cc) == (kind is scan.ScanExecutor), name
        assert type(port._executor(tex.PROVER, 256)) is kind, name


# -- proofs ---------------------------------------------------------------------


def seeds256(seed):
    return np.random.RandomState(seed).randint(0, 256, (256, 16), dtype=np.uint8)


def test_deep_assert_then_overwrite_matches_tpu():
    """ROADMAP Queue 3's case, a wire overwritten after its ASSERT_ZERO,
    behind a chain 150 levels deep: the wave path gives TpuKKW's bytes (and
    the levelized path's)."""
    g = CombineOp.gf2
    prog = [g(Gate(Op.RANDOM, dst=2))]
    prog += [g(Gate(Op.ADDC, dst=2, src1=2, const=0)) for _ in range(150)]
    prog += [
        g(Gate(Op.SUBC, dst=4, src1=2, const=0)), g(Gate(Op.INPUT, dst=9)),
        g(Gate(Op.ADDC, dst=5, src1=4, const=0)), g(Gate(Op.RANDOM, dst=1)),
        g(Gate(Op.ADD, dst=12, src1=5, src2=5)), g(Gate(Op.ADD, dst=15, src1=12, src2=12)),
        g(Gate(Op.ASSERT_ZERO, src1=15)), g(Gate(Op.MUL, dst=7, src1=9, src2=1)),
        g(Gate(Op.ADDC, dst=15, src1=7, const=0)),
    ]
    s = seeds256(3)
    port = TorchKKW(carry(prog), device=CPU)
    assert host.uses_waves(port.cc)
    proof = port.prove([True], [], seeds=s)
    assert proof.to_bytes() == TpuKKW(prog).prove([True], [], seeds=s).to_bytes()
    assert port.verify(proof) is True
    port.cc = compile_program(carry(prog[:1] + prog[151:]))  # the same statement, shallow
    assert not host.uses_waves(port.cc)


def test_deep_proof_matches_tpu_and_batch():
    """A deep all-kinds proof equals TpuKKW's (its scan executor) and, as
    proof 1 of a batch of 2, prove()'s; the batch verifies."""
    prog, wit, _ = deep_circuit(failing=False)
    port = TorchKKW(carry(prog), device=CPU)
    s = np.stack([seeds256(8), seeds256(9)])
    proof = port.prove(wit, [], seeds=s[1])
    assert proof.to_bytes() == TpuKKW(prog).prove(wit, [], seeds=s[1]).to_bytes()
    other = [not b for b in wit]
    batch = port.prove_batch([(other, []), (wit, [])], s)
    assert batch[1].to_bytes() == proof.to_bytes()
    assert batch[0].to_bytes() == port.prove(other, [], seeds=s[0]).to_bytes()
    assert port.verify_many(batch) == [True, True]


def test_sha256_proof_matches_golden_digest():
    """TorchKKW on the CPU proves the SHA-256 benchmark statement with the
    bytes of the golden's committed digest (parity.py), verifies it, and
    rejects it with one flipped online recon bit."""
    case = parity.CASES["sha256_1block"]
    prog, w2, wz, seeds = parity.inputs(case)
    port = TorchKKW(prog, device=CPU)
    assert host.uses_waves(port.cc)
    proof = port.prove(w2, wz, seeds=seeds)
    assert parity.matches(case, proof.to_bytes())
    assert port.verify(proof) is True
    bad = copy.deepcopy(proof)
    o = bad.gf2.online[0]
    o.recons = bytes([o.recons[0] ^ 1]) + o.recons[1:]
    assert port.verify(bad) is False
