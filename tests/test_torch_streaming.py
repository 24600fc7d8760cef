"""The port's streaming prover and verifier (reverie_tpu_torch StreamingKKW)
and make_system on the CPU, i.e. through the kernels' plain versions:
streamed proofs byte-equal to the port's TorchKKW.prove with the same
seeds, and to reverie_tpu's StreamingKKW where named; streamed verdicts
equal to TorchKKW.verify's on good, tampered and malformed proofs; the
segments routed to the wave executor past SCAN_DEPTH_THRESHOLD levels as
TorchKKW routes a circuit.  Programs cross from reverie_tpu as bincode
bytes.  Proofs are bytes: the tolerance is 0."""

import copy

import numpy as np
import pytest
import torch

from reverie_tpu.backend.streaming import StreamingKKW as JStreamingKKW
from reverie_tpu.backend.tpu_host import TpuKKW
from reverie_tpu.circuit import dumps_program
from reverie_tpu.circuit import builders as jbuilders
from reverie_tpu.params import ProtocolParams as JProtocolParams
from reverie_tpu.proof import prove as golden_prove
from reverie_tpu_torch import StreamingKKW, TorchKKW, make_system
from reverie_tpu_torch.backend import host, scan
from reverie_tpu_torch.backend.executor import Executor
from reverie_tpu_torch.circuit import CombineOp, Gate, Op, load_program
from reverie_tpu_torch.circuit.builders import (
    mixed_b2a_circuit,
    mul_bench_circuit,
    wide_and_circuit,
    z64_mul_bench_circuit,
)
from reverie_tpu_torch.params import ProtocolParams
from reverie_tpu_torch.proof import Proof

from test_torch_prove import MUTATIONS
from torch_threads import one_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")


def seeds(seed: int = 42, R: int = 256) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, size=(R, 16), dtype=np.uint8)


def deep_chain_circuit(n: int):
    """tests/test_streaming.py's serial MUL chain: every segment boundary
    carries one live wire."""
    g = CombineOp.gf2
    prog = [g(Gate(Op.INPUT, dst=0)), g(Gate(Op.INPUT, dst=1))]
    prog += [g(Gate(Op.MUL, dst=1, src1=0, src2=1)) for _ in range(n)]
    prog += [g(Gate(Op.ADD, dst=2, src1=1, src2=1)), g(Gate(Op.ASSERT_ZERO, src1=2))]
    return prog, [True, True], []


def with_size_hints(make, at: int, n: int):
    """A program with n SIZE_HINT ops inserted before op `at`."""
    prog, w2, wz = make()
    return prog[:at] + [CombineOp.size_hint(4, 4)] * n + prog[at:], w2, wz


CASES = {
    "mul60": lambda: mul_bench_circuit(60),
    "wide_and": lambda: wide_and_circuit(80, width=32, seed=7),
    "deep_chain": lambda: deep_chain_circuit(70),
    "z64_mul": lambda: z64_mul_bench_circuit(24),
    "b2a": mixed_b2a_circuit,
    # ops 20..24 are one segment of SIZE_HINTs only: no gates, no carries
    "size_hints": lambda: with_size_hints(lambda: mul_bench_circuit(30), 20, 5),
}


def prove_both(name: str, seg_ops: int, seed: int = 42):
    """(the streamed proof, TorchKKW's, the StreamingKKW, the TorchKKW)."""
    prog, wit2, witz = CASES[name]()
    s = seeds(seed)
    whole = TorchKKW(prog, device=CPU)
    sk = StreamingKKW(prog, seg_ops, device=CPU)
    return sk.prove(wit2, witz, seeds=s), whole.prove(wit2, witz, seeds=s), sk, whole


@pytest.mark.parametrize("name, seg_ops", [
    ("mul60", 23), ("wide_and", 23), ("deep_chain", 23), ("mul60", 7), ("z64_mul", 5),
    ("b2a", 7), ("size_hints", 5)])
def test_streamed_proof_matches_torchkkw(name, seg_ops):
    """Proof bytes equal TorchKKW.prove's, over several segments; the
    streamed verifier accepts both proofs."""
    streamed, whole, sk, _ = prove_both(name, seg_ops)
    assert len(sk.segments) >= 3
    assert streamed.to_bytes() == whole.to_bytes()
    assert sk.verify(streamed) is True
    assert sk.verify(whole) is True
    if name == "size_hints":
        assert any(seg.cc.depth == 0 and not seg.cc.levels for seg in sk.segments)


@pytest.mark.parametrize("make, seg_ops", [
    (lambda: jbuilders.mul_bench_circuit(60), 23),
    (lambda: jbuilders.z64_mul_bench_circuit(24), 9)], ids=["mul60", "z64_mul"])
def test_streamed_proof_matches_reverie_tpu_streaming(make, seg_ops):
    """Proof bytes equal reverie_tpu's StreamingKKW's at the same segments;
    the program crosses as bincode."""
    prog, wit2, witz = make()
    s = seeds()
    want = JStreamingKKW(prog, seg_ops).prove(wit2, witz, seeds=s)
    sk = StreamingKKW(load_program(dumps_program(prog)), seg_ops, device=CPU)
    assert len(sk.segments) >= 2
    assert sk.prove(wit2, witz, seeds=s).to_bytes() == want.to_bytes()


def test_deep_segments_run_on_the_wave_executor():
    """deep_chain(420) at 140 ops a segment: the middle segment is deeper
    than SCAN_DEPTH_THRESHOLD and runs scan.ScanExecutor with carries in
    and out; the proof equals TorchKKW's (which runs the whole chain on
    the waves) and verifies."""
    prog, wit2, witz = deep_chain_circuit(420)
    s = seeds()
    sk = StreamingKKW(prog, 140, device=CPU)
    assert len(sk.segments) >= 3 and sk.segments[1].cc.depth > host.SCAN_DEPTH_THRESHOLD
    proof = sk.prove(wit2, witz, seeds=s)
    assert isinstance(sk._executor(1, 0, 256), scan.ScanExecutor)
    assert sk.segments[1].carry_in and sk.segments[1].carry_out
    assert proof.to_bytes() == TorchKKW(prog, device=CPU).prove(wit2, witz, seeds=s).to_bytes()
    assert sk.verify(proof) is True


def test_threshold_is_read_at_each_call(monkeypatch):
    """A patched host.SCAN_DEPTH_THRESHOLD routes streamed segments as it
    routes TorchKKW: past the chain's depth every segment is levelized,
    and the proof bytes do not change."""
    prog, wit2, witz = deep_chain_circuit(300)
    s = seeds(3)
    want = StreamingKKW(prog, 150, device=CPU).prove(wit2, witz, seeds=s)
    monkeypatch.setattr(host, "SCAN_DEPTH_THRESHOLD", 10**6)
    sk = StreamingKKW(prog, 150, device=CPU)
    assert sk.prove(wit2, witz, seeds=s).to_bytes() == want.to_bytes()
    assert all(type(sk._executor(i, 0, 256)) is Executor for i in range(len(sk.segments)))


@pytest.fixture(scope="module")
def b2a_verifiers():
    return prove_both("b2a", 7)


@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_streamed_verdicts_match_torchkkw(b2a_verifiers, mutation):
    """Each of test_torch_prove's mutations of a B2A proof (both domains
    streamed in 7-op segments): the streamed verdict equals
    TorchKKW.verify's (which accepts the lenient ones: overlong streams,
    garbage in the omitted player's key)."""
    proof, _, sk, whole = b2a_verifiers
    bad = copy.deepcopy(proof)
    MUTATIONS[mutation](bad)
    got = sk.verify(bad)
    assert isinstance(got, bool)
    assert got == whole.verify(bad)
    if mutation == "none":
        assert got is True


@pytest.mark.parametrize("pos", [7, 10, -3, "mid"])
def test_streamed_verify_rejects_tampered_bytes(pos):
    """A flipped byte of the container (the commitment, an online opening,
    the last preprocessing commitment) of a mul60 proof in 13-op segments:
    False, as TorchKKW.verify says."""
    proof, _, sk, whole = prove_both("mul60", 13)
    raw = bytearray(proof.to_bytes())
    i = len(raw) // 2 if pos == "mid" else pos
    raw[i] ^= 0x40
    bad = Proof.from_bytes(bytes(raw))
    assert sk.verify(bad) is False and whole.verify(bad) is False


def test_streamed_prove_rejects_an_invalid_witness():
    """x * y + 1 == 0 in 2-op segments: (1, 1) proves, (1, 0) raises as
    TorchKKW.prove raises, and so does a short witness."""
    g = CombineOp.gf2
    prog = [g(Gate(Op.INPUT, dst=0)), g(Gate(Op.INPUT, dst=1)),
            g(Gate(Op.MUL, dst=2, src1=0, src2=1)), g(Gate(Op.ADDC, dst=3, src1=2, const=1)),
            g(Gate(Op.ASSERT_ZERO, src1=3))]
    sk = StreamingKKW(prog, 2, device=CPU)
    assert sk.verify(sk.prove([True, True], [], seeds=seeds())) is True
    for kkw in (TorchKKW(prog, device=CPU), sk):
        with pytest.raises(AssertionError, match="invalid"):
            kkw.prove([True, False], [], seeds=seeds())
        with pytest.raises(AssertionError, match="too short"):
            kkw.prove([True], [], seeds=seeds())


def test_streamed_timings_name_their_phases():
    proof, _, sk, _ = prove_both("z64_mul", 9)
    sk.prove(*CASES["z64_mul"]()[1:], seeds=seeds())
    assert list(sk.last_timings) == ["pass1", "hash_final", "challenge", "pass2", "pack"]
    sk.verify(proof)
    assert list(sk.last_timings) == ["onl_inject", "onl_exec", "onl_hash", "pre_tape",
                                     "pre_exec", "pre_hash"]


@pytest.mark.parametrize("base, n", [(0, 0), (0, 8), (3, 0), (3, 13), (13, 3), (16, 9), (5, 27)])
def test_unpack_window_matches_whole_unpack(base, n):
    """A window of rep-major rows (5 reps of 6 bytes) equals the same bits
    of the whole (byte, rep) unpack."""
    packed = np.random.RandomState(base + n).randint(0, 256, (6, 5), dtype=np.uint8)
    whole = host._unpack_bits(torch.from_numpy(packed), 48)
    rows = torch.from_numpy(packed.T.copy())
    assert torch.equal(host.unpack_window(rows, base, n, CPU), whole[base : base + n])


# -- make_system and TorchKKW(cc=, params=) ----------------------------------


def test_make_system_picks_by_budget():
    """A large budget gives TorchKKW with make_system's compiled circuit; a
    budget under the footprint a StreamingKKW of several segments; one far
    under it (the lower bound) a StreamingKKW with no whole compile; all
    three give the same proof bytes."""
    prog, wit2, witz = mul_bench_circuit(40)
    s = seeds(7)
    whole = make_system(prog, device=CPU, hbm_budget_bytes=1 << 40)
    assert isinstance(whole, TorchKKW)
    fp = host.device_footprint(whole.cc, 256)
    want = whole.prove(wit2, witz, seeds=s).to_bytes()
    for budget in (fp // 2, 20_000):
        sk = make_system(prog, device=CPU, hbm_budget_bytes=budget)
        assert isinstance(sk, StreamingKKW) and len(sk.segments) > 1
        proof = sk.prove(wit2, witz, seeds=s)
        assert proof.to_bytes() == want
        assert sk.verify(proof) is True


def test_make_system_budget_from_the_environment(monkeypatch):
    """On the CPU there are no free bytes to read: without a budget
    make_system raises ValueError, with REVERIE_HBM_BUDGET it plans for
    that."""
    prog, _, _ = mul_bench_circuit(10)
    monkeypatch.delenv("REVERIE_HBM_BUDGET", raising=False)
    with pytest.raises(ValueError):
        make_system(prog, device=CPU)
    monkeypatch.setenv("REVERIE_HBM_BUDGET", "20000")
    assert isinstance(make_system(prog, device=CPU), StreamingKKW)
    monkeypatch.setenv("REVERIE_HBM_BUDGET", str(1 << 40))
    assert isinstance(make_system(prog, device=CPU), TorchKKW)


def test_mesh_is_refused():
    """make_system, StreamingKKW and TorchKKW take the port's own
    parallel.Mesh; a mesh of any other type raises TypeError."""
    prog, _, _ = mul_bench_circuit(10)
    for make in (lambda: make_system(prog, device=CPU, mesh=object(), hbm_budget_bytes=1),
                 lambda: StreamingKKW(prog, 4, device=CPU, mesh=object()),
                 lambda: TorchKKW(prog, device=CPU, mesh=object())):
        with pytest.raises(TypeError, match="parallel Mesh"):
            make()


def test_passed_circuit_is_not_compiled_again(monkeypatch):
    prog, wit2, witz = mul_bench_circuit(20)
    cc = host.compile_program(prog)

    def no_compile(*args, **kwargs):
        raise AssertionError("compiled again")

    monkeypatch.setattr(host, "compile_program", no_compile)
    kkw = TorchKKW(prog, device=CPU, cc=cc)
    assert kkw.cc is cc
    assert kkw.verify(kkw.prove(wit2, witz, seeds=seeds())) is True


def test_nondefault_params_match_tpukkw():
    """ProtocolParams(online_reps=16, total_reps=64) (test_roundtrip's
    case): TorchKKW's and StreamingKKW's proofs equal TpuKKW's and the
    golden prover's with those params, verify under them, and a verifier
    of the default params rejects them."""
    jparams = JProtocolParams(online_reps=16, total_reps=64)
    params = ProtocolParams(online_reps=16, total_reps=64)
    jprog, wit2, witz = jbuilders.mul_bench_circuit(20)
    prog = load_program(dumps_program(jprog))
    s = seeds(3, 64)
    want = TpuKKW(jprog, params=jparams).prove(wit2, witz, seeds=s).to_bytes()
    assert want == golden_prove(jprog, wit2, witz, seeds=s.reshape(8, 8, 16),
                                params=jparams).to_bytes()
    kkw = TorchKKW(prog, device=CPU, params=params)
    proof = kkw.prove(wit2, witz, seeds=s)
    assert proof.to_bytes() == want
    sk = make_system(prog, params=params, device=CPU, hbm_budget_bytes=5_000)
    assert isinstance(sk, StreamingKKW)
    assert sk.prove(wit2, witz, seeds=s).to_bytes() == want
    assert kkw.verify(proof) is True and sk.verify(proof) is True
    assert TorchKKW(prog, device=CPU).verify(proof) is False


# -- the reference's positional order ------------------------------------------

ORDER_PARAMS = ProtocolParams(online_reps=16, total_reps=64)

POSITIONAL = {  # the reference's positional call, and the same by keyword
    "TorchKKW": (lambda p: TorchKKW(p, ORDER_PARAMS, None, None, device=CPU),
                 lambda p: TorchKKW(p, device=CPU, params=ORDER_PARAMS)),
    "StreamingKKW": (lambda p: StreamingKKW(p, 40, ORDER_PARAMS, None, device=CPU),
                     lambda p: StreamingKKW(p, 40, device=CPU, params=ORDER_PARAMS)),
    "make_system": (lambda p: make_system(p, ORDER_PARAMS, None, 5_000, device=CPU),
                    lambda p: make_system(p, device=CPU, hbm_budget_bytes=5_000,
                                          params=ORDER_PARAMS)),
    "TorchKKW_cache_key": (
        lambda p: TorchKKW(p, ORDER_PARAMS, None, None, b"mul20", device=CPU),
        lambda p: TorchKKW(p, device=CPU, cache_key=b"mul20", params=ORDER_PARAMS)),
    "make_system_cache_key": (
        lambda p: make_system(p, ORDER_PARAMS, None, 1 << 40, b"mul20", device=CPU),
        lambda p: make_system(p, device=CPU, cache_key=b"mul20", hbm_budget_bytes=1 << 40,
                              params=ORDER_PARAMS)),
}


@pytest.mark.parametrize("name", list(POSITIONAL))
def test_reference_positional_order(name, monkeypatch, tmp_path):
    """TorchKKW(program, params, mesh, cc, cache_key), StreamingKKW(program,
    seg_ops, params, mesh) and make_system(program, params, mesh,
    hbm_budget_bytes, cache_key) take reverie_tpu's positional order
    (device keyword-only) and give the keyword form's proof; with a
    cache_key the first writes the compile cache and the second reads it."""
    monkeypatch.setenv("REVERIE_COMPILE_CACHE", str(tmp_path))
    prog, wit2, witz = mul_bench_circuit(20)
    positional, keyword = (make(prog) for make in POSITIONAL[name])
    assert type(positional) is type(keyword) and positional.params is ORDER_PARAMS
    assert len(list(tmp_path.iterdir())) == int(name.endswith("cache_key"))
    s = seeds(5, 64)
    proof = positional.prove(wit2, witz, seeds=s)
    assert proof.to_bytes() == keyword.prove(wit2, witz, seeds=s).to_bytes()
    assert keyword.verify(proof) is True


@pytest.mark.parametrize("make", [
    lambda p: TorchKKW(p, ProtocolParams(), None, None, None, CPU),
    lambda p: StreamingKKW(p, 4, ProtocolParams(), None, CPU),
    lambda p: make_system(p, ProtocolParams(), None, 1 << 40, None, CPU),
], ids=["TorchKKW", "StreamingKKW", "make_system"])
def test_fifth_positional_argument_is_refused(make):
    """A positional argument past the reference's last one raises
    TypeError: `device` given in TorchKKW's and make_system's sixth place
    (after cache_key) or in StreamingKKW's fifth (the reference's
    StreamingKKW takes no cache_key)."""
    with pytest.raises(TypeError, match="positional argument"):
        make(mul_bench_circuit(20)[0])
