"""StreamingKKW and make_system on a mesh of CPU shards
(reverie_tpu_torch.parallel) against reverie_tpu: every segment runs on
every shard's slice of the lanes, with the shard's own carries and hash
states; the proof bytes equal reverie_tpu's (`TpuKKW(prog,
mesh=make_mesh(8))` on the conftest's 8 virtual devices for 8 shards,
unsharded `TpuKKW` otherwise; tolerance 0), and the verdicts the unsharded
TorchKKW's.  Twins of tests/test_streaming.py's mesh tests."""

import copy

import pytest
import torch

from reverie_tpu.backend.tpu_host import TpuKKW
from reverie_tpu.circuit.builders import (mixed_b2a_circuit, mul_bench_circuit,
                                          z64_mul_bench_circuit)
from reverie_tpu.parallel import make_mesh as jax_make_mesh
from reverie_tpu_torch import StreamingKKW, TorchKKW, make_system
from reverie_tpu_torch.backend import host, scan
from reverie_tpu_torch.parallel import lane_slices, make_mesh

from test_streaming import deep_chain_circuit
from test_torch_prove import MUTATIONS, carry, seeds256
from torch_threads import one_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")


def cpu_mesh(k: int):
    return make_mesh(k, devices=[CPU] * k)


CASES = {
    # name: (circuit, ops a segment, shards)
    "mesh_sharded_streamed_b2a_8": (mixed_b2a_circuit, 24, 8),
    "streamed_deep_mesh_composition_8": (lambda: deep_chain_circuit(300), 150, 8),
    "z64_mul_12": (lambda: z64_mul_bench_circuit(24), 9, 12),
    "mul60_48": (lambda: mul_bench_circuit(60), 23, 48),
}


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_sharded_streamed_prove_matches(name):
    """The streamed proof on a mesh: reverie_tpu's bytes over several
    segments (the deep chain's middle segment on the wave executor with
    carries), the mesh's streamed verify accepts it and rejects it with a
    flipped online recon byte."""
    make, seg_ops, k = CASES[name]
    prog, wit2, witz = make()
    s = seeds256()
    ref = TpuKKW(prog, mesh=jax_make_mesh(8)) if k == 8 else TpuKKW(prog)
    want = ref.prove(wit2, witz, seeds=s).to_bytes()
    sk = StreamingKKW(carry(prog), seg_ops, mesh=cpu_mesh(k))
    assert len(sk.segments) >= 2
    proof = sk.prove(wit2, witz, seeds=s)
    assert proof.to_bytes() == want
    assert sk.verify(proof) is True
    bad = copy.deepcopy(proof)
    o = (bad.z64 if name.startswith("z64") else bad.gf2).online[0]
    o.recons = bytes([o.recons[0] ^ 1]) + o.recons[1:]
    assert sk.verify(bad) is False
    if name.startswith("streamed_deep"):
        assert isinstance(sk._executor(1, 0, 32), scan.ScanExecutor)
        assert sk.segments[1].carry_in and sk.segments[1].carry_out


@pytest.fixture(scope="module")
def verifiers():
    """An unsharded TorchKKW and a 12-shard StreamingKKW (7-op segments)
    of one mul_bench_circuit(20) proof."""
    prog, wit2, witz = mul_bench_circuit(20)
    one = TorchKKW(carry(prog), device=CPU)
    sk = StreamingKKW(carry(prog), 7, mesh=cpu_mesh(12))
    return one, sk, one.prove(wit2, witz, seeds=seeds256(9))


@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_mesh_streamed_verdicts_match_unsharded(verifiers, mutation):
    one, sk, proof = verifiers
    bad = copy.deepcopy(proof)
    MUTATIONS[mutation](bad)
    got = sk.verify(bad)
    assert isinstance(got, bool) and got == one.verify(bad)


def test_make_system_on_a_mesh_takes_both_routes():
    """make_system(mesh=) gives a TorchKKW on the mesh when the footprint
    at the full R fits one device's budget, a StreamingKKW on the mesh
    under a smaller budget and on the lower-bound route; all three prove
    reverie_tpu's bytes.  A mesh and a device together raise ValueError,
    and so does a CPU mesh with no budget."""
    prog, wit2, witz = mul_bench_circuit(40)
    s = seeds256(7)
    want = TpuKKW(prog).prove(wit2, witz, seeds=s).to_bytes()
    mesh = cpu_mesh(5)
    whole = make_system(carry(prog), mesh=mesh, hbm_budget_bytes=1 << 40)
    assert isinstance(whole, TorchKKW) and whole.mesh is mesh
    assert whole.prove(wit2, witz, seeds=s).to_bytes() == want
    fp = host.device_footprint(whole.cc, 256)
    for budget in (fp // 2, 20_000):
        sk = make_system(carry(prog), mesh=mesh, hbm_budget_bytes=budget)
        assert isinstance(sk, StreamingKKW) and sk.mesh is mesh and len(sk.segments) > 1
        proof = sk.prove(wit2, witz, seeds=s)
        assert proof.to_bytes() == want
        assert sk.verify(proof) is True
    with pytest.raises(ValueError, match="not both"):
        make_system(carry(prog), mesh=mesh, device=CPU, hbm_budget_bytes=1 << 40)
    with pytest.raises(ValueError, match="no device budget"):
        make_system(carry(prog), mesh=mesh)
    assert [sl.stop - sl.start for sl in lane_slices(40, mesh)] == [8] * 5
