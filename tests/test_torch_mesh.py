"""TorchKKW on a mesh of CPU shards (reverie_tpu_torch.parallel) against
reverie_tpu: the lanes of every stage split over 1, 8, 12, 16 and 48 shards
in one process give proof bytes equal to reverie_tpu's (`TpuKKW(prog,
mesh=make_mesh(8))` on the conftest's 8 virtual devices where the mesh has
8 shards, unsharded `TpuKKW` otherwise; tolerance 0: bytes compared for
equality), and the same verdicts as the unsharded TorchKKW on good,
tampered and malformed proofs.  Twins of reverie_tpu's mesh tests
(tests/test_tpu_backend.py, tests/test_bigmesh.py)."""

import copy

import numpy as np
import pytest
import torch

from reverie_tpu.backend.tpu_host import TpuKKW
from reverie_tpu.circuit.builders import mul_bench_circuit, wide_and_circuit
from reverie_tpu.parallel import make_mesh as jax_make_mesh
from reverie_tpu_torch import TorchKKW
from reverie_tpu_torch.backend import host, scan
from reverie_tpu_torch.parallel import Mesh, Shard, lane_slices, make_mesh
from reverie_tpu_torch.proof import Proof as TProof

from test_torch_prove import MUTATIONS, carry, seeds256
from test_tpu_backend import _deep_b2a_mixed_circuit
from torch_threads import one_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")


def cpu_mesh(k: int):
    """k shards of this process, all on the CPU."""
    return make_mesh(k, devices=[CPU] * k)


def reference(prog, shards: int):
    """reverie_tpu's prover: on the 8 virtual devices for an 8-shard mesh."""
    return TpuKKW(prog, mesh=jax_make_mesh(8)) if shards == 8 else TpuKKW(prog)


@pytest.mark.parametrize("R", [0, 1, 3, 40, 216, 256, 512])
@pytest.mark.parametrize("k", [1, 3, 8, 12, 16, 48])
def test_lane_slices_equal_array_split(R, k):
    got = [np.arange(R)[sl] for sl in lane_slices(R, cpu_mesh(k))]
    want = np.array_split(np.arange(R), k)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_mesh_construction():
    mesh = cpu_mesh(3)
    assert len(mesh) == 3 and mesh.processes == [0] and mesh.local_devices() == [CPU] * 3
    with pytest.raises(ValueError, match="n_devices"):
        make_mesh(2, devices=[CPU] * 3)
    with pytest.raises(ValueError, match="process-major"):
        Mesh((Shard(1, CPU), Shard(0, CPU)))
    with pytest.raises(ValueError, match="no shards"):
        Mesh(())
    prog = carry(mul_bench_circuit(4)[0])
    with pytest.raises(ValueError, match="not both"):
        TorchKKW(prog, mesh=mesh, device=CPU)
    # a mesh of another process's shards only
    with pytest.raises(ValueError, match="no shard in this process"):
        TorchKKW(prog, mesh=Mesh((Shard(1, CPU),)))


def test_make_mesh_needs_cuda_without_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        make_mesh(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 devices asked for, 1 visible"):
        make_mesh(2)
    assert make_mesh().local_devices() == [torch.device("cuda", 0)]


CASES = {
    # name: (circuit, shards)
    "mul20_1": (lambda: mul_bench_circuit(20), 1),
    "mul20_8": (lambda: mul_bench_circuit(20), 8),
    "scan_wide_and_8": (lambda: wide_and_circuit(700, width=8, seed=11), 8),
    "scan_z64_deep_b2a_8": (lambda: _deep_b2a_mixed_circuit(150), 8),
    "mul48_12": (lambda: mul_bench_circuit(48), 12),
    "mul48_16": (lambda: mul_bench_circuit(48), 16),
    "mul20_48": (lambda: mul_bench_circuit(20), 48),
}


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_sharded_prove_matches(name):
    """One proof with its lanes split over the shards: the bytes of
    reverie_tpu's, and the mesh's verify accepts it.  12 and 16 shards do
    not divide 256, 40 or 216; 48 leave 8 shards of the 40-rep leg empty;
    1 shard equals mesh=None.  Each shard's executor is built once per
    role and lane count (scan.ScanExecutor past 128 levels)."""
    make, k = CASES[name]
    prog, wit2, witz = make()
    s = seeds256()
    want = reference(prog, k).prove(wit2, witz, seeds=s).to_bytes()
    kkw = TorchKKW(carry(prog), mesh=cpu_mesh(k))
    proof = kkw.prove(wit2, witz, seeds=s)
    assert proof.to_bytes() == want
    assert kkw.verify(proof) is True
    widths = {(mode, sl.stop - sl.start, CPU) for mode, R in ((0, 256), (1, 40), (2, 216))
              for sl in lane_slices(R, kkw.mesh) if sl.stop > sl.start}
    assert set(kkw._executors) == widths
    kind = scan.ScanExecutor if host.uses_waves(kkw.cc) else host.Executor
    assert all(type(ex) is kind for ex in kkw._executors.values())
    if name.startswith("scan"):
        assert kind is scan.ScanExecutor
    if k == 1:
        assert want == TorchKKW(carry(prog), device=CPU).prove(wit2, witz, seeds=s).to_bytes()
    if k == 48:
        assert sum(sl.stop == sl.start for sl in lane_slices(40, kkw.mesh)) == 8


@pytest.mark.parametrize("k", [8, 12])
def test_mesh_sharded_prove_batch_matches(k):
    """prove_batch splits the N * 256 proof-major lanes as a whole: at 12
    shards a shard holds lanes of both proofs."""
    prog, wit2, witz = mul_bench_circuit(8)
    seeds = np.random.RandomState(13).randint(0, 256, size=(2, 256, 16), dtype=np.uint8)
    wits = [(wit2, witz)] * 2
    want = [p.to_bytes() for p in reference(prog, k).prove_batch(wits, seeds=seeds)]
    kkw = TorchKKW(carry(prog), mesh=cpu_mesh(k))
    got = kkw.prove_batch(wits, seeds=seeds)
    assert [p.to_bytes() for p in got] == want
    assert kkw.verify_many(got) == [True, True]
    if k == 12:
        assert any(sl.start < 256 < sl.stop for sl in lane_slices(512, kkw.mesh))


def test_mesh_prove_many_verify_many_and_chunks():
    """prove_many, prove_batch_chunked (a ragged chunk) and verify_many on
    a 12-shard mesh: each proof prove()'s unsharded bytes, verdicts good,
    tampered, malformed, good."""
    prog, wit2, witz = mul_bench_circuit(16)
    seeds = np.random.RandomState(5).randint(0, 256, size=(3, 256, 16), dtype=np.uint8)
    one = TorchKKW(carry(prog), device=CPU)
    want = [one.prove(wit2, witz, seeds=s).to_bytes() for s in seeds]
    kkw = TorchKKW(carry(prog), mesh=cpu_mesh(12))
    jobs = [(wit2, witz)] * 3
    many = kkw.prove_many(jobs, seeds=seeds)
    assert [p.to_bytes() for p in many] == want
    assert [p.to_bytes() for p in kkw.prove_batch_chunked(jobs, seeds=seeds, chunk=2)] == want
    tampered, malformed = copy.deepcopy(many[1]), copy.deepcopy(many[2])
    MUTATIONS["flipped_recons"](tampered)
    MUTATIONS["online_count"](malformed)
    assert kkw.verify_many([many[0], tampered, malformed, many[2]]) == [True, False, False,
                                                                          True]
    assert set(kkw.last_timings) >= {"onl_exec[0]", "pre_hash[3]", "finish[3]"}


@pytest.fixture(scope="module")
def verifiers():
    """An unsharded and a 12-shard verifier of one mul_bench_circuit(20)
    proof."""
    prog, wit2, witz = mul_bench_circuit(20)
    one = TorchKKW(carry(prog), device=CPU)
    return one, TorchKKW(carry(prog), mesh=cpu_mesh(12)), one.prove(wit2, witz,
                                                                    seeds=seeds256(7))


@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_mesh_verdicts_match_unsharded(verifiers, mutation):
    one, sharded, proof = verifiers
    bad = copy.deepcopy(proof)
    MUTATIONS[mutation](bad)
    got = sharded.verify(bad)
    assert isinstance(got, bool) and got == one.verify(bad)
    if mutation == "none":
        assert got is True


def test_mesh_tampered_container_bytes_rejected(verifiers):
    _, sharded, proof = verifiers
    for pos in (5, -1):
        blob = bytearray(proof.to_bytes())
        blob[pos] ^= 1
        assert sharded.verify(TProof.from_bytes(bytes(blob))) is False


def test_mesh_debug_checks_each_shard(verifiers, monkeypatch):
    """REVERIE_DEBUG checks each shard's online tapes at its omits: once a
    shard of the 40-rep leg."""
    _, sharded, proof = verifiers
    monkeypatch.setenv("REVERIE_DEBUG", "1")
    calls = []
    check = host._check_omitted_lanes
    monkeypatch.setattr(host, "_check_omitted_lanes",
                        lambda *a: calls.append(a[2].shape) or check(*a))
    assert sharded.verify(proof) is True
    assert calls == [(4,)] * 4 + [(3,)] * 8
