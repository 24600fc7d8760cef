"""Streaming past the card, on the CPU (the kernels' plain versions): pass 2
of StreamingKKW.prove packs each segment's opened GF(2) records on the
device at the segment's bit offset and ORs them into packed host rows as
they arrive.  The proofs stay byte-equal to TorchKKW's and to reverie_tpu's
StreamingKKW's, on GF(2), Z64 and B2A circuits and on a 3-shard CPU mesh,
at segment lengths that put the segments' first recon, correction and
input records (rec0, cor0, inp0) on every residue mod 8; the host holds
each segment's GF(2) records packed.  Proofs are bytes: tolerance 0."""

import numpy as np
import pytest
import torch

from reverie_tpu.backend.streaming import StreamingKKW as JStreamingKKW
from reverie_tpu.circuit import builders as jbuilders
from reverie_tpu.circuit import dumps_program
from reverie_tpu_torch import StreamingKKW, TorchKKW
from reverie_tpu_torch.backend import host
from reverie_tpu_torch.circuit import builders, load_program
from reverie_tpu_torch.parallel import make_mesh

from test_fuzz_differential import random_program
from torch_threads import one_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")


def seeds(seed: int = 5) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, size=(256, 16), dtype=np.uint8)


def fuzz(seed: int):
    prog, w2, wz = random_program(seed, 60)
    return load_program(dumps_program(prog)), w2, wz


#: name -> (circuit, segment ops, the GF(2) record bases that must take
#: every residue mod 8 over the segments)
CASES = {
    "gf2_mul": (lambda: builders.mul_bench_circuit(60), 3, ("rec0", "cor0")),
    "gf2_wide": (lambda: builders.wide_and_circuit(60, width=30, seed=2), 3,
                 ("rec0", "cor0", "inp0")),
    "z64_mul": (lambda: builders.z64_mul_bench_circuit(24), 5, ()),
    "b2a": (builders.mixed_b2a_circuit, 3, ("inp0",)),
    "fuzz_b2a": (lambda: fuzz(44), 5, ("rec0",)),
}


def residues(sk, base: str) -> set:
    return {getattr(seg, base) % 8 for seg in sk.segments}


@pytest.mark.parametrize("name", list(CASES))
def test_streamed_proof_at_every_bit_offset_matches_torchkkw(name):
    make, seg_ops, bases = CASES[name]
    prog, w2, wz = make()
    s = seeds()
    sk = StreamingKKW(prog, seg_ops, device=CPU)
    for base in bases:
        assert residues(sk, base) == set(range(8)), base
    want = TorchKKW(prog, device=CPU).prove(w2, wz, seeds=s)
    proof = sk.prove(w2, wz, seeds=s)
    assert proof.to_bytes() == want.to_bytes()
    assert sk.verify(proof) is True


@pytest.mark.parametrize("make, seg_ops", [
    (lambda: jbuilders.mul_bench_circuit(22), 3),
    (jbuilders.mixed_b2a_circuit, 9)], ids=["gf2_mul", "b2a"])
def test_streamed_proof_at_bit_offsets_matches_reverie_tpu_streaming(make, seg_ops):
    """reverie_tpu's StreamingKKW at the same segments: segments whose GF(2)
    records start mid-byte."""
    prog, w2, wz = make()
    s = seeds(6)
    sk = StreamingKKW(load_program(dumps_program(prog)), seg_ops, device=CPU)
    assert len(residues(sk, "rec0") | residues(sk, "inp0")) > 1
    want = JStreamingKKW(prog, seg_ops).prove(w2, wz, seeds=s)
    assert sk.prove(w2, wz, seeds=s).to_bytes() == want.to_bytes()


@pytest.mark.parametrize("name", ["gf2_mul", "b2a", "z64_mul"])
def test_streamed_proof_on_three_shards_matches_torchkkw(name):
    """Each of 3 CPU shards extracts its opened lanes' records at the
    segments' bit offsets; the rows meet in lane order."""
    make, seg_ops, _ = CASES[name]
    prog, w2, wz = make()
    s = seeds(7)
    sk = StreamingKKW(prog, seg_ops, mesh=make_mesh(3, devices=[CPU] * 3))
    want = TorchKKW(prog, device=CPU).prove(w2, wz, seeds=s)
    assert sk.prove(w2, wz, seeds=s).to_bytes() == want.to_bytes()


@pytest.mark.parametrize("name", ["gf2_wide", "b2a", "fuzz_b2a"])
def test_pass2_pulls_hold_packed_records(name, monkeypatch):
    """Pass 2 pulls one buffer a segment: its GF(2) records packed at the
    segment's bit offset, window_bytes(base % 8, n) a record stream and an
    opened rep, then its z64 bytes; the GF(2) bytes of all the pulls are at
    most K x packed_len of the whole streams, plus a shared byte a segment
    boundary."""
    make, seg_ops, _ = CASES[name]
    prog, w2, wz = make()
    sizes = []

    class Recorded(host._Pull):
        def __init__(self, t):
            sizes.append(t.numel())
            super().__init__(t)

    monkeypatch.setattr(host, "_Pull", Recorded)
    sk = StreamingKKW(prog, seg_ops, device=CPU)
    sk.prove(w2, wz, seeds=seeds())
    K, S = sk.params.online_reps, len(sk.segments)
    counts2 = (("n_recons2", "rec0"), ("n_corrs2", "cor0"), ("n_inputs2", "inp0"))
    gf2 = [K * sum(host.window_bytes(getattr(seg, b) % 8, getattr(seg.cc, n))
                   for n, b in counts2) for seg in sk.segments]
    z64 = [K * 8 * (seg.cc.n_reconsz + seg.cc.n_corrsz + seg.cc.n_inputsz)
           for seg in sk.segments]
    assert sizes[-S:] == [g + z for g, z in zip(gf2, z64)]
    assert sum(gf2) <= K * (sum(host.packed_len(sk.totals[n]) for n, _ in counts2) + 2 * S)


@pytest.mark.parametrize("lead", range(8))
@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 30])
def test_window_packing_ors_into_whole_rows(lead, n):
    """_pack_rows_device at a lead bit offset, ORed into rows at its byte
    offset beside the windows before and after it, gives the whole packed
    stream (np.packbits, MSB first)."""
    rng = np.random.RandomState(8 * n + lead)
    K, before, after = 3, 8 * 3 + lead, 5
    total = before + n + after
    bits = rng.randint(0, 2, (total, K)).astype(np.uint8)
    rows = np.zeros((K, host.packed_len(total)), np.uint8)
    for lo, hi in ((0, before), (before, before + n), (before + n, total)):
        got = host._pack_rows_device(torch.from_numpy(bits[lo:hi]), lo % 8).t().numpy()
        assert got.shape == (K, host.window_bytes(lo % 8, hi - lo))
        rows[:, lo // 8 : lo // 8 + got.shape[1]] |= got
    want = np.zeros_like(rows)
    want[:, : -(-total // 8)] = np.packbits(bits.T, axis=1)
    assert np.array_equal(rows, want)
