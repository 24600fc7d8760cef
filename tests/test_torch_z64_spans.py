"""The port's Z_2^64 spans and counters (host.PhaseTimer), on TorchKKW over
the CPU: on a circuit with Z_2^64 events the children "extract_z64",
"gather_z64" and "parse_z64" beside their GF(2) ones, and the counters
"z64_tape_shares" and "w2_work" on the tape and executor rows; on a pure
GF(2) circuit, the rows of before: the same children, fields and launches,
and no counter.  No timing is asserted: the CPU is noisy."""

import numpy as np
import pytest
import torch

from reverie_tpu_torch import TorchKKW
from reverie_tpu_torch.backend import host
from reverie_tpu_torch.backend.executor import PROVER, VERIFY_ONL, VERIFY_PRE
from reverie_tpu_torch.circuit.builders import (mixed_b2a_circuit, mul_bench_circuit,
                                                z64_mul_bench_circuit)
from torch_threads import one_thread  # noqa: F401  (autouse)

#: the children of the phases that have new ones, on a circuit with z64
#: events, on one device
Z64_CHILDREN = {"challenge": ["wait", "commit", "extract_z64", "extract"],
                "extract_pull": ["wait", "gather", "gather_z64", "assemble"],
                "onl_inject": ["parse", "parse_z64", "upload"]}
#: their children on a pure GF(2) circuit (tests/test_torch_spans.py)
GF2_CHILDREN = {"challenge": ["wait", "commit", "extract"],
                "extract_pull": ["wait", "gather", "assemble"],
                "onl_inject": ["parse", "upload"]}
#: the fields of a row before the counters
FIELDS = {"host_ms", "device_ms", "launches", "h2d_bytes", "h2d_pinned_bytes", "start_ns",
          "end_ns", "wait_ms", "spans"}
ROLE = {"execute": PROVER, "onl_exec": VERIFY_ONL, "pre_exec": VERIFY_PRE}


def base(name):
    return name.split("[")[0]


def rows_of(prog, jobs, chunk=1):
    """The rows of a prove_batch_chunked and a verify_many of its proofs."""
    kkw = TorchKKW(prog, device=torch.device("cpu"))
    seeds = np.random.RandomState(5).randint(0, 256, (len(jobs), 256, 16), dtype=np.uint8)
    proofs = kkw.prove_batch_chunked(jobs, seeds, chunk=chunk)
    rows = dict(kkw.last_timings)
    assert kkw.verify_many(proofs) == [True] * len(jobs)
    return kkw, rows, kkw.last_timings


@pytest.fixture(scope="module")
def z64_rows():
    prog, w2, wz = z64_mul_bench_circuit(40)
    return rows_of(prog, [(w2, [3, 5]), (w2, [7, 11])])


@pytest.fixture(scope="module")
def b2a_rows():
    prog, w2, wz = mixed_b2a_circuit()
    return rows_of(prog, [(w2, wz)] * 2, chunk=2)


@pytest.mark.parametrize("which", ["z64_rows", "b2a_rows"])
def test_z64_children(which, request):
    """Each phase with a z64 share holds it as a child of its own, after
    (or, extract_z64, before) its GF(2) one, inside the row."""
    _, prove, verify = request.getfixturevalue(which)
    seen = set()
    for name, row in {**prove, **verify}.items():
        children = [c for c, _, _ in row["spans"]]
        want = Z64_CHILDREN.get(base(name))
        if want is not None:
            assert children == want, name
            seen.add(base(name))
        assert not {"extract_z64", "gather_z64", "parse_z64"} & set(children) or want
        at = row["start_ns"]
        for _, s, e in row["spans"]:
            assert at <= s <= e <= row["end_ns"]
            at = e
    assert seen == set(Z64_CHILDREN)


def test_counters_on_the_z64_circuits(z64_rows, b2a_rows):
    """z64_tape_shares on every z64 tape row; w2_work on the executor rows
    of the circuit on W2 (reverie's B2A round-trip circuit, 190 levels), in each
    row's role, and on none of the levelized one's."""
    for (kkw, prove, verify), waves in ((z64_rows, False), (b2a_rows, True)):
        assert host.uses_waves(kkw.cc) is waves
        for name, row in {**prove, **verify}.items():
            phase = base(name)
            extra = set(row) - FIELDS
            if phase in ("tape_z64", "onl_tape", "pre_tape"):
                assert row["z64_tape_shares"] == kkw.cc.mz > 0
                assert extra == {"z64_tape_shares"}
            elif phase in ROLE and waves:
                sizes = row["w2_work"]
                assert sizes == host.wave_sizes(kkw.cc, ROLE[phase])
                assert sizes["role"] == ROLE[phase] and sizes["b2a"] == 1
                assert sizes["z64_gates"][10] == sizes["z64_gates"][11] == 1
                assert extra == {"w2_work"}
            else:
                assert not extra, name


def test_wave_sizes_count_the_compiled_circuit(b2a_rows):
    """wave_sizes: the compiled circuit's gates by domain and kind, and the
    input rows of each role; {} where the circuit has no z64 gate."""
    kkw = b2a_rows[0]
    cc = kkw.cc
    total = sum(len(next(iter(cols.values()))) for lvl in cc.levels for cols in lvl.values())
    s = host.wave_sizes(cc, PROVER)
    assert sum(s["gf2_gates"].values()) + sum(s["z64_gates"].values()) == total
    assert s["gf2_input_bytes"] == cc.m2 + cc.n_wit2
    assert host.wave_sizes(cc, VERIFY_PRE)["gf2_input_bytes"] == cc.m2
    assert (s["onl2"], s["pre2"], s["onlz"], s["prez"]) == (cc.onl2, cc.pre2, cc.onlz, cc.prez)
    gf2 = TorchKKW(mul_bench_circuit(4)[0], device=torch.device("cpu")).cc
    assert host.wave_sizes(gf2, PROVER) == {}


def test_pure_gf2_rows_are_unchanged():
    """A GF(2) circuit's rows: the children of before, no counter, no new
    field, and no launch on the CPU (the plain versions)."""
    prog, w2, wz = mul_bench_circuit(8)
    kkw, prove, verify = rows_of(prog, [(w2, wz)] * 3, chunk=2)
    for name, row in {**prove, **verify}.items():
        assert set(row) == FIELDS, name
        want = GF2_CHILDREN.get(base(name))
        if want is not None:
            assert [c for c, _, _ in row["spans"]] == want
        assert set(row["launches"].values()) == {0}


def test_b2a_golden_proof_unchanged():
    """The split spans change no byte: the B2A golden circuit's proof from
    its committed seeds."""
    import os

    from reverie_tpu_torch.circuit import load_program

    golden = os.path.join(os.path.dirname(__file__), "golden")
    prog = load_program(open(os.path.join(golden, "b2a_program.bin"), "rb").read())
    seeds = np.frombuffer(open(os.path.join(golden, "b2a_seeds.bin"), "rb").read(),
                          dtype=np.uint8).reshape(256, 16)
    _, w2, wz = mixed_b2a_circuit()
    kkw = TorchKKW(prog, device=torch.device("cpu"))
    proof = kkw.prove(w2, wz, seeds=seeds)
    assert proof.to_bytes() == open(os.path.join(golden, "b2a_proof.bin"), "rb").read()
    assert [c for c, _, _ in kkw.last_timings["challenge"]["spans"]] == Z64_CHILDREN["challenge"]


@pytest.mark.parametrize("starts,width", [([0, 64, 128], 64), ([8, 16, 24, 32], 8), ([5], 8),
                                          ([0, 8, 24], 8), ([16, 0], 8), ([], 8)])
def test_take_events_equals_the_rows(starts, width):
    """_take_events: a slice where the events lie back to back, else the
    gather of their rows; the same rows either way."""
    buf = torch.arange(200 * 3, dtype=torch.int64).view(200, 3)
    want = buf[torch.as_tensor(host.event_rows(starts, width), dtype=torch.int64)] \
        if starts else buf[:0]
    assert torch.equal(host._take_events(buf, np.asarray(starts), width), want)


def test_extractions_take_uploaded_indices(request):
    """extract_gf2 and extract_z64 on the int64 tensors of upload_array give
    the opened records of a plain numpy gather: each GF(2) record the
    omitted player's bit, packed MSB first with the remainder byte, and
    each z64 broadcast the omitted player's 8 bytes of its 64; on the B2A
    circuit (GF(2) records, z64 corrections) and on z64 MULs (broadcasts)."""
    for which in ("b2a_rows", "z64_rows"):
        extractions_match(request.getfixturevalue(which)[0])


@pytest.mark.parametrize("dtype", [np.uint8, np.int64])
def test_upload_array_is_row_major(dtype):
    """upload_array keeps the dtype and gives a row-major tensor, also of
    columns picked out of an array (column-major in numpy), which upload
    could otherwise send only by a copy that waits for the stream."""
    cols = np.arange(66 * 4, dtype=dtype).reshape(66, 4)[:, np.array([0, 2])]
    assert not cols.flags["C_CONTIGUOUS"]
    t = host.upload_array(cols, "cpu")
    assert t.is_contiguous() and t.dtype == torch.from_numpy(cols.copy()).dtype
    assert np.array_equal(t.numpy(), cols)


def extractions_match(kkw):
    cc = kkw.cc
    rng = np.random.RandomState(7)
    R = 24
    out = kkw._executor(PROVER, R)({
        "tape": torch.from_numpy(rng.randint(0, 256, (cc.m2, R), dtype=np.uint8)),
        "tapez": torch.from_numpy(rng.randint(-2**62, 2**62, (cc.mz, 8, R), dtype=np.int64)),
        "wit2": torch.zeros((cc.n_wit2, R), dtype=torch.uint8),
        "witz": torch.zeros((cc.n_witz, R), dtype=torch.int64)})
    cols, omit = np.array([1, 4, 5, 20]), np.array([0, 7, 3, 5])
    cols_t, omit_t = host.upload_array(cols, "cpu"), host.upload_array(omit, "cpu")
    assert cols_t.dtype == omit_t.dtype == torch.int64
    assert cols_t.tolist() == cols.tolist() and omit_t.tolist() == omit.tolist()
    onl2, pre2, onlz, prez = (out[k].numpy() for k in ("onl2", "pre2", "onlz", "prez"))

    def packed(bits):
        return np.packbits(np.concatenate([bits, np.zeros(8 * host.packed_len(len(bits))
                                                          - len(bits), np.uint8)]))

    def opened2(src, slots, shift):
        rows = np.asarray(slots, np.int64)
        return np.concatenate([packed(src[rows, c] >> shift(o) & 1) for c, o in zip(cols, omit)])

    want2 = [opened2(onl2, cc.recon_slots2, lambda o: 7 - o),
             opened2(pre2, cc.corr_slots2, lambda o: 0),
             opened2(onl2, cc.input_slots2, lambda o: 0)]
    assert np.array_equal(host.extract_gf2(cc, out["onl2"], out["pre2"], cols_t, omit_t).numpy(),
                          np.concatenate(want2))
    wantz = [np.concatenate([np.concatenate([src[s + off : s + off + 8, c] for s in slots])
                             if len(slots) else np.zeros(0, np.uint8)
                             for c, off in zip(cols, offs)])
             for src, slots, offs in ((onlz, cc.recon_slotsz, 8 * omit),
                                      (prez, cc.corr_slotsz, 0 * omit),
                                      (onlz, cc.input_slotsz, 0 * omit))]
    assert np.array_equal(host.extract_z64(cc, out["onlz"], out["prez"], cols_t, omit_t).numpy(),
                          np.concatenate(wantz))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("circuit", ["mixed_b2a", "mul_bench"])
def test_prove_uploads_are_pinned_on_the_card(circuit, cuda_device):
    """prove_batch_chunked on the card, three chunks: its proofs equal the
    CPU's for the same seeds, and the executor's witness columns and the
    extraction's indices (gathered slot rows included) go up from pinned
    memory, so that no upload waits for the chunk queued before it."""
    if circuit == "mixed_b2a":
        prog, w2, wz = mixed_b2a_circuit()
        jobs = [(w2, wz)] * 5
    else:
        prog, w2, _ = mul_bench_circuit(3_000)
        jobs = [(w2, [])] * 5
    card = TorchKKW(prog, device=cuda_device)
    seeds = np.random.RandomState(11).randint(0, 256, (len(jobs), 256, 16), dtype=np.uint8)
    got = card.prove_batch_chunked(jobs, seeds, chunk=2)
    rows = card.last_timings
    cpu = TorchKKW(prog, device=torch.device("cpu"), cc=card.cc)
    assert [p.to_bytes() for p in got] == [p.to_bytes() for p in
                                           cpu.prove_batch_chunked(jobs, seeds, chunk=2)]
    for name, row in rows.items():
        if base(name) in ("execute", "challenge"):
            assert row["h2d_bytes"] > 0, name
            assert row["h2d_pinned_bytes"] == row["h2d_bytes"], name
