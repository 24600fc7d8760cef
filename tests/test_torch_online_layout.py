"""The verifier's online openings, rep-major on the host (host.online_streams)
and turned to (record, rep) on the device (host.online_inputs): every
VERIFY_ONL input byte-equal, in shape, dtype and layout, to the column-stacked
host layout it replaced, kept here as the oracle (`_old_*`), over GF(2) and
z64 streams of every length, omits that differ between the domains, segment
windows at bit offsets, and shard slices; verify_many's verdicts over good and
tampered proofs; the onl_inject row's copied and pinned bytes.  The `cuda`
tests run on the card only."""

import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from reverie_tpu_torch import TorchKKW
from reverie_tpu_torch.backend import host
from reverie_tpu_torch.circuit.builders import mul_bench_circuit
from reverie_tpu_torch.proof.container import OpenOnline
from torch_threads import one_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")


# -- the oracle: the column-stacked layout as the port had it ----------------


def _old_stack_streams(streams, nb):
    out = np.zeros((nb, len(streams)), dtype=np.uint8)
    for r, s in enumerate(streams):
        n = min(len(s), nb)
        out[:n, r] = np.frombuffer(s[:n], dtype=np.uint8)
    return out


def _old_u64s_from_stream(stream, n):
    words = np.frombuffer(stream[: len(stream) // 8 * 8], dtype="<i8")
    out = np.zeros(n, dtype=np.int64)
    k = min(n, len(words))
    out[:k] = words[:k]
    return out


def _old_online_streams(openings2, openingsz, counts):
    out = {"omit": np.array([o.omit for o in openings2], dtype=np.int64),
           "omitz": np.array([o.omit for o in openingsz], dtype=np.int64)}
    for name, field, count, _ in host.ONLINE_RECORDS:
        n = getattr(counts, count)
        if name.endswith("2"):
            out[name] = _old_stack_streams([getattr(o, field) for o in openings2],
                                           host.packed_len(n))
        else:
            out[name] = np.stack([_old_u64s_from_stream(getattr(o, field), n)
                                  for o in openingsz], axis=1)
    return out


def _old_unpack_window(packed, base, n, device):
    lo, hi = base // 8, (base + n + 7) // 8
    off = base - 8 * lo
    return host._unpack_bits(torch.from_numpy(packed[lo:hi]).to(device), off + n)[off:]


def _old_online_inputs(streams, cc, device, seg=None):
    inj = {}
    for name, _, count, first in host.ONLINE_RECORDS:
        n, base = getattr(cc, count), 0 if seg is None else getattr(seg, first)
        if name.endswith("2"):
            inj[name] = _old_unpack_window(streams[name], base, n, device)
        else:
            inj[name] = torch.from_numpy(streams[name][base : base + n]).to(device)
    shift = torch.as_tensor((7 - streams["omit"]).astype(np.uint8), device=device)
    onehot = (torch.arange(8, device=device)[:, None]
              == torch.as_tensor(streams["omitz"], device=device)[None, :]).to(torch.int64)
    inj["re2"] = inj["re2"] << shift[None, :]
    inj["rez"] = inj["rez"][:, None, :] * onehot
    return inj


def _old_lanes_of(arrays, lanes):
    return {k: np.ascontiguousarray(v[..., lanes]) for k, v in arrays.items()}


# -- openings ------------------------------------------------------------------

COUNT = {"co2": "n_corrs2", "in2": "n_inputs2", "re2": "n_recons2",
         "coz": "n_corrsz", "inz": "n_inputsz", "rez": "n_reconsz"}
#: record counts of the streams: whole bytes, a remainder, none
TOTALS = dict(n_corrs2=61, n_inputs2=16, n_recons2=83, n_corrsz=5, n_inputsz=0, n_reconsz=7)


def _full_len(name, n):
    """The bytes a proof holds for n records: the packed length with its
    remainder byte (GF(2)), 8 a word (z64)."""
    return host.packed_len(n) if name.endswith("2") else 8 * n


def _length(kind, full, r, rng):
    """A rep's stream length of `kind`: full, short (not whole words),
    long (extra bytes), empty, or ragged (each rep its own)."""
    if kind == "ragged":
        kind = ("full", "short", "long", "empty")[r % 4]
    return {"full": full, "short": full // 2 + 3 if full > 8 else max(full - 1, 0),
            "long": full + 1 + rng.randint(0, 12), "empty": 0}[kind]


def _openings(R, totals, kinds, seed, omits=None):
    """R GF(2) and R z64 openings of random stream bytes; kinds maps each
    stream (COUNT's names) to a length kind; omits (R, 2) or random ones."""
    rng = np.random.RandomState(seed)
    if omits is None:
        omits = np.stack([rng.randint(0, 8, R)] * 2, axis=1)
    field = {name: f for name, f, _, _ in host.ONLINE_RECORDS}
    doms = []
    for d, suffix in enumerate("2z"):
        ops = []
        for r in range(R):
            kw = {}
            for name in COUNT:
                if name.endswith(suffix):
                    full = _full_len(name, totals[COUNT[name]])
                    kw[field[name]] = rng.bytes(_length(kinds.get(name, "full"), full, r, rng))
            ops.append(OpenOnline(omit=int(omits[r, d]), seeds=bytes(128), **kw))
        doms.append(ops)
    return doms


def _assert_same(new, old):
    assert set(new) == set(old)
    for name in old:
        a, b = new[name], old[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.is_contiguous() == b.is_contiguous(), name
        assert torch.equal(a, b), name


def _both(on2, onz, totals, cc, lanes=None, seg=None):
    """online_inputs of the new path and of the oracle on one slice."""
    T = SimpleNamespace(**totals)
    new, old = host.online_streams(on2, onz, T), _old_online_streams(on2, onz, T)
    lanes = slice(0, len(on2)) if lanes is None else lanes
    return (host.online_inputs(host._lanes_of(new, lanes), cc, CPU, seg),
            _old_online_inputs(_old_lanes_of(old, lanes), cc, CPU, seg))


# -- the cases -------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["full", "short", "long", "empty", "ragged"])
@pytest.mark.parametrize("domain", ["2", "z"])
def test_inputs_equal_the_column_layout(domain, kind):
    """Each of a domain's streams of one length kind, the other domain's
    full: every executor input equal to the column-stacked layout's."""
    kinds = {name: kind for name in COUNT if name.endswith(domain)}
    on2, onz = _openings(40, TOTALS, kinds, seed=len(kind) + ord(domain))
    _assert_same(*_both(on2, onz, TOTALS, SimpleNamespace(**TOTALS)))


@pytest.mark.parametrize("omitz", ["shifted", "none_omitted", "one_off"])
def test_domains_with_different_omits(omitz):
    """A malformed proof's two domains omit different players (z64 8: no
    player omitted): the recon shift and the one-hot follow each its own."""
    R = 21
    rng = np.random.RandomState(5)
    om2 = rng.randint(0, 8, R)
    omz = {"shifted": (om2 + 3) % 8, "none_omitted": np.full(R, 8),
           "one_off": np.where(np.arange(R) == 7, (om2 + 1) % 8, om2)}[omitz]
    on2, onz = _openings(R, TOTALS, {}, seed=6, omits=np.stack([om2, omz], axis=1))
    new = host.online_streams(on2, onz, SimpleNamespace(**TOTALS))
    assert np.array_equal(new["omit"], om2) and np.array_equal(new["omitz"], omz)
    _assert_same(*_both(on2, onz, TOTALS, SimpleNamespace(**TOTALS)))


# segment windows, as StreamingKKW takes them: (first record, count) of each
# GF(2) stream and of the z64 ones; bases not a multiple of 8, empty ones
WINDOWS = [
    dict(cor0=3, n_corrs2=13, inp0=0, n_inputs2=16, rec0=13, n_recons2=3,
         corz0=1, n_corrsz=2, inpz0=0, n_inputsz=0, recz0=2, n_reconsz=5),
    dict(cor0=16, n_corrs2=9, inp0=5, n_inputs2=11, rec0=77, n_recons2=6,
         corz0=0, n_corrsz=5, inpz0=0, n_inputsz=0, recz0=0, n_reconsz=7),
    dict(cor0=60, n_corrs2=1, inp0=16, n_inputs2=0, rec0=0, n_recons2=83,
         corz0=5, n_corrsz=0, inpz0=0, n_inputsz=0, recz0=6, n_reconsz=1),
    dict(cor0=5, n_corrs2=27, inp0=9, n_inputs2=7, rec0=41, n_recons2=40,
         corz0=3, n_corrsz=1, inpz0=0, n_inputsz=0, recz0=1, n_reconsz=3),
]


@pytest.mark.parametrize("kind", ["full", "ragged"])
@pytest.mark.parametrize("w", range(len(WINDOWS)))
def test_segment_windows(w, kind):
    """A segment's window of each stream (a column range of the rep-major
    rows), at bit offsets: equal to the oracle's window."""
    win = WINDOWS[w]
    seg = SimpleNamespace(**{k: v for k, v in win.items() if not k.startswith("n_")})
    cc = SimpleNamespace(**{k: v for k, v in win.items() if k.startswith("n_")})
    on2, onz = _openings(40, TOTALS, dict.fromkeys(COUNT, kind), seed=10 + w)
    _assert_same(*_both(on2, onz, TOTALS, cc, seg=seg))


# shard slices, as lanes.split cuts R: uneven, and an empty one
SHARDS = {"uneven": [(0, 13), (13, 27), (27, 40)], "one_rep": [(0, 1), (1, 40)],
          "empty": [(0, 0), (0, 40), (40, 40)], "ragged_3": [(0, 3), (3, 4), (4, 22)]}


@pytest.mark.parametrize("cut", list(SHARDS))
def test_shard_slices(cut):
    """Each shard's rows of the rep-major arrays (a contiguous block) give
    the inputs of the oracle's column slice, whole and in a window."""
    on2, onz = _openings(40, TOTALS, dict.fromkeys(COUNT, "ragged"), seed=3)
    win = WINDOWS[3]
    seg = SimpleNamespace(**{k: v for k, v in win.items() if not k.startswith("n_")})
    cc = SimpleNamespace(**{k: v for k, v in win.items() if k.startswith("n_")})
    for lo, hi in SHARDS[cut]:
        _assert_same(*_both(on2, onz, TOTALS, SimpleNamespace(**TOTALS), slice(lo, hi)))
        _assert_same(*_both(on2, onz, TOTALS, cc, slice(lo, hi), seg))


def test_lanes_are_views_of_the_rows():
    """A shard's arrays are views of the rows (no host copy), each
    contiguous."""
    on2, onz = _openings(40, TOTALS, {}, seed=4)
    streams = host.online_streams(on2, onz, SimpleNamespace(**TOTALS))
    mine = host._lanes_of(streams, slice(13, 27))
    for name in COUNT:
        assert mine[name].is_contiguous() and mine[name].shape[0] == 14
        assert mine[name].data_ptr() == streams[name][13].data_ptr()
    assert mine["omits"].is_contiguous()
    assert np.shares_memory(mine["omit"], streams["omits"].numpy())


def test_inject_row_counts_the_copied_bytes():
    """The phase that calls online_inputs counts the bytes handed to the
    device: each stream's window and the omits; none pinned off CUDA."""
    on2, onz = _openings(40, TOTALS, {}, seed=8)
    streams = host.online_streams(on2, onz, SimpleNamespace(**TOTALS))
    timer = host.PhaseTimer([CPU])
    with timer.phase("onl_inject"):
        host.online_inputs(streams, SimpleNamespace(**TOTALS), CPU)
    with timer.phase("onl_tape"):
        pass
    rows = timer.report()
    want = sum(streams[name].numel() * streams[name].element_size() for name in COUNT)
    assert rows["onl_inject"]["h2d_bytes"] == want + 40 * 2 * 8
    assert rows["onl_inject"]["h2d_pinned_bytes"] == 0
    assert rows["onl_tape"]["h2d_bytes"] == 0 == rows["onl_tape"]["h2d_pinned_bytes"]


# -- verify_many over good and tampered proofs -----------------------------------


def _tampered(proof, i):
    """A copy with one bit of an opened rep's stream flipped (rep and
    stream chosen by i)."""
    bad = copy.deepcopy(proof)
    o = bad.gf2.online[(7 * i + 3) % len(bad.gf2.online)]
    field = ("recons", "corrs")[i % 2]
    s = bytearray(getattr(o, field))
    s[len(s) // 2] ^= 0x10
    setattr(o, field, bytes(s))
    return bad


def _alternating(kkw, wit2, witz, n):
    """n proofs of distinct seeds, every second one tampered."""
    proofs = []
    for i in range(n):
        seeds = np.random.RandomState(100 + i).randint(0, 256, (256, 16), dtype=np.uint8)
        p = kkw.prove(wit2, witz, seeds=seeds)
        proofs.append(_tampered(p, i) if i % 2 else p)
    return proofs


def test_verify_many_good_and_tampered():
    """verify_many of proofs in turn good and tampered: each verdict equal
    to verify's, True for the good ones; each onl_inject row counts its
    proof's openings."""
    prog, wit2, witz = mul_bench_circuit(40)
    kkw = TorchKKW(prog, device=CPU)
    proofs = _alternating(kkw, wit2, witz, 4)
    got = kkw.verify_many(proofs)
    rows = kkw.last_timings
    assert got == [kkw.verify(p) for p in proofs] == [True, False, True, False]
    for i in range(4):
        assert rows[f"onl_inject[{i}]"]["h2d_bytes"] > 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_verify_many_on_the_card_matches_the_cpu(cuda_device):
    """One verify_many of 8 proofs of one circuit on the card, in turn good
    and tampered, each proof's openings in a pinned buffer of its own while
    the one before is still queued: verdicts equal TorchKKW(device="cpu")'s,
    and every onl_inject row copied its bytes from pinned memory."""
    prog, wit2, witz = mul_bench_circuit(20_000)
    card = TorchKKW(prog, device=cuda_device)
    proofs = _alternating(card, wit2, witz, 8)
    got = card.verify_many(proofs)
    rows = card.last_timings
    cpu = TorchKKW(prog, device=CPU, cc=card.cc)
    assert got == [cpu.verify(p) for p in proofs]
    assert got == [True, False] * 4
    for i in range(8):
        row = rows[f"onl_inject[{i}]"]
        assert row["h2d_bytes"] > 20_000 // 8 * 40
        assert row["h2d_pinned_bytes"] == row["h2d_bytes"]
