"""The port's per-column BLAKE3 (reverie_tpu_torch blake3) against
reverie_tpu: the Pallas chunk kernel in interpret mode, the XLA chunk scan,
the XLA hash and pair hash and the host C blake3; the chunk kernel's plan
and its staged read (blake3.plan, copies, read_offsets, model) run in torch;
the tail kernel's schedule (blake3_tail.plan, pieces, merge_order) run in torch; and the CPU
dispatch and argument checks of the tail's entry points
(csrc/blake3_tail.cu on the card, tests/test_torch_package.py).  Every output is bytes or u32 words:
the tolerance is 0."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reverie_tpu.crypto import blake3_many
from reverie_tpu.crypto.kernels import blake3_jax as bj
from reverie_tpu.crypto.kernels.blake3_pallas import chunk_cvs_from_bytes
from reverie_tpu_torch.crypto.kernels import blake3 as b3, blake3_tail
from blake3_cases import (CHUNK_CASES, CHUNK_WIDTHS, HASHER_CASES, LEG_LENGTHS, TAIL_LENGTHS,
                          TAIL_WIDTHS, absorb_blocks)
from torch_threads import one_thread  # noqa: F401  (autouse)


def _rand(shape, seed):
    return np.random.RandomState(seed).randint(0, 256, shape, dtype=np.uint8)


def _port_cvs(buf, n, base):
    return b3.chunk_cvs(torch.from_numpy(buf), n, base).numpy().view(np.uint32)


def test_chunk_cvs_matches_pallas_interpret():
    n, R, base = 3, 128, 5
    buf = _rand((n * 1024 + 100, R), seed=1)
    r0, r1 = chunk_cvs_from_bytes(jnp.asarray(buf), n, base, interpret=True)
    want = np.concatenate([np.asarray(r0), np.asarray(r1)])
    np.testing.assert_array_equal(_port_cvs(buf, n, base), want)


@pytest.mark.parametrize("R", [40, 216])
def test_chunk_cvs_matches_xla_indexed(R):
    n, base = 2, 11
    buf = _rand((n * 1024, R), seed=R)
    words = bj._bytes_to_words(jnp.asarray(buf)).reshape(n, 16, 16, R)
    r0, r1 = bj._chunk_cvs_indexed(words, base)
    want = np.concatenate([np.asarray(r0), np.asarray(r1)])
    np.testing.assert_array_equal(_port_cvs(buf, n, base), want)


@pytest.mark.parametrize("R", [40, 256])
@pytest.mark.parametrize("T", [0, 1, 1023, 1024, 3 * 1024, 3 * 1024 + 37])
def test_hash_columns_matches_host_blake3(T, R):
    buf = _rand((T + 9, R), seed=T + R)  # rows beyond T are ignored
    got = b3.hash_columns(torch.from_numpy(buf), T).numpy()
    want = blake3_many(np.ascontiguousarray(buf[:T].T))
    assert got.shape == (R, 32) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_hash_pair_columns_matches_xla():
    a, b = _rand((40, 32), seed=3), _rand((40, 32), seed=4)
    got = b3.hash_pair_columns(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(bj.hash_pair_columns(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, blake3_many(np.concatenate([a, b], axis=1)))


@pytest.mark.parametrize("T, block, R, nodes", HASHER_CASES)
def test_column_hasher_matches_hash_columns(T, block, R, nodes):
    """The incremental hash of a stream absorbed block by block equals
    hash_columns on the whole stream and the host C blake3 per column; the
    final chunk is never absorbed before finalize, and the held node CVs
    stay within the bound or the CV stack (one a height), none of them a
    view that keeps a paired level alive."""
    buf = torch.from_numpy(_rand((T, R), seed=T + block + R))
    held = (nodes or 1 << 20) * b3.CV_BYTES * R
    # the tree one or two parents at a time, or a level's all
    pairs = 1 if block == 1023 else 2 if block == 1025 else 1 << 20
    h = b3.ColumnHasher(T, R, torch.device("cpu"), held, pairs * b3.COMPRESS_BYTES * R)
    assert (h.max_nodes, h.max_pairs) == (nodes or 1 << 20, pairs)
    for lo, hi in absorb_blocks(T, block):
        h.absorb(buf[lo:hi])
        assert h.chunk_base <= max(0, h.n_chunks - 1) and 0 <= h.rem_len <= 1024
        held = [x.shape[1] for x in h.levels]
        assert sum(held) <= h.max_nodes or max(held) <= 1
        assert all(x.untyped_storage().nbytes() == x.nbytes for x in h.levels)
    got = h.finalize().numpy()
    np.testing.assert_array_equal(got, b3.hash_columns(buf, T).numpy())
    np.testing.assert_array_equal(got, blake3_many(np.ascontiguousarray(buf.numpy().T)))


@pytest.mark.parametrize("n", [2, 3, 5, 8, 13])
@pytest.mark.parametrize("max_pairs", [1, 2, 3])
def test_tree_levels_in_blocks_match_tree_reduce(n, max_pairs):
    """The tree of n whole chunks' CVs, its levels max_pairs parents at a
    time, equals a level's all at once and the host C blake3 of the chunks;
    so does the tree of a CV stack (the first k chunks paired with
    root=False) and the chunks after it."""
    R = 8
    buf = _rand((n * 1024, R), seed=n)
    cvs = b3.chunk_cvs(torch.from_numpy(buf), n)
    want = blake3_many(np.ascontiguousarray(buf.T))
    root = b3._rows_to_bytes(b3._tree_reduce([cvs], max_pairs))
    assert torch.equal(root, b3._rows_to_bytes(b3._tree_reduce([cvs])))
    np.testing.assert_array_equal(root.numpy(), want)
    for k in range(1, n):
        levels = [cvs[:, :k]]
        b3._tree_reduce(levels, max_pairs, root=False)
        assert max(x.shape[1] for x in levels) <= 1 and len(levels) == k.bit_length()
        levels[0] = torch.cat([levels[0], cvs[:, k:]], dim=1)
        np.testing.assert_array_equal(
            b3._rows_to_bytes(b3._tree_reduce(levels, max_pairs)).numpy(), want)


def test_column_hasher_mixed_blocks_and_misuse():
    """Blocks of mixed sizes (empty ones too) across chunk boundaries; a
    block past the stream's length and a finalize before its end raise."""
    T, R = 3 * 1024 + 5, 40
    buf = torch.from_numpy(_rand((T, R), seed=9))
    h = b3.ColumnHasher(T, R, torch.device("cpu"), 2 * b3.CV_BYTES * R, b3.COMPRESS_BYTES * R)
    cuts = [0, 0, 1000, 1000, 2047, 2049, 3072, T]
    for lo, hi in zip(cuts, cuts[1:]):
        h.absorb(buf[lo:hi])
    np.testing.assert_array_equal(h.finalize().numpy(), b3.hash_columns(buf, T).numpy())
    h = b3.ColumnHasher(100, R, torch.device("cpu"), 1 << 20, 1 << 20)
    h.absorb(buf[:60])
    with pytest.raises(ValueError):
        h.finalize()
    with pytest.raises(ValueError):
        h.absorb(buf[:41])


# -- the tail: the last chunk, the tree and the pair hashes ------------------
# (plain torch on the CPU, csrc/blake3_tail.cu on the card)


def _host_hashes(buf: np.ndarray, T: int) -> np.ndarray:
    if buf.shape[1] == 0:
        return np.zeros((0, 32), dtype=np.uint8)
    return blake3_many(np.ascontiguousarray(buf[:T].T))


@pytest.mark.parametrize("R", TAIL_WIDTHS)
@pytest.mark.parametrize("T", TAIL_LENGTHS)
def test_tail_matches_host_blake3(T, R):
    """hash_columns equals the host C blake3 per column at every width, and
    so does finalize_columns on each CV stack of the first k chunks
    (pair_levels, as ColumnHasher pairs its CVs) and the chunks after it;
    on the CPU no kernel is launched."""
    buf = _rand((T + 3, R), seed=7 * T + R)  # rows beyond T are ignored
    tbuf = torch.from_numpy(buf)
    want = _host_hashes(buf, T)
    n0 = (b3.LAUNCHES, blake3_tail.LAUNCHES)
    got = b3.hash_columns(tbuf, T).numpy()
    assert got.shape == (R, 32) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    n = max(1, -(-T // 1024))
    cvs = b3.chunk_cvs(tbuf, n - 1)
    for k in range(2, n):
        levels = [cvs[:, :k]]
        b3.pair_levels(levels)
        assert max(x.shape[1] for x in levels) <= 1 and len(levels) == k.bit_length()
        levels[0] = torch.cat([levels[0], cvs[:, k:]], dim=1)
        np.testing.assert_array_equal(
            b3.finalize_columns(levels, tbuf[(n - 1) * 1024 : T], T).numpy(), want)
    assert (b3.LAUNCHES, blake3_tail.LAUNCHES) == n0


@pytest.mark.parametrize("T", [0, 65, 2048, 4096 + 65])
def test_tail_matches_xla_hash_columns(T):
    """hash_columns equals reverie_tpu's XLA hash_columns (its tail chunk,
    tree and, for T = 0, blake3(b"")) at a shard's width."""
    buf = _rand((T + 5, 21), seed=T + 1)
    got = b3.hash_columns(torch.from_numpy(buf), T).numpy()
    want = np.asarray(bj.hash_columns(jnp.asarray(buf), T, pallas_ok=False))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("R", [256, 40, 216, 3, 22, 0])
def test_rep_hashes_match_reverie_tpu(R):
    """hash_rep_columns, H(H(hp2 || ho2) || H(hpz || hoz)), equals
    reverie_tpu's hash_pair_columns three times over (as TpuKKW._hash_fn
    pairs the four streams' hashes) and the host C blake3 per row, and
    hash_pair_columns its one pair; no kernel is launched on the CPU."""
    ins = [_rand((R, 32), seed=R + i) for i in range(4)]
    n0 = blake3_tail.LAUNCHES
    got = b3.hash_rep_columns(*map(torch.from_numpy, ins)).numpy()
    pair = b3.hash_pair_columns(torch.from_numpy(ins[0]), torch.from_numpy(ins[1])).numpy()
    assert got.shape == pair.shape == (R, 32) and blake3_tail.LAUNCHES == n0
    if R == 0:
        return
    h = lambda a, b: blake3_many(np.concatenate([a, b], axis=1))  # noqa: E731
    np.testing.assert_array_equal(pair, h(ins[0], ins[1]))
    np.testing.assert_array_equal(got, h(h(ins[0], ins[1]), h(ins[2], ins[3])))
    jp = lambda a, b: bj.hash_pair_columns(jnp.asarray(a), jnp.asarray(b))  # noqa: E731
    np.testing.assert_array_equal(got, np.asarray(jp(jp(ins[0], ins[1]), jp(ins[2], ins[3]))))


def test_tail_entry_points_check_their_arguments():
    """finalize_columns raises unless the levels hold the chunks before the
    last (on either device), and on a device neither CPU nor CUDA; the
    kernels' launchers take CUDA tensors only."""
    R = 8
    buf = torch.from_numpy(_rand((3000, R), seed=2))
    cvs = b3.chunk_cvs(buf, 2)
    with pytest.raises(ValueError, match="chunks"):
        b3.finalize_columns([cvs[:, :1]], buf[2048:], 3000)
    with pytest.raises(ValueError, match="chunks"):
        b3.finalize_columns([cvs], buf[:0], 0)
    with pytest.raises(ValueError, match="device"):
        b3.finalize_columns([cvs.to("meta")], buf[2048:].to("meta"), 3000)
    rows = torch.zeros((R, 32), dtype=torch.uint8)
    leg = [([cvs], buf[2048:], 952)] * 4
    for launch in (lambda: blake3_tail.finalize([cvs], buf[2048:], 952),
                   lambda: blake3_tail.stack([cvs]),
                   lambda: blake3_tail.leg(leg),
                   lambda: blake3_tail.pairs(rows, rows),
                   lambda: blake3_tail.pairs(rows, rows, rows, rows),
                   lambda: b3.hash_pair_columns(rows.to("meta"), rows.to("meta"))):
        with pytest.raises(ValueError, match="CUDA"):
            launch()


# -- the tail kernel's schedule: its piece cut and merge order in torch -----


def _jax_hashes(buf: np.ndarray, T: int) -> np.ndarray:
    return np.asarray(bj.hash_columns(jnp.asarray(buf), T, pallas_ok=False))


def _stream(tail):
    """A (levels, rem, total_len) stream as the kernel takes it: (levels,
    rem, the last chunk's bytes)."""
    return tail[0], tail[1], b3._last_chunk(tail[2])[1]


@pytest.mark.parametrize("T", TAIL_LENGTHS)
def test_tail_schedule_matches_reverie_tpu(T):
    """The kernel's schedule (the plan's pieces reduced, merged in
    merge_order's rounds, folded with the last chunk) on a stream at a
    shard's width equals reverie_tpu's hash_columns (its _tree_reduce) and
    the host C blake3; so it does on every CV stack of the first k chunks
    and the chunks after it (p0 = k)."""
    R = 5
    buf = _rand((T + 2, R), seed=3 * T + 1)
    want = _host_hashes(buf, T)
    np.testing.assert_array_equal(_jax_hashes(buf, T), want)
    tail = b3.stream_tail(torch.from_numpy(buf), T)
    out, hashes = blake3_tail.model([_stream(tail)])
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(hashes[0].numpy(), want)
    n = b3._last_chunk(T)[0]
    for k in range(1, n - 1):
        levels = [tail[0][0][:, :k].clone()]
        b3._tree_reduce(levels, root=False)
        levels[0] = torch.cat([levels[0], tail[0][0][:, k:]], dim=1)
        np.testing.assert_array_equal(
            blake3_tail.model([(levels, tail[1], b3._last_chunk(T)[1])])[0].numpy(), want)


@pytest.mark.parametrize("T, block, R, nodes", HASHER_CASES)
def test_tail_schedule_on_column_hasher_stacks(T, block, R, nodes):
    """The schedule on a ColumnHasher's levels (its CV stack at whatever
    offset p0 its bound left it, and level 0 after it) equals the host C
    blake3 per column."""
    buf = torch.from_numpy(_rand((T, R), seed=T + block + R + 1))
    held = (nodes or 1 << 20) * b3.CV_BYTES * R
    h = b3.ColumnHasher(T, R, torch.device("cpu"), held, b3.COMPRESS_BYTES * R)
    for lo, hi in absorb_blocks(T, block):
        h.absorb(buf[lo:hi])
    got = blake3_tail.model([_stream(h.tail())])[0].numpy()
    np.testing.assert_array_equal(got, _host_hashes(buf.numpy(), T))


def test_piece_cut_and_merge_order():
    """The kernel's closed-form piece (piece_at) is pieces()'s and
    piece_index its inverse, every piece aligned to its size and at most
    2^k nodes, the pieces tiling level 0; merge_order leaves the CV stack
    of the chunks (one node a set bit, highest first) after at most log2
    of the nodes rounds beyond the pieces' heights."""
    for p0 in range(0, 70, 3):
        for c0 in range(0, 90, 7):
            for k in range(0, 8):
                cut = blake3_tail.pieces(p0, c0, k)
                assert [blake3_tail.piece_at(p0, p0 + c0, k, i) for i in range(len(cut))] == cut
                assert [blake3_tail.piece_index(p0, p0 + c0, k, q) for q, _ in cut] == \
                    list(range(len(cut)))
                assert sum(1 << h for _, h in cut) == c0
                assert all(q % (1 << h) == 0 and h <= k for q, h in cut)
                stack = [(q, j) for q, j in
                         zip(np.cumsum([0] + [1 << j for j in range(63, -1, -1) if p0 >> j & 1]),
                             [j for j in range(63, -1, -1) if p0 >> j & 1])]
                items = stack + cut
                rounds, live = blake3_tail.merge_order(items)
                n = p0 + c0
                h = [x for _, x in items]
                for pairs in rounds:
                    for i, j in pairs:
                        assert h[i] == h[j]
                        h[i] += 1
                assert [h[i] for i in live] == [j for j in range(63, -1, -1) if n >> j & 1]
                assert len(rounds) <= max(1, n).bit_length()


@pytest.mark.parametrize("R", TAIL_WIDTHS + (2048, 16_384))
def test_tail_plan_lanes_and_warps(R):
    """The plan at each width: whole warps of at most 512 threads a block,
    a column's lanes (its items and one an input) within them, C adjacent
    columns (a power of two, at most 8) covering R, the grid at least 3/4
    of the SMs where R allows; at the GF(2) 1M-AND prove (two streams of
    977 chunks, R = 256) 2 columns a block, pieces of 32 nodes, 128 blocks
    of 160 threads."""
    gf2 = (blake3_tail.Shape(0, 0, 976, 578), blake3_tail.Shape(0, 0, 976, 576),
           blake3_tail.Shape(0, 0, 0, 0), blake3_tail.Shape(0, 0, 0, 0))
    sha = (blake3_tail.Shape(0, 0, 22, 625), None, blake3_tail.Shape(0, 0, 0, 0), None)
    for shapes in (gf2, sha, gf2[:1]):
        p = blake3_tail.plan(R, shapes)
        assert p.threads % 32 == 0 and p.C * p.slots <= p.threads <= blake3_tail.MAX_THREADS
        assert p.slots == sum(p.items) + len(shapes)
        assert p.C in (1, 2, 4, 8) and p.blocks * p.C >= R > (p.blocks - 1) * p.C
        assert p.blocks >= min(R, 99) or p.C == 1
        assert 0 <= p.k <= blake3_tail.MAX_PIECE
        assert p.items == tuple(0 if s is None else len(blake3_tail.pieces(0, s.c0, p.k))
                                for s in shapes)
    if R == 256:
        p = blake3_tail.plan(R, gf2)
        assert (p.C, p.k, p.items, p.threads, p.blocks) == (2, 5, (31, 31, 0, 0), 160, 128)


@pytest.mark.parametrize("sms,registers", [(132, 80), (66, 80), (114, 80), (132, 128)])
@pytest.mark.parametrize("R", (40, 256, 2048))
def test_tail_plan_follows_the_card(R, sms, registers):
    """The plan takes the card's SMs and the kernel's registers (a launch
    reads them, blake3_tail.card): C adjacent columns leave the grid at
    least 3/4 of the SMs where R allows, and fewer SMs take more columns a
    block; the plan stays whole warps within a block."""
    gf2 = (blake3_tail.Shape(0, 0, 976, 578), blake3_tail.Shape(0, 0, 976, 576),
           blake3_tail.Shape(0, 0, 0, 0), blake3_tail.Shape(0, 0, 0, 0))
    p = blake3_tail.plan(R, gf2, sms, registers)
    assert p.threads % 32 == 0 and p.C * p.slots <= p.threads <= blake3_tail.MAX_THREADS
    assert p.C == blake3_tail.columns_per_block(R, sms)
    assert p.blocks >= min(R, sms * 3 // 4) or p.C == 1
    if sms <= blake3_tail.SMS:
        assert p.C >= blake3_tail.plan(R, gf2).C
    if (R, sms) == (256, 66):
        assert p.C == 4


@pytest.mark.parametrize("lengths", LEG_LENGTHS)
@pytest.mark.parametrize("comm", [False, True])
def test_hash_leg_matches_reverie_tpu(lengths, comm):
    """hash_leg (the plain version on the CPU, no kernel launched) and the
    kernel's schedule equal reverie_tpu's hash_columns of the four streams
    and hash_pair_columns three times over (TpuKKW._hash_fn), with the
    online hashes computed or the committed ones given."""
    R = 6
    bufs = [_rand((T + 1, R), seed=T + 17 * i) for i, T in enumerate(lengths)]
    tails = [b3.stream_tail(torch.from_numpy(b), T) for b, T in zip(bufs, lengths)]
    jh = [jnp.asarray(_jax_hashes(b, T)) for b, T in zip(bufs, lengths)]
    legs = list(tails)
    if comm:
        given = [_rand((R, 32), seed=40 + i) for i in range(2)]
        legs[1], legs[3] = map(torch.from_numpy, given)
        jh[1], jh[3] = map(jnp.asarray, given)
    want = np.asarray(bj.hash_pair_columns(bj.hash_pair_columns(jh[0], jh[1]),
                                           bj.hash_pair_columns(jh[2], jh[3])))
    n0 = blake3_tail.LAUNCHES
    rep, ho2, hoz = b3.hash_leg(*legs)
    assert blake3_tail.LAUNCHES == n0
    np.testing.assert_array_equal(rep.numpy(), want)
    np.testing.assert_array_equal(ho2.numpy(), np.asarray(jh[1]))
    np.testing.assert_array_equal(hoz.numpy(), np.asarray(jh[3]))
    out, hashes = blake3_tail.model([x if isinstance(x, torch.Tensor) else _stream(x)
                                     for x in legs])
    np.testing.assert_array_equal(out.numpy(), want)
    if not comm:
        np.testing.assert_array_equal(hashes[1].numpy(), np.asarray(jh[1]))
        np.testing.assert_array_equal(hashes[3].numpy(), np.asarray(jh[3]))


# -- the chunk kernel's plan and staged read (csrc/blake3_chunks.cu) -------------


@pytest.mark.parametrize("sms, registers", [(132, 64), (132, 40), (114, 56), (66, 64)])
@pytest.mark.parametrize("R", CHUNK_WIDTHS)
def test_chunk_plan_covers_each_column_once(R, sms, registers):
    """At each width, chunk count and alignment, and on cards of other SMs
    and registers: the tiles' chunk groups and column tiles partition the
    chunks and the columns, one block a (group, column tile); a block's
    threads are whole warps, at most MAX_THREADS, and hold one (chunk,
    column) each of its tile; its ring fits a block's shared memory and an
    SM holds at least one; each stage's copies stay inside it."""
    for n in (1, 2, 21, 22, 30, 390, 976, 3125):
        for delta in (0, 1, 8, 15):
            p = b3.plan(R, n, delta, sms, registers)
            groups = -(-n // p.chunks)
            assert p.blocks == groups * p.col_tiles
            c0 = np.arange(groups) * p.chunks
            ch = np.minimum(p.chunks, n - c0)
            assert ch.min() >= 1 and ch.sum() == n and np.all(c0[1:] == c0[:-1] + ch[:-1])
            r0 = np.arange(p.col_tiles) * p.cols
            co = np.minimum(p.cols, R - r0)
            assert co.min() >= 1 and co.sum() == R and np.all(r0[1:] == r0[:-1] + co[:-1])
            for g, t in ((0, 0), (groups - 1, p.col_tiles - 1), (groups // 2, p.col_tiles // 2)):
                assert b3.tile(p, g * p.col_tiles + t) == (c0[g], ch[g], r0[t], co[t])
            assert p.threads % 32 == 0 and 32 <= p.threads <= b3.MAX_THREADS
            assert p.threads >= p.chunks * p.cols and p.threads // p.cols >= p.chunks
            assert 2 <= p.stages <= b3.MAX_STAGES
            assert p.smem == p.stages * p.chunks * p.chunk_stage + b3.BARRIER_BYTES
            assert p.smem <= b3.SMEM_PER_BLOCK
            assert 1 <= p.per_sm and p.per_sm * (p.smem + b3.SMEM_RESERVED) <= b3.SMEM_PER_SM
            for block in {0, p.blocks - 1}:
                for step in (0, 15):
                    spans = sorted((d, d + k) for d, _, k in b3.copies(p, block, step))
                    assert all(a % 16 == 0 and b <= p.chunks * p.chunk_stage for a, b in spans)
                    assert all(b <= c for (_, b), (c, _) in zip(spans, spans[1:]))


@pytest.mark.parametrize("delta", range(16))
def test_chunk_route_follows_width_and_alignment(delta):
    """The route follows R and the buffer's alignment: span for whole rows up
    to MAX_THREADS columns (at a compile-time pitch for 40 and 216), rows (a
    2-D copy a stage) for multiples of 16 on an aligned buffer, rows_shifted
    for any other buffer past MAX_THREADS (and past 2^31 - 1 rows of chunks,
    which a tensor copy's int32 row cannot reach); each 1-D copy moves a
    16-byte-aligned run whose first byte of the tile's lies delta into it
    (rows_shifted: each row's own offset; 144 bytes where R is a multiple of
    16), and a span chunk's stage holds delta + 64 R bytes, the next chunk's
    rows 16 * ceil(R / 16) bytes on, mod 128."""
    span = {1: "span", 3: "span", 4: "span", 18: "span", 21: "span", 22: "span",
            40: "span40", 216: "span216"}
    wide = {272: "rows", 320: "rows", 2048: "rows", 16_384: "rows"}
    for R, route in {**span, **wide, 300: "rows_shifted"}.items():
        if route == "rows" and delta:
            route = "rows_shifted"
        for n in (1, 30, 976):
            p = b3.plan(R, n, delta)
            assert b3.ROUTES[p.route] == route, (R, n, p.line())
            for step in (0, 7):
                cps = b3.copies(p, p.blocks - 1, step)
                assert all(src % 16 == 0 and k % 16 == 0 for _, src, k in cps)
            if route.startswith("span"):
                assert p.chunk_stage >= delta + 64 * R and p.chunk_stage % 16 == 0
                assert (p.chunk_stage - 16 * -(-R // 16)) % 128 == 0
                assert b3.read_offsets(p, 0)[0, 0, 0] == delta
            elif route == "rows_shifted" and R % 16 == 0:
                assert {k for _, _, k in b3.copies(p, 0, 0)} == {144}
                assert b3.read_offsets(p, 0)[0, 0, 1] == b3.ROW_PITCH + delta
            elif route == "rows":
                assert len(b3.copies(p, 0, 0)) == 64 and b3.read_offsets(p, 0)[0, 1, 1] == 129
    p = b3.plan(256, 976, delta)
    assert b3.ROUTES[p.route] == ("rows" if delta == 0 else "span"), p.line()
    # past 2^31 - 1 rows of chunks a tensor copy's int32 row cannot reach
    for R, route in ((256, "span"), (2048, "rows_shifted")):
        assert b3.ROUTES[b3.plan(R, 2**21, delta).route] == route


@pytest.mark.parametrize("R", [3, 40, 216])
def test_chunk_model_matches_reverie_tpu(R):
    """The staged read modelled in torch (stages filled by the kernel's
    copies, words assembled from its read offsets, the plain compression),
    at the plan and with buffers 0, 5 and 8 bytes past a 16-byte boundary,
    equals chunk_cvs_ref and reverie_tpu's Pallas chunk kernel in interpret
    mode (chunk base below 2^31: the Pallas kernel takes an int32 base)."""
    n, base = 3 if R < 200 else 2, 9
    buf = _rand((n * 1024 + 7, R), seed=R + 1)
    r0, r1 = chunk_cvs_from_bytes(jnp.asarray(buf), n, base, interpret=True)
    want = np.concatenate([np.asarray(r0), np.asarray(r1)])
    np.testing.assert_array_equal(_port_cvs(buf, n, base), want)
    for delta in (0, 5, 8):
        got = b3.model(torch.from_numpy(buf), n, base, b3.plan(R, n, delta))
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("R, n, base, delta", [c for c in CHUNK_CASES if c[0] * c[1] <= 1200])
def test_chunk_model_on_every_route(R, n, base, delta):
    """The model at the kernel's cases (each route, alignments, one chunk,
    chunk bases crossing 2^32), at the plan and at the span route's other
    tiles and runtime pitch, equals chunk_cvs_ref."""
    buf = torch.from_numpy(_rand((n * 1024 + 3, R), seed=R * n + delta))
    want = b3.chunk_cvs_ref(buf, n, base)
    plans = [b3.plan(R, n, delta)]
    if R <= b3.MAX_THREADS:
        plans += [b3.plan_at(R, n, delta, 0, ct) for ct in {1, 2, b3.MAX_THREADS // R}]
    for p in plans:
        assert torch.equal(b3.model(buf, n, base, p), want), p.line()
