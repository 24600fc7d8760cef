"""The port's per-column BLAKE3 (reverie_tpu_torch blake3) against
reverie_tpu: the Pallas chunk kernel in interpret mode, the XLA chunk scan,
the XLA pair hash and the host C blake3.  Every output is bytes or u32
words: the tolerance is 0."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reverie_tpu.crypto import blake3_many
from reverie_tpu.crypto.kernels import blake3_jax as bj
from reverie_tpu.crypto.kernels.blake3_pallas import chunk_cvs_from_bytes
from reverie_tpu_torch.crypto.kernels import blake3 as b3


@pytest.fixture
def one_thread():
    """One intra-op torch thread while the test runs: its ops are small, and
    the suite runs in parallel workers, where a pool of threads per op
    costs more than the op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def absorb_blocks(T: int, block: int):
    """(start, stop) of the blocks of `block` bytes that make a stream of T
    bytes, the last one short."""
    return [(i, min(i + block, T)) for i in range(0, T, block)]


#: (T, absorb size, R, the hasher's bound in node CVs): T = 0, a partial
#: chunk, 2, 3 and 5 whole chunks, 5 chunks ragged, each absorbed in blocks
#: of 1, 1023, 1024 and 1025 bytes, at the three legs' R in turn; the bound
#: 2 or 3 nodes (the held CVs paired into the CV stack past it) or none
#: reached
HASHER_CASES = [(T, a, (256, 40, 216)[i % 3], (None, 2, 3)[i % 3 if T == 5120 else i % 2])
                for i, (T, a) in enumerate((T, a) for T in (0, 700, 2048, 3072, 5120, 4796)
                                           for a in (1, 1023, 1024, 1025))]


@pytest.mark.parametrize("T, block, R, nodes", HASHER_CASES)
def test_column_hasher_matches_hash_columns(one_thread, T, block, R, nodes):
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
def test_tree_levels_in_blocks_match_tree_reduce(one_thread, n, max_pairs):
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


def test_column_hasher_mixed_blocks_and_misuse(one_thread):
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
