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
