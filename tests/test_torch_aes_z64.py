"""The port's Z_2^64 mask tape (reverie_tpu_torch aes_tape_z64) against
reverie_tpu: the host builder `build_tapes` and the XLA bitsliced
`aes_jax.aes_ctr_tape_z64_chunked` (the Pallas z64 tape kernel's plain
reference), each as u32 (lo, hi) pairs joined into int64.  Every output is
a 64-bit word: the tolerance is 0."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reverie_tpu.backend.tpu_host import build_tapes
from reverie_tpu.crypto import keystream_batch
from reverie_tpu.crypto.kernels import aes_jax as aj
from reverie_tpu_torch.crypto.kernels import aes_tape, aes_tape_z64
from torch_threads import one_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")


def _keys_omit(R, with_omit, seed):
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, 256, (R, 8, 16), dtype=np.uint8)
    omit = rng.randint(0, 9, R).astype(np.uint8) if with_omit else None
    return keys, omit


def _port_tape(keys, omit, mz, start_block=0):
    om = None if omit is None else torch.from_numpy(omit)
    return aes_tape_z64.aes_ctr_tape_z64(aes_tape.round_keys(keys, CPU), mz, om,
                                         start_block).numpy()


def _join(lo, hi):
    lo, hi = np.asarray(lo).astype(np.uint64), np.asarray(hi).astype(np.uint64)
    return (lo | (hi << np.uint64(32))).view(np.int64)


@pytest.mark.parametrize("R", [256, 40, 216])
@pytest.mark.parametrize("with_omit", [False, True])
def test_z64_tape_matches_build_tapes_and_aes_jax(R, with_omit):
    mz = 2 * 64 + 37  # odd: the last block's second word is cut
    keys, omit = _keys_omit(R, with_omit, seed=R + with_omit)
    got = _port_tape(keys, omit, mz)
    assert got.shape == (mz, 8, R) and got.dtype == np.int64
    _, lo, hi = build_tapes(keys, None if omit is None else omit.astype(np.int64), 0, mz)
    np.testing.assert_array_equal(got, _join(lo, hi))
    if with_omit:  # one XLA compile per R: the omit mask covers the no-omit lanes too
        keys_pm = np.ascontiguousarray(keys.transpose(1, 0, 2)).reshape(-1, 16)
        xlo, xhi = aj.aes_ctr_tape_z64_chunked(
            aj.round_key_planes_device(jnp.asarray(keys_pm)),
            aj.counter_planes_device((mz + 1) // 2),
            jnp.asarray(aj.lane_mask_raw_pm(omit, R)))
        np.testing.assert_array_equal(got, _join(xlo, xhi)[:mz])
        players = np.arange(8)[None, :, None]
        assert not (got * (players == omit[None, None, :])).any()


def test_z64_tape_start_block_window():
    """A window at a nonzero CTR block (streaming segments) is the same rows
    of the tape that starts at block 0; one counter above 2^32 checks the
    64-bit big-endian counter."""
    R, mz = 40, 20
    keys, omit = _keys_omit(R, True, seed=7)
    full = _port_tape(keys, omit, mz)
    win = _port_tape(keys, omit, 9, start_block=3)
    np.testing.assert_array_equal(win, full[6:15])
    start = 2**32 + 3
    hi = _port_tape(keys, None, 4, start_block=start)
    ks = keystream_batch(keys.reshape(-1, 16), 32, start).reshape(R, 8, 32)
    words = np.ascontiguousarray(ks).view("<i8")  # (R, 8, 4)
    np.testing.assert_array_equal(hi, words.transpose(2, 1, 0))


def test_empty_z64_tape():
    keys, _ = _keys_omit(8, False, seed=1)
    assert _port_tape(keys, None, 0).shape == (0, 8, 8)
