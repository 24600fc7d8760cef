"""The port's GF(2) mask tape (reverie_tpu_torch aes_tape) against
reverie_tpu: the host builder `build_tapes` and the XLA bitsliced
`aes_jax.aes_ctr_tape_gf2` (the Pallas tape kernel's plain reference, held
to the kernel by tests/test_pallas_kernels.py).  Every output is bytes:
the tolerance is 0."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reverie_tpu.backend.tpu_host import build_tapes
from reverie_tpu.crypto import keystream_batch
from reverie_tpu.crypto.kernels import aes_jax as aj
from reverie_tpu_torch.crypto.kernels import aes_tape
from torch_threads import one_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")


def _keys_omit(R, with_omit, seed):
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, 256, (R, 8, 16), dtype=np.uint8)
    omit = rng.randint(0, 9, R).astype(np.uint8) if with_omit else None
    return keys, omit


def _port_tape(keys, omit, m2, start_block=0):
    om = None if omit is None else torch.from_numpy(omit)
    return aes_tape.aes_ctr_tape_gf2(aes_tape.round_keys(keys, CPU), m2, om,
                                     start_block).numpy()


@pytest.mark.parametrize("R", [256, 40, 216])
@pytest.mark.parametrize("with_omit", [False, True])
def test_tape_matches_build_tapes_and_aes_jax(R, with_omit):
    m2 = 3 * 128 - 37  # ragged final counter block
    keys, omit = _keys_omit(R, with_omit, seed=R + with_omit)
    got = _port_tape(keys, omit, m2)
    assert got.shape == (m2, R) and got.dtype == np.uint8
    want = build_tapes(keys, None if omit is None else omit.astype(np.int64), m2, 0)[0]
    np.testing.assert_array_equal(got, want)
    if with_omit:  # one XLA compile per R: the omit mask covers the no-omit lanes too
        mask = aj.lane_mask_from_omit(omit, R)
        xla = aj.aes_ctr_tape_gf2(
            aj.round_key_planes_device(jnp.asarray(keys.reshape(-1, 16))),
            aj.counter_planes_device(3), jnp.asarray(mask))
        np.testing.assert_array_equal(got, np.asarray(xla)[:m2])


def test_tape_start_block_window():
    """A window of the tape at a nonzero CTR block (streaming segments) is
    the same rows of the tape that starts at block 0; one counter above 2^32
    checks the 64-bit big-endian counter."""
    R, m2 = 40, 5 * 128
    keys, omit = _keys_omit(R, True, seed=7)
    full = _port_tape(keys, omit, m2)
    win = _port_tape(keys, omit, 2 * 128 + 5, start_block=2)
    np.testing.assert_array_equal(win, full[2 * 128 : 4 * 128 + 5])
    start = 2**32 + 3
    hi = _port_tape(keys, None, 128, start_block=start)
    ks = keystream_batch(keys.reshape(-1, 16), 16, start).reshape(R, 8, 16)
    bits = np.unpackbits(ks, axis=-1)  # (R, 8, 128)
    np.testing.assert_array_equal(hi, np.packbits(bits.transpose(2, 0, 1), axis=-1)[..., 0])


def test_textbook_aes_matches_fips197():
    """FIPS-197 appendix C.1 known answer through the plain version."""
    from reverie_tpu.crypto import key_expand_batch

    key = bytes(range(16))
    pt = bytes.fromhex("00112233445566778899aabbccddeeff")
    rk = torch.from_numpy(key_expand_batch(np.frombuffer(key, np.uint8)[None]))
    ct = aes_tape.aes_encrypt_ref(rk, torch.tensor(list(pt), dtype=torch.uint8)[None])
    assert bytes(ct[0, 0].tolist()).hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"


def test_empty_tape():
    keys, _ = _keys_omit(8, False, seed=1)
    assert _port_tape(keys, None, 0).shape == (0, 8)
