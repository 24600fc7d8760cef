"""The KKW random-tape PRG on the host: AES-128-CTR with zero IV and
Ctr128BE (reference src/crypto/prg.rs:13-38), and the seed expansion
(reference src/transcript/mod.rs:99-122).

The port's copy of reverie_tpu/crypto/prg.py (`keystream_batch`,
`expand_seeds`, `key_expand_batch`).
"""

from __future__ import annotations

import numpy as np

from ..params import KEY_SIZE, PLAYERS
from .native import get_lib


def keystream_batch(keys: np.ndarray, nbytes: int, start_block: int = 0) -> np.ndarray:
    """Batched keystream: keys shape (n, 16) uint8 -> (n, nbytes) uint8."""
    keys = np.ascontiguousarray(keys, dtype=np.uint8)
    n = keys.shape[0]
    assert keys.shape == (n, KEY_SIZE) and nbytes % 16 == 0
    out = np.empty((n, nbytes), dtype=np.uint8)
    get_lib().aes128_ctr_keystream_batch(keys.ctypes.data, start_block, out.ctypes.data, n, nbytes)
    return out


def expand_seeds(seeds: np.ndarray) -> np.ndarray:
    """(n, 16) rep seeds -> (n, PLAYERS, 16) player keys: each seed's flat
    128-byte keystream split in 8 (transcript/mod.rs:99-106; not a seed
    tree)."""
    seeds = np.ascontiguousarray(seeds, dtype=np.uint8)
    n = seeds.shape[0]
    ks = keystream_batch(seeds, KEY_SIZE * PLAYERS)
    return ks.reshape(n, PLAYERS, KEY_SIZE)


def key_expand_batch(keys: np.ndarray) -> np.ndarray:
    """(n, 16) AES keys -> (n, 11, 16) AES-128 round keys."""
    keys = np.ascontiguousarray(keys, dtype=np.uint8)
    n = keys.shape[0]
    out = np.empty((n, 11, 16), dtype=np.uint8)
    get_lib().aes128_key_expand_batch(keys.ctypes.data, out.ctypes.data, n)
    return out
