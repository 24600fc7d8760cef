"""blake3 hashing + the Fiat-Shamir random oracle (host C).

The port's copy of reverie_tpu/crypto/hashing.py (`blake3`, `blake3_xof`,
`blake3_many`, `RandomOracle`): counterparts of the reference's hash
wrappers (src/crypto/hash.rs) and `RandomOracle` (src/crypto/ro.rs:3-21).
The reference's BufferedHasher only buffers bytes before feeding blake3, so
one-shot hashing of the accumulated transcript is the same digest.
"""

from __future__ import annotations

import numpy as np

from ..params import HASH_SIZE
from .native import get_lib


def _bytes_arg(data: bytes):
    buf = np.frombuffer(data, dtype=np.uint8) if data else np.empty(0, dtype=np.uint8)
    return (buf.ctypes.data if len(buf) else None), len(buf)


def blake3(data: bytes) -> bytes:
    out = np.empty(HASH_SIZE, dtype=np.uint8)
    get_lib().blake3_hash(*_bytes_arg(data), out.ctypes.data)
    return out.tobytes()


def blake3_xof(data: bytes, outlen: int) -> bytes:
    out = np.empty(outlen, dtype=np.uint8)
    get_lib().blake3_xof(*_bytes_arg(data), out.ctypes.data, outlen)
    return out.tobytes()


def blake3_many(data: np.ndarray) -> np.ndarray:
    """Hash n equal-length rows: (n, length) uint8 -> (n, 32) uint8."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n, length = data.shape
    out = np.empty((n, HASH_SIZE), dtype=np.uint8)
    get_lib().blake3_hash_many(data.ctypes.data, n, length, out.ctypes.data)
    return out


class RandomOracle:
    """blake3 XOF seeded with `blake3(ctx || 0x00 || input)` keyed stream
    (reference crypto/ro.rs:8-20).  `fill` draws successive bytes."""

    def __init__(self, ctx: str, data: bytes):
        self._input = ctx.encode() + b"\x00" + data
        self._consumed = 0

    def fill(self, n: int) -> bytes:
        # Re-derive the stream prefix each call; draws are tiny (16B each).
        end = self._consumed + n
        stream = blake3_xof(self._input, end)
        out = stream[self._consumed : end]
        self._consumed = end
        return out
