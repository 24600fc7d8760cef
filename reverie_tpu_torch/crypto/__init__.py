from .hashing import RandomOracle, blake3, blake3_many, blake3_xof
from .prg import expand_seeds, key_expand_batch, keystream_batch

__all__ = [
    "RandomOracle",
    "blake3",
    "blake3_many",
    "blake3_xof",
    "expand_seeds",
    "key_expand_batch",
    "keystream_batch",
]
