"""SHA-256 as a GF(2) circuit (benchmark config 2: ~23k AND gates); the
port's copy of reverie_tpu/circuit/sha256.py.

Generates the one-block SHA-256 compression statement natively with the
circuit DSL: prove knowledge of a 512-bit padded message block whose SHA-256
digest equals a public value.  Validated against hashlib in tests.
"""

from __future__ import annotations

import struct
from typing import List, Sequence, Tuple

from .dsl import Builder
from .ir import CombineOp

_K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]

_H0 = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
       0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]


def _compress(b: Builder, w_words: List[List], h_in=None) -> List[List]:
    """One SHA-256 compression over 16 input words (LSB-first bitvecs) from
    hash state `h_in` (8 words; None = the IV) -- returns the 8 output hash
    words.  Chaining h across calls gives full Merkle-Damgard SHA-256 over
    arbitrary-length messages."""

    def sigma0(x):
        return b.xor_vec(b.xor_vec(b.rotr_vec(x, 7), b.rotr_vec(x, 18)), b.shr_vec(x, 3))

    def sigma1(x):
        return b.xor_vec(b.xor_vec(b.rotr_vec(x, 17), b.rotr_vec(x, 19)), b.shr_vec(x, 10))

    def big0(x):
        return b.xor_vec(b.xor_vec(b.rotr_vec(x, 2), b.rotr_vec(x, 13)), b.rotr_vec(x, 22))

    def big1(x):
        return b.xor_vec(b.xor_vec(b.rotr_vec(x, 6), b.rotr_vec(x, 11)), b.rotr_vec(x, 25))

    def ch(e, f, g):
        # g ^ (e & (f ^ g)) -- one AND per bit
        return b.xor_vec(g, b.and_vec(e, b.xor_vec(f, g)))

    def maj(x, y, z):
        # x ^ ((x^y) & (x^z)) -- one AND per bit
        return b.xor_vec(x, b.and_vec(b.xor_vec(x, y), b.xor_vec(x, z)))

    w = list(w_words)
    for t in range(16, 64):
        w.append(b.add_vec(b.add_vec(sigma1(w[t - 2]), w[t - 7]),
                           b.add_vec(sigma0(w[t - 15]), w[t - 16])))

    if h_in is None:
        h_in = [b.const_vec(v, 32) for v in _H0]
    a, bb, c, d, e, f, g, h = h_in
    for t in range(64):
        t1 = b.add_vec(b.add_vec(h, big1(e)),
                       b.add_vec(ch(e, f, g), b.add_vec(b.const_vec(_K[t], 32), w[t])))
        t2 = b.add_vec(big0(a), maj(a, bb, c))
        h, g, f = g, f, e
        e = b.add_vec(d, t1)
        d, c, bb = c, bb, a
        a = b.add_vec(t1, t2)

    return [b.add_vec(x, y) for x, y in zip([a, bb, c, d, e, f, g, h], h_in)]


def sha256_preimage_statement(digest: bytes) -> Tuple[List[CombineOp], int]:
    """Statement: prover knows a 512-bit padded block hashing to `digest`.

    Witness bits: the 512 block bits, ordered big-endian per 32-bit word
    (word 0 first, MSB of each word first -- matching how a byte string maps
    to SHA-256 words).  Returns (program, n_witness_bits).
    """
    assert len(digest) == 32
    b = Builder()
    w_words = []
    for _ in range(16):
        msb_first = b.input_vec(32)
        w_words.append(list(reversed(msb_first)))  # to LSB-first
    out = _compress(b, w_words)
    want = struct.unpack(">8I", digest)
    for word_bits, val in zip(out, want):
        for i in range(32):
            b.assert_equal(word_bits[i], (val >> i) & 1)
    return b.program(), b.n_inputs


def sha256_long_preimage_statement(
    digest: bytes, n_blocks: int
) -> Tuple[List[CombineOp], int]:
    """Statement: prover knows an `n_blocks`-block padded message hashing to
    `digest` -- full Merkle-Damgard SHA-256 over arbitrary-length messages
    (the hash state chains through every compression, so the circuit is both
    wide (~22.4k ANDs/block) and deep (~5.2k levels/block): the flagship
    workload for the streaming scan executor).  Witness bits: all blocks'
    512 bits each, word-major MSB-first (block_to_witness_bits per block,
    concatenated)."""
    assert len(digest) == 32 and n_blocks >= 1
    b = Builder()
    h = None
    for _ in range(n_blocks):
        w_words = []
        for _ in range(16):
            msb_first = b.input_vec(32)
            w_words.append(list(reversed(msb_first)))
        h = _compress(b, w_words, h)
    want = struct.unpack(">8I", digest)
    for word_bits, val in zip(h, want):
        for i in range(32):
            b.assert_equal(word_bits[i], (val >> i) & 1)
    return b.program(), b.n_inputs


def sha256_pad_one_block(message: bytes) -> bytes:
    """Pad a message of <= 55 bytes into a single 64-byte SHA-256 block."""
    assert len(message) <= 55
    bitlen = len(message) * 8
    block = message + b"\x80" + b"\x00" * (55 - len(message)) + struct.pack(">Q", bitlen)
    assert len(block) == 64
    return block


def sha256_pad_message(message: bytes) -> bytes:
    """Standard SHA-256 padding for any message length: returns the full
    padded byte string (a multiple of 64 bytes)."""
    bitlen = len(message) * 8
    padlen = (55 - len(message)) % 64
    return message + b"\x80" + b"\x00" * padlen + struct.pack(">Q", bitlen)


def block_to_witness_bits(block: bytes) -> List[bool]:
    """64-byte block -> 512 witness bits (word-major, MSB-first)."""
    words = struct.unpack(">16I", block)
    bits: List[bool] = []
    for w in words:
        bits.extend(bool((w >> (31 - i)) & 1) for i in range(32))
    return bits


def count_and_gates(program: Sequence[CombineOp]) -> int:
    from .ir import Kind, Op

    return sum(
        1
        for op in program
        if op.kind == Kind.GF2 and op.gate.op == Op.MUL
    )
