"""Knowledge of a one-block message whose SHA-256 digest the program asserts:
the MPC-in-the-head signature statement of KKW 2018 (eprint 2018/475), one
key a signer, a fresh proof a signature.  The message, the signer's key, is
`key_bytes` bytes drawn from the run's seed, so its program is compiled once
a run.

Frozen copy of reverie_tpu_torch.circuit.sha256.sha256_preimage_statement
and the constant-folding builder of reverie_tpu_torch.circuit.dsl (the same
gates in the same order, so the same program file)."""

from __future__ import annotations

import hashlib
import struct

import numpy as np

from kkwbench.program import ADD, ADDC, ASSERT_ZERO, GF2, INPUT, MUL, Statement, from_rows

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


class _Builder:
    """GF(2) gates with constant folding: a bit is an int 0/1 (a constant)
    or ("w", index) (a wire)."""

    def __init__(self) -> None:
        self.rows = []
        self.next_wire = 0

    def _fresh(self) -> int:
        self.next_wire += 1
        return self.next_wire - 1

    def input(self):
        w = self._fresh()
        self.rows.append((GF2, INPUT, w, 0, 0, 0))
        return ("w", w)

    def xor(self, a, b):
        if isinstance(a, int) and isinstance(b, int):
            return (a ^ b) & 1
        if isinstance(a, int):
            a, b = b, a
        if isinstance(b, int):
            if b & 1 == 0:
                return a
            w = self._fresh()
            self.rows.append((GF2, ADDC, w, a[1], 0, 1))
            return ("w", w)
        w = self._fresh()
        self.rows.append((GF2, ADD, w, a[1], b[1], 0))
        return ("w", w)

    def and_(self, a, b):
        if isinstance(a, int) and isinstance(b, int):
            return a & b & 1
        if isinstance(a, int):
            a, b = b, a
        if isinstance(b, int):
            return a if (b & 1) else 0
        w = self._fresh()
        self.rows.append((GF2, MUL, w, a[1], b[1], 0))
        return ("w", w)

    def assert_zero(self, a) -> None:
        if isinstance(a, int):
            if a & 1:
                raise ValueError("asserting constant one")
            return
        self.rows.append((GF2, ASSERT_ZERO, 0, a[1], 0, 0))

    def xor_vec(self, a, b):
        return [self.xor(x, y) for x, y in zip(a, b)]

    def and_vec(self, a, b):
        return [self.and_(x, y) for x, y in zip(a, b)]

    @staticmethod
    def rotr(a, n):
        k = len(a)
        return [a[(i + n % k) % k] for i in range(k)]

    @staticmethod
    def shr(a, n):
        return [a[i + n] if i + n < len(a) else 0 for i in range(len(a))]

    def add_vec(self, a, b):
        """Ripple-carry addition mod 2^n, one AND a bit."""
        out, carry = [], 0
        for i in range(len(a)):
            out.append(self.xor(self.xor(a[i], b[i]), carry))
            if i + 1 < len(a):
                ac = self.xor(a[i], carry)
                bc = self.xor(b[i], carry)
                carry = self.xor(self.and_(ac, bc), carry)
        return out


def _compress(b: _Builder, w):
    def x3(p, q, r):
        return b.xor_vec(b.xor_vec(p, q), r)

    def sigma0(x):
        return x3(b.rotr(x, 7), b.rotr(x, 18), b.shr(x, 3))

    def sigma1(x):
        return x3(b.rotr(x, 17), b.rotr(x, 19), b.shr(x, 10))

    def big0(x):
        return x3(b.rotr(x, 2), b.rotr(x, 13), b.rotr(x, 22))

    def big1(x):
        return x3(b.rotr(x, 6), b.rotr(x, 11), b.rotr(x, 25))

    def ch(e, f, g):
        return b.xor_vec(g, b.and_vec(e, b.xor_vec(f, g)))

    def maj(x, y, z):
        return b.xor_vec(x, b.and_vec(b.xor_vec(x, y), b.xor_vec(x, z)))

    def const(v):
        return [(v >> i) & 1 for i in range(32)]

    w = list(w)
    for t in range(16, 64):
        w.append(b.add_vec(b.add_vec(sigma1(w[t - 2]), w[t - 7]),
                           b.add_vec(sigma0(w[t - 15]), w[t - 16])))
    h_in = [const(v) for v in _H0]
    a, bb, c, d, e, f, g, h = h_in
    for t in range(64):
        t1 = b.add_vec(b.add_vec(h, big1(e)), b.add_vec(ch(e, f, g), b.add_vec(const(_K[t]), w[t])))
        t2 = b.add_vec(big0(a), maj(a, bb, c))
        h, g, f = g, f, e
        e = b.add_vec(d, t1)
        d, c, bb = c, bb, a
        a = b.add_vec(t1, t2)
    return [b.add_vec(x, y) for x, y in zip([a, bb, c, d, e, f, g, h], h_in)]


def statement_rows(digest: bytes) -> list:
    """The program's rows: 512 witness inputs (word-major, most significant
    bit first), the compression, and an AssertZero a digest bit."""
    b = _Builder()
    words = [list(reversed([b.input() for _ in range(32)])) for _ in range(16)]
    out = _compress(b, words)
    for bits, val in zip(out, struct.unpack(">8I", digest)):
        for i in range(32):
            b.assert_zero(b.xor(bits[i], (val >> i) & 1))
    return b.rows


def pad_one_block(message: bytes) -> bytes:
    assert len(message) <= 55
    return (message + b"\x80" + b"\x00" * (55 - len(message))
            + struct.pack(">Q", 8 * len(message)))


def block_bits(block: bytes) -> np.ndarray:
    """64-byte block -> (512,) uint8 witness bits, word-major, MSB first."""
    return np.unpackbits(np.frombuffer(block, dtype=np.uint8))


def make(args: dict, rng: np.random.Generator) -> Statement:
    key = rng.bytes(int(args["key_bytes"]))
    prog = from_rows(statement_rows(hashlib.sha256(key).digest()))
    bits = block_bits(pad_one_block(key))

    def witnesses(r: np.random.Generator, count: int) -> np.ndarray:
        # one key: every signature proves the same preimage
        return np.tile(bits, (count, 1))

    return Statement(prog, witnesses)
