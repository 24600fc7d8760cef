"""BLAKE3 (the BLAKE3 paper and its reference implementation), plain.

`hash_rows` hashes each row of a (rows, length) uint8 tensor in PyTorch on
any device, every row's chunks and tree nodes one vector operation a step
(32-bit words held in int64).  `hash_bytes` and `xof` are pure Python, for
the few short inputs a proof hashes on the host (the commitment's challenge
stream)."""

from __future__ import annotations

import struct
from typing import List

import torch

IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)
PERM = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)
CHUNK_START, CHUNK_END, PARENT, ROOT = 1, 2, 4, 8
CHUNK = 1024
MASK = 0xFFFFFFFF
#: chunk lanes a pass of hash_rows compresses
LANES_A_PASS = 1 << 20


def _g(v, a, b, c, d, x, y) -> None:
    v[a] = (v[a] + v[b] + x) & MASK
    v[d] = v[d] ^ v[a]
    v[d] = ((v[d] >> 16) | (v[d] << 16)) & MASK
    v[c] = (v[c] + v[d]) & MASK
    v[b] = v[b] ^ v[c]
    v[b] = ((v[b] >> 12) | (v[b] << 20)) & MASK
    v[a] = (v[a] + v[b] + y) & MASK
    v[d] = v[d] ^ v[a]
    v[d] = ((v[d] >> 8) | (v[d] << 24)) & MASK
    v[c] = (v[c] + v[d]) & MASK
    v[b] = v[b] ^ v[c]
    v[b] = ((v[b] >> 7) | (v[b] << 25)) & MASK


def compress(cv: List, m: List, counter, block_len, flags) -> List:
    """The compression function on 8 chaining words and 16 message words
    (ints, or int64 tensors of one shape) -> the 16 output words."""
    v = list(cv) + list(IV[:4]) + [counter & MASK, (counter >> 32) & MASK, block_len, flags]
    m = list(m)
    for r in range(7):
        _g(v, 0, 4, 8, 12, m[0], m[1])
        _g(v, 1, 5, 9, 13, m[2], m[3])
        _g(v, 2, 6, 10, 14, m[4], m[5])
        _g(v, 3, 7, 11, 15, m[6], m[7])
        _g(v, 0, 5, 10, 15, m[8], m[9])
        _g(v, 1, 6, 11, 12, m[10], m[11])
        _g(v, 2, 7, 8, 13, m[12], m[13])
        _g(v, 3, 4, 9, 14, m[14], m[15])
        if r < 6:
            m = [m[p] for p in PERM]
    return [v[i] ^ v[i + 8] for i in range(8)] + [v[i + 8] ^ cv[i] for i in range(8)]


# -- pure Python, short host inputs -------------------------------------------

def _words(block: bytes) -> List[int]:
    return list(struct.unpack("<16I", block.ljust(64, b"\x00")))


def _chunk_cv(data: bytes, counter: int, root: bool) -> tuple:
    """(cv, last block's words, its length, its flags) of one chunk, the
    last block not yet compressed."""
    blocks = [data[i:i + 64] for i in range(0, len(data), 64)] or [b""]
    cv = list(IV)
    for i, blk in enumerate(blocks[:-1]):
        cv = compress(cv, _words(blk), counter, 64, CHUNK_START if i == 0 else 0)[:8]
    flags = (CHUNK_START if len(blocks) == 1 else 0) | CHUNK_END | (ROOT if root else 0)
    return cv, _words(blocks[-1]), len(blocks[-1]), flags


def _root(data: bytes) -> tuple:
    """(cv, words, block length, flags) of the root node of data."""
    n = max(1, -(-len(data) // CHUNK))
    if n == 1:
        return _chunk_cv(data, 0, True)
    cvs = []
    for i in range(n):
        cv, w, ln, fl = _chunk_cv(data[i * CHUNK:(i + 1) * CHUNK], i, False)
        cvs.append(compress(cv, w, i, ln, fl)[:8])
    while len(cvs) > 2:
        nxt = [compress(IV, cvs[i] + cvs[i + 1], 0, 64, PARENT)[:8]
               for i in range(0, len(cvs) - 1, 2)]
        cvs = nxt + cvs[len(nxt) * 2:]
    return list(IV), cvs[0] + cvs[1], 64, PARENT | ROOT


def xof(data: bytes, n: int) -> bytes:
    """The first n bytes of data's BLAKE3 output stream."""
    cv, w, ln, fl = _root(data)
    out = b"".join(struct.pack("<16I", *compress(cv, w, i, ln, fl))
                   for i in range(-(-n // 64)))
    return out[:n]


def hash_bytes(data: bytes) -> bytes:
    return xof(data, 32)


# -- PyTorch, many rows of one length ----------------------------------------

def _block_words(x: torch.Tensor) -> List[torch.Tensor]:
    """(..., 64) uint8 -> 16 int64 tensors (...,), little-endian words."""
    w = x.view(*x.shape[:-1], 16, 4).to(torch.int64)
    w = w[..., 0] | (w[..., 1] << 8) | (w[..., 2] << 16) | (w[..., 3] << 24)
    return list(w.unbind(-1))


def _chunk_cvs(rows: torch.Tensor, first: int, n: int, length: int, root: bool) -> torch.Tensor:
    """The CVs (rows, n, 8) of chunks first .. first + n - 1 of each row,
    the row holding `length` bytes (the last chunk may be partial)."""
    R = rows.shape[0]
    lo, hi = first * CHUNK, min(length, (first + n) * CHUNK)
    data = torch.zeros((R, n * CHUNK), dtype=torch.uint8, device=rows.device)
    data[:, :hi - lo] = rows[:, lo:hi]
    data = data.view(R, n, 16, 64)
    lens = [min(CHUNK, length - (first + i) * CHUNK) for i in range(n)]
    blocks = [max(1, -(-ln // 64)) for ln in lens]
    dev = rows.device
    ctr = torch.arange(first, first + n, dtype=torch.int64, device=dev).expand(R, n)
    cv = [torch.full((R, n), w, dtype=torch.int64, device=dev) for w in IV]
    for b in range(max(blocks)):
        m = _block_words(data[:, :, b])
        blen = torch.tensor([min(64, max(0, ln - 64 * b)) for ln in lens], dtype=torch.int64,
                            device=dev)
        last = torch.tensor([b == nb - 1 for nb in blocks], device=dev)
        live = torch.tensor([b < nb for nb in blocks], device=dev)
        flags = (CHUNK_START if b == 0 else 0) + CHUNK_END * last.long()
        if root:
            flags = flags + ROOT * last.long()
        out = compress(cv, m, ctr, blen.expand(R, n), flags.expand(R, n))
        cv = [torch.where(live, o, c) for o, c in zip(out[:8], cv)]
    return torch.stack(cv, dim=-1)


def _parent(left: torch.Tensor, right: torch.Tensor, root: bool) -> torch.Tensor:
    m = list(torch.cat([left, right], dim=-1).unbind(-1))
    cv = [torch.full_like(m[0], w) for w in IV]
    return torch.stack(compress(cv, m, 0, 64, PARENT | (ROOT if root else 0))[:8], dim=-1)


def hash_rows(rows: torch.Tensor, length: int) -> torch.Tensor:
    """(R, >= length) uint8 -> (R, 32) uint8: BLAKE3 of each row's first
    `length` bytes."""
    R = rows.shape[0]
    n = max(1, -(-length // CHUNK))
    per = max(1, LANES_A_PASS // max(R, 1))
    cvs = torch.cat([_chunk_cvs(rows, c, min(per, n - c), length, n == 1)
                     for c in range(0, n, per)], dim=1)  # (R, n, 8)
    while cvs.shape[1] > 1:
        k = cvs.shape[1] // 2
        pairs = _parent(cvs[:, 0:2 * k:2], cvs[:, 1:2 * k:2], cvs.shape[1] == 2)
        cvs = torch.cat([pairs, cvs[:, 2 * k:]], dim=1)
    words = cvs[:, 0]  # (R, 8)
    out = torch.stack([(words >> s) & 0xFF for s in (0, 8, 16, 24)], dim=-1)
    return out.reshape(R, 32).to(torch.uint8)
