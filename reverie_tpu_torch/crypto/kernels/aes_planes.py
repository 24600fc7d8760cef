"""Raw AES-128-CTR keystream planes: the keystream of K keys, bitsliced.

Port of the Pallas kernel reverie_tpu/crypto/kernels/aes_pallas.py:
_aes_kernel (entry `aes_ctr_planes_pallas`), which becomes the CUDA kernel
`csrc/aes_planes.cu`.  Its caller is the AES-rate probe
`reverie_tpu_torch.tools.r2_measure`.

Contract: round keys (K, 11, 16) u8 (`aes_tape.round_keys`, K a multiple of
32) -> planes (16, 8, B, Kw) int32 (u32 data), Kw = K // 32: bit j of
planes[by, bit, b, w] is bit `bit` (LSB first) of byte `by` of the
keystream block b under key 32w + j -- the packing of
`aes_jax.round_key_planes`.  The CTR block is the big-endian 128-bit
counter with block index b.

`aes_ctr_planes` is the wrapper: a CPU tensor goes to the plain version
`aes_ctr_planes_ref` (the textbook AES of aes_tape.py), a CUDA tensor
launches the kernel.  `plan(B, Kw)` says how the kernel is launched on the
card (persistent grid, run length).
"""

from __future__ import annotations

import torch

from ... import _build
from .aes_tape import _counter_blocks, aes_encrypt_ref, launch_plan

#: kernel launches made by `aes_ctr_planes` (CUDA tensors only)
LAUNCHES = 0

#: key-bit elements per chunk of the plain version (K * blocks * 128)
_PLAIN_BITS = 1 << 25


def aes_ctr_planes_ref(round_keys: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """Plain PyTorch version of the planes kernel, in chunks of counter
    blocks."""
    K = round_keys.shape[0]
    Kw = K // 32
    dev = round_keys.device
    out = torch.empty((16, 8, n_blocks, Kw), dtype=torch.int32, device=dev)
    shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    weights = torch.ones(32, dtype=torch.int64, device=dev) << torch.arange(
        32, dtype=torch.int64, device=dev)
    step = max(1, _PLAIN_BITS // max(1, K * 128))
    for b0 in range(0, n_blocks, step):
        nb = min(step, n_blocks - b0)
        ks = aes_encrypt_ref(round_keys, _counter_blocks(b0, nb, dev))  # (K, nb, 16)
        bits = ((ks.unsqueeze(-1) >> shifts) & 1).reshape(Kw, 32, nb, 16, 8)
        words = (bits.to(torch.int64) * weights.view(1, 32, 1, 1, 1)).sum(1)
        words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
        out[:, :, b0 : b0 + nb] = words.permute(2, 3, 1, 0)  # (16, 8, nb, Kw)
    return out


def plan(n_blocks: int, Kw: int) -> dict:
    """csrc/aes_planes.cu's launch at (B, Kw) on the current card."""
    return launch_plan(_build.kernels().reverie_aes_ctr_planes_plan, n_blocks, Kw)


def aes_ctr_planes(round_keys: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """(K, 11, 16) u8 round keys -> (16, 8, n_blocks, K // 32) int32
    keystream planes.  CPU tensors take the plain version; CUDA tensors
    launch csrc/aes_planes.cu."""
    global LAUNCHES
    dev = round_keys.device
    if (round_keys.dtype != torch.uint8 or round_keys.dim() != 3
            or round_keys.shape[1:] != (11, 16) or round_keys.shape[0] % 32):
        raise ValueError("aes_ctr_planes: round_keys must be uint8 (K, 11, 16) "
                         "with K a multiple of 32")
    if not 0 <= n_blocks < 2**32:
        raise ValueError("aes_ctr_planes: n_blocks out of range")
    if dev.type == "cpu":
        return aes_ctr_planes_ref(round_keys, n_blocks)
    if dev.type != "cuda":
        raise ValueError(f"aes_ctr_planes: unsupported device {dev}")
    if not round_keys.is_contiguous():
        raise ValueError("aes_ctr_planes: round_keys must be contiguous")
    Kw = round_keys.shape[0] // 32
    out = torch.empty((16, 8, n_blocks, Kw), dtype=torch.int32, device=dev)
    if n_blocks == 0 or Kw == 0:
        return out
    lib = _build.kernels()
    with torch.cuda.device(dev):  # the C side plans for the current device
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.reverie_aes_ctr_planes(round_keys.data_ptr(), out.data_ptr(),
                                        n_blocks, Kw, stream)
    _build.check(rc, "aes_ctr_planes kernel")
    LAUNCHES += 1
    return out
