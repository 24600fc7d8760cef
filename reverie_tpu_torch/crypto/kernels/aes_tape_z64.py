"""Z64 mask tape: AES-128-CTR over every player key, read as little-endian
64-bit words, one int64 per (slot, player, repetition).

Port of the z64 half of reverie_tpu/backend/tpu_host.py `build_tapes`, of
reverie_tpu/crypto/kernels/aes_jax.py (`aes_ctr_tape_z64`,
`aes_ctr_tape_z64_chunked`, `lane_mask_raw_pm`) and of the Pallas kernel
aes_pallas.py:_aes_tape_z64_kernel, which becomes the CUDA kernel
`csrc/aes_tape_z64.cu`.

Contract (`build_tapes(keys, omit, 0, mz)`'s lo | hi << 32, as int64):
tape[m, p, r] is the little-endian u64 of keystream bytes 8*(m%2) .. +8 of
the CTR block `start_block + m//2` of player p of repetition r, and 0 where
p == omit[r] (omit 8 = none).  Z_2^64 is native int64, which wraps mod 2^64.

`aes_ctr_tape_z64` is the wrapper: a CPU tensor goes to the plain version
`aes_ctr_tape_z64_ref` (the textbook AES of aes_tape.py), a CUDA tensor
launches the kernel.  `plan(mz, R)` says how the kernel is launched on the
card.
"""

from __future__ import annotations

from typing import Optional

import torch

from ... import _build
from .aes_tape import (
    _PLAIN_CHUNK,
    _counter_blocks,
    aes_encrypt_ref,
    check_launch_args,
    launch_plan,
)

#: kernel launches made by `aes_ctr_tape_z64` (CUDA tensors only)
LAUNCHES = 0


def aes_ctr_tape_z64_ref(round_keys: torch.Tensor, mz: int,
                         omit: Optional[torch.Tensor] = None,
                         start_block: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the z64 tape kernel: (R*8, 11, 16) u8
    rep-major round keys -> (mz, 8, R) int64 tape.  Runs in chunks of
    counter blocks so the working set stays near _PLAIN_CHUNK AES states."""
    K = round_keys.shape[0]
    R = K // 8
    dev = round_keys.device
    out = torch.empty((mz, 8, R), dtype=torch.int64, device=dev)
    if mz == 0:
        return out
    keep = torch.ones((8, R), dtype=torch.int64, device=dev)
    if omit is not None:
        players = torch.arange(8, device=dev)[:, None]
        keep = (players != omit.to(device=dev, dtype=torch.int64)[None, :]).to(torch.int64)
    n_blocks = (mz + 1) // 2
    step = max(1, _PLAIN_CHUNK // K)
    for b0 in range(0, n_blocks, step):
        nb = min(step, n_blocks - b0)
        ks = aes_encrypt_ref(round_keys, _counter_blocks(start_block + b0, nb, dev))
        # (K, nb, 16) bytes -> (K, 2 nb) little-endian words -> (2 nb, 8, R)
        words = ks.contiguous().view(torch.int64).reshape(R, 8, 2 * nb)
        words = words.permute(2, 1, 0) * keep
        lo = 2 * b0
        hi = min(lo + 2 * nb, mz)
        out[lo:hi] = words[: hi - lo]
    return out


def plan(mz: int, R: int) -> dict:
    """csrc/aes_tape_z64.cu's launch at (mz, R) on the current card."""
    return launch_plan(_build.kernels().reverie_aes_tape_z64_plan, mz, R)


def aes_ctr_tape_z64(round_keys: torch.Tensor, mz: int,
                     omit: Optional[torch.Tensor] = None,
                     start_block: int = 0) -> torch.Tensor:
    """(R*8, 11, 16) u8 round keys, (R,) u8 omit (8 = none) -> (mz, 8, R)
    int64 z64 tape.  CPU tensors take the plain version; CUDA tensors launch
    csrc/aes_tape_z64.cu."""
    global LAUNCHES
    dev = round_keys.device
    if dev.type == "cpu":
        return aes_ctr_tape_z64_ref(round_keys, mz, omit, start_block)
    if dev.type != "cuda":
        raise ValueError(f"aes_ctr_tape_z64: unsupported device {dev}")
    omit = check_launch_args("aes_ctr_tape_z64", round_keys, omit, start_block)
    R = round_keys.shape[0] // 8
    out = torch.empty((mz, 8, R), dtype=torch.int64, device=dev)
    if mz == 0 or R == 0:
        return out
    lib = _build.kernels()
    with torch.cuda.device(dev):  # the C side plans for the current device
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.reverie_aes_tape_z64(round_keys.data_ptr(), omit.data_ptr(),
                                      out.data_ptr(), mz, R, start_block, stream)
    _build.check(rc, "aes_tape_z64 kernel")
    LAUNCHES += 1
    return out
