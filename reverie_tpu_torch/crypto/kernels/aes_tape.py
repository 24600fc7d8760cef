"""GF(2) mask tape: AES-128-CTR over every player key, one tape byte per
(slot, repetition).

Port of reverie_tpu/crypto/kernels/aes_jax.py (`aes_ctr_tape_gf2`,
`lane_mask_from_omit`, `round_key_planes_device`, `counter_planes_device`)
and of the Pallas kernel aes_pallas.py:_aes_tape_kernel with its u8 store
tail _u8_relayout_kernel, which become one CUDA kernel
(`csrc/aes_tape.cu`).

Contract (`tpu_host.build_tapes(keys, omit, m2, 0)[0]`): tape[s, r] for slot
s = b*128 + by*8 + j holds, at bit (7-p), bit (7-j) of byte `by` of the
keystream block `start_block + b` of player p of repetition r; the omitted
player's bit is 0.

`aes_ctr_tape_gf2` is the wrapper: a CPU tensor goes to the plain version
`aes_ctr_tape_gf2_ref` (textbook byte-oriented AES: S-box lookup,
ShiftRows, MixColumns), a CUDA tensor launches the kernel.  `plan(m2, R)`
says how the kernel is launched on the card (persistent grid, run length).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ... import _build
from ..prg import key_expand_batch

#: kernel launches made by `aes_ctr_tape_gf2` (CUDA tensors only)
LAUNCHES = 0

BATCH = 128  # tape slots per 16-byte counter block

SBOX = (
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b, 0xfe, 0xd7, 0xab, 0x76,
    0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0, 0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0,
    0xb7, 0xfd, 0x93, 0x26, 0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2, 0xeb, 0x27, 0xb2, 0x75,
    0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0, 0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84,
    0x53, 0xd1, 0x00, 0xed, 0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f, 0x50, 0x3c, 0x9f, 0xa8,
    0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5, 0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2,
    0xcd, 0x0c, 0x13, 0xec, 0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14, 0xde, 0x5e, 0x0b, 0xdb,
    0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c, 0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79,
    0xe7, 0xc8, 0x37, 0x6d, 0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f, 0x4b, 0xbd, 0x8b, 0x8a,
    0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e, 0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e,
    0xe1, 0xf8, 0x98, 0x11, 0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f, 0xb0, 0x54, 0xbb, 0x16,
)

# state byte 4c+r (column c, row r) <- old byte 4((c+r)%4)+r
SHIFT_ROWS = [4 * ((i // 4 + i % 4) % 4) + (i % 4) for i in range(16)]

#: AES blocks (keys x counter blocks) per chunk of the plain version
_PLAIN_CHUNK = 1 << 22


def round_keys(player_keys: np.ndarray, device: torch.device) -> torch.Tensor:
    """(R, 8, 16) u8 player keys -> (R*8, 11, 16) u8 AES-128 round keys on
    `device` (key order rep-major: key r*8 + p is player p of rep r).  The
    key schedule runs in the port's host C library (crypto/native.py); on
    CUDA the keys go up from pinned memory, without waiting for the work
    queued on the stream before them."""
    rk = torch.from_numpy(key_expand_batch(np.asarray(player_keys, np.uint8).reshape(-1, 16)))
    if torch.device(device).type == "cuda":
        return rk.pin_memory().to(device, non_blocking=True)
    return rk.to(device)


def _xtime(x: torch.Tensor) -> torch.Tensor:
    """x2 in GF(2^8) mod 0x11B, on uint8 (the shift drops bit 7)."""
    return (x << 1) ^ ((x >> 7) * 0x1B)


def _mix_columns(s: torch.Tensor) -> torch.Tensor:
    """s: (..., 16) uint8 state, byte 4c+r = column c, row r."""
    c = s.reshape(*s.shape[:-1], 4, 4)
    a0, a1, a2, a3 = c.unbind(-1)
    x0, x1, x2, x3 = (_xtime(a) for a in (a0, a1, a2, a3))
    b0 = x0 ^ x1 ^ a1 ^ a2 ^ a3
    b1 = a0 ^ x1 ^ x2 ^ a2 ^ a3
    b2 = a0 ^ a1 ^ x2 ^ x3 ^ a3
    b3 = x0 ^ a0 ^ a1 ^ a2 ^ x3
    return torch.stack([b0, b1, b2, b3], dim=-1).reshape(s.shape)


def _counter_blocks(start_block: int, n: int, device) -> torch.Tensor:
    """(n, 16) uint8 CTR blocks: bytes 0..7 zero, bytes 8..15 the big-endian
    64-bit counter start_block + i."""
    ctr = start_block + torch.arange(n, dtype=torch.int64, device=device)
    blocks = torch.zeros((n, 16), dtype=torch.uint8, device=device)
    for j in range(8):
        blocks[:, 15 - j] = ((ctr >> (8 * j)) & 0xFF).to(torch.uint8)
    return blocks


def aes_encrypt_ref(rk: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """Textbook AES-128: rk (K, 11, 16) u8 round keys, blocks (B, 16) u8 ->
    (K, B, 16) u8 ciphertexts of every block under every key."""
    sbox = torch.tensor(SBOX, dtype=torch.uint8, device=rk.device)
    perm = torch.tensor(SHIFT_ROWS, dtype=torch.int64, device=rk.device)
    s = blocks[None] ^ rk[:, None, 0]
    for rnd in range(1, 11):
        s = sbox[s.long()]
        s = s.index_select(-1, perm)
        if rnd < 10:
            s = _mix_columns(s)
        s = s ^ rk[:, None, rnd]
    return s


def _omit_keep(omit: torch.Tensor) -> torch.Tensor:
    """(R,) omitted player (8 = none) -> (R,) u8 byte mask clearing bit
    (7 - omit) (aes_jax.lane_mask_from_omit, per repetition)."""
    om = omit.to(torch.int64)
    bit = torch.where(om < 8, torch.full_like(om, 0x80) >> om.clamp(max=7),
                      torch.zeros_like(om))
    return (0xFF ^ bit).to(torch.uint8)


def aes_ctr_tape_gf2_ref(round_keys: torch.Tensor, m2: int,
                         omit: Optional[torch.Tensor] = None,
                         start_block: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the tape kernel: (R*8, 11, 16) u8 round
    keys -> (m2, R) u8 tape.  Runs in chunks of counter blocks so the
    working set stays near _PLAIN_CHUNK AES states."""
    K = round_keys.shape[0]
    R = K // 8
    dev = round_keys.device
    out = torch.empty((m2, R), dtype=torch.uint8, device=dev)
    if m2 == 0:
        return out
    keep = (_omit_keep(omit) if omit is not None
            else torch.full((R,), 0xFF, dtype=torch.uint8, device=dev))
    n_blocks = (m2 + BATCH - 1) // BATCH
    step = max(1, _PLAIN_CHUNK // K)
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=dev)
    for b0 in range(0, n_blocks, step):
        nb = min(step, n_blocks - b0)
        ks = aes_encrypt_ref(round_keys, _counter_blocks(start_block + b0, nb, dev))
        ks = ks.reshape(R, 8, nb * 16)
        # slot by*8 + j of a block <- bit (7-j) of keystream byte by
        bits = ((ks.unsqueeze(-1) >> shifts) & 1).reshape(R, 8, nb * BATCH)
        tape = torch.zeros((R, nb * BATCH), dtype=torch.uint8, device=dev)
        for p in range(8):
            tape |= bits[:, p] << (7 - p)
        tape &= keep[:, None]
        lo = b0 * BATCH
        hi = min(lo + nb * BATCH, m2)
        out[lo:hi] = tape.t()[: hi - lo]
    return out


def check_launch_args(name: str, round_keys: torch.Tensor,
                      omit: Optional[torch.Tensor], start_block: int
                      ) -> torch.Tensor:
    """Validate a tape kernel's CUDA arguments; returns the (R,) uint8 omit
    (8 = none where `omit` is None)."""
    dev = round_keys.device
    K = round_keys.shape[0]
    if (round_keys.dtype != torch.uint8 or round_keys.dim() != 3
            or round_keys.shape[1:] != (11, 16) or K % 8
            or not round_keys.is_contiguous()):
        raise ValueError(f"{name}: round_keys must be contiguous uint8 "
                         "(R*8, 11, 16)")
    R = K // 8
    if omit is None:
        omit = torch.full((R,), 8, dtype=torch.uint8, device=dev)
    if (omit.dtype != torch.uint8 or omit.shape != (R,)
            or omit.device != dev or not omit.is_contiguous()):
        raise ValueError(f"{name}: omit must be contiguous uint8 (R,) on the "
                         "keys' device")
    if not 0 <= start_block < 2**63:
        raise ValueError(f"{name}: start_block out of range")
    return omit


def launch_plan(entry, m: int, R: int) -> dict:
    """An AES kernel's launch on the current card at tape length m and R
    reps (the planes kernel: B counter blocks and Kw plane words), `entry`
    its C plan function: dynamic shared bytes, resident thread blocks,
    counter blocks per work item, grid."""
    plan = (ctypes.c_longlong * 4)()
    _build.check(entry(m, R, plan), "AES kernel plan")
    return dict(zip(("smem_dynamic", "resident_blocks", "run", "grid"), plan))


def plan(m2: int, R: int) -> dict:
    """csrc/aes_tape.cu's launch at (m2, R) on the current card."""
    return launch_plan(_build.kernels().reverie_aes_tape_gf2_plan, m2, R)


def aes_ctr_tape_gf2(round_keys: torch.Tensor, m2: int,
                     omit: Optional[torch.Tensor] = None,
                     start_block: int = 0) -> torch.Tensor:
    """(R*8, 11, 16) u8 round keys, (R,) u8 omit (8 = none) -> (m2, R) u8
    GF2 tape.  CPU tensors take the plain version; CUDA tensors launch
    csrc/aes_tape.cu."""
    global LAUNCHES
    dev = round_keys.device
    if dev.type == "cpu":
        return aes_ctr_tape_gf2_ref(round_keys, m2, omit, start_block)
    if dev.type != "cuda":
        raise ValueError(f"aes_ctr_tape_gf2: unsupported device {dev}")
    omit = check_launch_args("aes_ctr_tape_gf2", round_keys, omit, start_block)
    R = round_keys.shape[0] // 8
    out = torch.empty((m2, R), dtype=torch.uint8, device=dev)
    if m2 == 0 or R == 0:
        return out
    lib = _build.kernels()
    with torch.cuda.device(dev):  # the C side plans for the current device
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.reverie_aes_tape_gf2(round_keys.data_ptr(), omit.data_ptr(),
                                      out.data_ptr(), m2, R, start_block, stream)
    _build.check(rc, "aes_tape_gf2 kernel")
    LAUNCHES += 1
    return out
