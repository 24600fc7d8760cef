"""u32 words -> u8 bytes in both orders, checked and timed on the card.

    python -m reverie_tpu_torch.tools.r5_u8emit

Port of reverie_tpu's tools/r5_u8emit.py.  Its Pallas probe kernels
`kern_bitcast`, `kern_shift`, `kern_repeat` (exact order) and `kern_concat`
(sigma order) become one CUDA kernel with a `perm` flag, `csrc/u8emit.cu`
(`u32_to_u8_rows`, plain version `u32_to_u8_rows_ref`).

(T, 128) u32 words (int32 here) -> (T, 2, 256) u8.  Exact order: lane
4k + b of a (T, 512) row is byte b of word k, the little-endian byte view
(`x.view(np.uint8)`).  Sigma order: [t, g, b*64 + k] is byte b of word
g*64 + k.  The probe checks both orders at T = 64 against the tool's NumPy
wants (its `run_check` and `run_check2` input), then times the kernel, the
plain version and the library yardstick (`.contiguous()` of the byte view)
at the 1M-tape shape, T = 1,000,001 (512 MB in, 512 MB out).
"""

from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np
import torch

from .. import _build
from ..device import default_device
from ._timing import cuda_ms, gbps, print_results
from .r4_bwroof import random_tensor

#: kernel launches made by `u32_to_u8_rows` (CUDA tensors only)
LAUNCHES = 0

T_CHECK = 64  # the tool's check size
T_TIME = 1_000_001  # the 1M-gate tape's rows
SEED = 7


def _byte_view(w: torch.Tensor, perm: bool) -> torch.Tensor:
    """The (T, 2, 256)-ordered byte view of (T, 128) int32 words, as a
    (T, 2, 4, 64) or (T, 2, 64, 4) view."""
    b = w.view(torch.uint8).view(w.shape[0], 2, 64, 4)
    return b.transpose(2, 3) if perm else b


def u32_to_u8_rows_ref(w: torch.Tensor, perm: bool = False) -> torch.Tensor:
    """Plain PyTorch version: a contiguous copy of the byte view."""
    T = w.shape[0]
    return _byte_view(w, perm).clone(memory_format=torch.contiguous_format).view(T, 2, 256)


def u32_to_u8_rows_library(w: torch.Tensor, perm: bool = False) -> torch.Tensor:
    """The library yardstick: `.contiguous()` of the byte view (a new
    tensor: the view of a fresh copy in the exact order)."""
    v = _byte_view(w, perm)
    return (v.contiguous() if perm else v.clone()).view(w.shape[0], 2, 256)


def u32_to_u8_rows(w: torch.Tensor, perm: bool = False) -> torch.Tensor:
    """(T, 128) int32 -> (T, 2, 256) uint8, exact (perm=False) or sigma
    order.  CPU tensors take the plain version; CUDA tensors launch
    csrc/u8emit.cu (contiguous, 16-byte aligned input)."""
    global LAUNCHES
    if w.dtype != torch.int32 or w.dim() != 2 or w.shape[1] != 128:
        raise ValueError("u32_to_u8_rows: w must be int32 (T, 128)")
    if w.device.type == "cpu":
        return u32_to_u8_rows_ref(w, perm)
    if w.device.type != "cuda":
        raise ValueError(f"u32_to_u8_rows: unsupported device {w.device}")
    if not w.is_contiguous() or w.data_ptr() % 16:
        raise ValueError("u32_to_u8_rows: w must be contiguous and 16-byte aligned")
    T = w.shape[0]
    out = torch.empty((T, 2, 256), dtype=torch.uint8, device=w.device)
    if T == 0:
        return out
    lib = _build.kernels()
    rc = lib.reverie_u32_to_u8_rows(w.data_ptr(), out.data_ptr(), T, int(perm),
                                    torch.cuda.current_stream(w.device).cuda_stream)
    _build.check(rc, "u32_to_u8_rows kernel")
    LAUNCHES += 1
    return out


def tool_input(T: int) -> np.ndarray:
    """The tool's check input: arange(T * 128) * 2654435761 as (T, 128)
    u32 (tools/r5_u8emit.py:52)."""
    return np.arange(T * 128, dtype=np.uint32).reshape(T, 128) * np.uint32(2654435761)


def tool_want(x: np.ndarray, perm: bool) -> np.ndarray:
    """The tool's NumPy want (tools/r5_u8emit.py:53 and :96-102)."""
    T = x.shape[0]
    if not perm:
        return x.view(np.uint8).reshape(T, 2, 256)
    by = x.view(np.uint8).reshape(T, 128, 4)  # [t, word, byte]
    want = np.zeros((T, 2, 256), np.uint8)
    for g in range(2):
        for b in range(4):
            want[:, g, b * 64:(b + 1) * 64] = by[:, g * 64:(g + 1) * 64, b]
    return want


def run(device: torch.device, t_time: int = T_TIME) -> List[Dict]:
    """Both orders: equal to the tool's NumPy want at T_CHECK, then timed
    at t_time (kernel, plain version, library yardstick)."""
    x = tool_input(T_CHECK)
    w_check = torch.from_numpy(x.view(np.int32)).to(device)
    w = random_tensor((t_time, 128), torch.int32, device, SEED)
    rows = []
    for perm in (False, True):
        got = u32_to_u8_rows(w_check, perm).cpu().numpy()
        equal = bool(np.array_equal(got, tool_want(x, perm)))
        t_k = cuda_ms(lambda: u32_to_u8_rows(w, perm), device)
        rows.append({
            "probe": "r5_u8emit", "order": "sigma" if perm else "exact",
            "t_check": T_CHECK, "equal_to_tool_want": equal, "t_time": t_time,
            "bytes": 2 * w.numel() * 4,
            "kernel_ms": t_k, "kernel_gbps": gbps(2 * w.numel() * 4, t_k),
            "plain_ms": cuda_ms(lambda: u32_to_u8_rows_ref(w, perm), device),
            "library_ms": cuda_ms(lambda: u32_to_u8_rows_library(w, perm), device),
        })
        if not equal:
            raise AssertionError(f"r5_u8emit: the {rows[-1]['order']} order differs "
                                 "from the tool's want")
    return rows


def main() -> int:
    print_results(run(default_device()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
