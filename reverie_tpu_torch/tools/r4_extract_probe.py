"""The GF(2) extractor's select-and-pack forms, timed on the card.

    python -m reverie_tpu_torch.tools.r4_extract_probe

Port of reverie_tpu's tools/r4_extract_probe.py.  Its Pallas pack+shift
kernels `_pack_kernel` (entry `pack_shift_pallas`), `_pack_kernel_u8` and
`_pack_kernel_mxu` (entry `pack_shift_pallas2`) compute one function and
become one CUDA kernel, `csrc/pack_shift.cu` (`pack_shift`, plain version
`pack_shift_ref`):

    out[c, r] = sum_j ((x[8c + j, r] >> sh[r]) & 1) << (7 - j),

x (n, R) u8, sh (R,) u8 -> (n // 8 + 1, R) u8, rows >= n read as 0, the
last row always emitted.

The probe makes two (n, R) u8 streams on the device from a seed (onl,
whose opened bit sits at a random shift per column, and pre, shift 0),
picks K opened columns, and times three forms with CUDA events:
  * `floor`: one read pass of both streams (a sum of each, read as int32
    words; r % 4 == 0);
  * `gather`: the port's production form, the K columns gathered
    (`index_select`), shifted and masked, then `backend/host.py:
    _pack_rows_device`;
  * `packall`: `pack_shift` over all R columns, then a gather of the K.
`gather` and `packall` must give equal bytes.  The one-hot MXU select forms
of the TPU probe (`mm_bf16`, `mm_i8`, `main_fused`) are TPU workarounds
and are not ported.
"""

from __future__ import annotations

import sys
from typing import Dict

import numpy as np
import torch

from .. import _build
from ..backend.host import _pack_rows_device
from ..device import default_device
from ._timing import cuda_ms, print_results
from .r4_bwroof import random_tensor

#: kernel launches made by `pack_shift` (CUDA tensors only)
LAUNCHES = 0

N = 1_000_002  # onl2 rows at 1M AND gates
R = 256
K = 40
SEED = 0

#: integer instructions per output word of the pack-shift (4 columns x 8
#: rows): 8 rows x (an AND with the per-byte bit mask, a per-byte nonzero
#: test, a LOP3 that keeps bit 7 - j and ORs it in).  The mask is made once
#: per column and is not counted (roofline.py).
INT_OPS_PER_WORD = 8 * 3


def pack_shift_ref(x: torch.Tensor, sh: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the pack-shift kernel."""
    return _pack_rows_device((x >> sh[None, :]) & 1)


def pack_shift(x: torch.Tensor, sh: torch.Tensor) -> torch.Tensor:
    """(n, R) uint8, (R,) uint8 shifts -> (n // 8 + 1, R) uint8 packed bits.
    CPU tensors take the plain version; CUDA tensors launch
    csrc/pack_shift.cu (R % 4 == 0, contiguous, 4-byte aligned)."""
    global LAUNCHES
    if (x.dtype != torch.uint8 or x.dim() != 2 or sh.dtype != torch.uint8
            or sh.shape != (x.shape[1],) or sh.device != x.device):
        raise ValueError("pack_shift: x must be uint8 (n, R) and sh uint8 (R,) "
                         "on the same device")
    if x.device.type == "cpu":
        return pack_shift_ref(x, sh)
    if x.device.type != "cuda":
        raise ValueError(f"pack_shift: unsupported device {x.device}")
    n, r = x.shape
    if (r % 4 or not x.is_contiguous() or not sh.is_contiguous()
            or x.data_ptr() % 4 or sh.data_ptr() % 4):
        raise ValueError("pack_shift: R must be a multiple of 4, x and sh "
                         "contiguous and 4-byte aligned")
    out = torch.empty((n // 8 + 1, r), dtype=torch.uint8, device=x.device)
    if r == 0:
        return out
    lib = _build.kernels()
    rc = lib.reverie_pack_shift(x.data_ptr(), sh.data_ptr(), out.data_ptr(), n, r,
                                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "pack_shift kernel")
    LAUNCHES += 1
    return out


def run(device: torch.device, n: int = N, r: int = R, k: int = K) -> Dict:
    """Time floor / gather / packall on two (n, r) streams with k opened
    columns; gather and packall must agree."""
    onl = random_tensor((n, r), torch.uint8, device, SEED)
    pre = random_tensor((n, r), torch.uint8, device, SEED + 1)
    rng = np.random.default_rng(SEED)
    cols = torch.as_tensor(np.sort(rng.choice(r, k, replace=False)), device=device)
    sh = torch.as_tensor(rng.integers(0, 8, r).astype(np.uint8), device=device)
    zero = torch.zeros(r, dtype=torch.uint8, device=device)
    sh_sel = sh.index_select(0, cols)

    def floor():  # a sum of each stream read as int32 words
        return (onl.view(torch.int32).sum(dtype=torch.int64)
                + pre.view(torch.int32).sum(dtype=torch.int64))

    def gather():
        a = (onl.index_select(1, cols) >> sh_sel[None, :]) & 1
        b = pre.index_select(1, cols) & 1
        return _pack_rows_device(a), _pack_rows_device(b)

    def packall():
        return (pack_shift(onl, sh).index_select(1, cols),
                pack_shift(pre, zero).index_select(1, cols))

    g, p = gather(), packall()
    equal = bool(torch.equal(g[0], p[0]) and torch.equal(g[1], p[1]))
    row = {"probe": "r4_extract_probe", "n": n, "R": r, "K": k,
           "gather_equals_packall": equal,
           "floor_ms": cuda_ms(floor, device),
           "gather_ms": cuda_ms(gather, device),
           "packall_ms": cuda_ms(packall, device)}
    if not equal:
        raise AssertionError("r4_extract_probe: gather and packall differ")
    return row


def main() -> int:
    print_results([run(default_device())])
    return 0


if __name__ == "__main__":
    sys.exit(main())
