"""The card's copy roof: device-memory copies timed with CUDA events.

    python -m reverie_tpu_torch.tools.r4_bwroof

Port of reverie_tpu's tools/r4_bwroof.py with its Pallas `_copy_kernel`
(entry `pallas_copy`), which becomes the CUDA kernel `csrc/copy.cu`
(`copy`, plain version `copy_ref`).  The probe's cases are its 512 MB
arrays, (2,000,000, 256) u8 and (500,000, 256) u32 (int32 here), made on
the device from a seed.  For each it times
  * `copy`: the kernel, 2 passes (read, write);
  * `library`: `torch.empty_like(x).copy_(x)`, 2 passes;
  * `xor_copy`: `copy(x ^ s)`, the probe's "xor + copy": 4 passes (the XOR
    reads and writes, the copy reads and writes);
and prints each time with its aggregate GB/s (passes x bytes / time).
CUDA events replace the RTT-cancelling slope method, a TPU-only device.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .. import _build
from ..device import default_device
from ._timing import cuda_ms, gbps, print_results

#: kernel launches made by `copy` (CUDA tensors only)
LAUNCHES = 0

#: the probe's arrays: (name, shape, dtype), 512 MB each
CASES: Tuple[Tuple[str, Tuple[int, int], torch.dtype], ...] = (
    ("u8", (2_000_000, 256), torch.uint8),
    ("u32", (500_000, 256), torch.int32),
)
SEED = 5


def copy_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the copy kernel."""
    return x.clone(memory_format=torch.contiguous_format)


def copy(x: torch.Tensor) -> torch.Tensor:
    """A new tensor equal to x.  CPU tensors take the plain version; CUDA
    tensors launch csrc/copy.cu (contiguous, 16-byte aligned input)."""
    global LAUNCHES
    if x.device.type == "cpu":
        return copy_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"copy: unsupported device {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("copy: x must be contiguous and 16-byte aligned")
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    n_bytes = x.numel() * x.element_size()
    if n_bytes == 0:
        return out
    lib = _build.kernels()
    rc = lib.reverie_copy(x.data_ptr(), out.data_ptr(), n_bytes,
                          torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "copy kernel")
    LAUNCHES += 1
    return out


def random_tensor(shape, dtype: torch.dtype, device: torch.device, seed: int) -> torch.Tensor:
    """Uniform random bits of an integer `dtype`, made on `device` from
    `seed` as random bytes."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n_bytes = int(np.prod(shape)) * torch.iinfo(dtype).bits // 8
    raw = torch.randint(0, 256, (n_bytes,), dtype=torch.uint8, device=device, generator=gen)
    return raw.view(dtype).reshape(shape)


def run(device: torch.device, cases: Sequence = CASES) -> List[Dict]:
    """Copy each case's array and time it; the copy must equal its input."""
    rows = []
    for name, shape, dtype in cases:
        x = random_tensor(shape, dtype, device, SEED)
        n_bytes = x.numel() * x.element_size()
        y = copy(x)
        equal = bool(torch.equal(y, x))
        del y
        t_copy = cuda_ms(lambda: copy(x), device)
        t_lib = cuda_ms(lambda: torch.empty_like(x).copy_(x), device)
        t_xor = cuda_ms(lambda: copy(x ^ 0x5A), device)
        rows.append({
            "probe": "r4_bwroof", "case": name, "shape": list(shape),
            "dtype": str(dtype), "bytes": n_bytes, "equal": equal,
            "copy_ms": t_copy, "copy_gbps": gbps(2 * n_bytes, t_copy),
            "library_ms": t_lib, "library_gbps": gbps(2 * n_bytes, t_lib),
            "xor_copy_ms": t_xor, "xor_copy_gbps": gbps(4 * n_bytes, t_xor),
        })
        if not equal:
            raise AssertionError(f"r4_bwroof {name}: the copy differs from its input")
        del x
    return rows


def main() -> int:
    print_results(run(default_device()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
