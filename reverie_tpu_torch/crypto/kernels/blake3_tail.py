"""Launchers of csrc/blake3_tail.cu, the tail of the per-column BLAKE3 on
CUDA tensors: the tree over a stream's node CVs with its last chunk (one
launch a stream), the CV stack of an unfinished stream, and the pair
hashes.  Their plain versions, and the CPU path, are the torch tail of
crypto/kernels/blake3.py, which dispatches here for CUDA tensors; these
functions take CUDA tensors only and raise on anything else.

`levels` is blake3.py's node list: levels[j] an (8, c_j, R) int32 tensor of
node CVs at height j (0: chunks), left to right, each level's nodes left
of those of the level below; above level 0 at most one node a height (the
CV stack, as blake3.ColumnHasher and hash_columns hold it).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from ... import _build

#: kernel launches made by this module's functions
LAUNCHES = 0

#: the heights the kernel's CV stack holds (a stream of fewer than 2^64 chunks)
MAX_HEIGHT = 64


def _check_nodes(x: torch.Tensor, R: int, device: torch.device, what: str) -> None:
    if x.device != device or x.dtype != torch.int32 or x.dim() != 3 or x.shape[0] != 8 \
            or x.shape[2] != R or (R > 1 and x.stride(2) != 1):
        raise ValueError(f"{what}: node CVs must be (8, n, {R}) int32 tensors on {device} "
                         "with their columns contiguous")


def _stack_args(levels: List[torch.Tensor], R: int, device: torch.device):
    """(node pointers, their plane strides, level 0, the chunks under the
    stack's nodes) for the kernel."""
    if not levels:
        levels = [torch.empty((8, 0, R), dtype=torch.int32, device=device)]
    if len(levels) > MAX_HEIGHT:
        raise ValueError(f"blake3_tail: more than {MAX_HEIGHT} levels")
    nodes = (ctypes.c_void_p * MAX_HEIGHT)()
    planes = (ctypes.c_longlong * MAX_HEIGHT)()
    p0 = 0
    for j, x in enumerate(levels):
        _check_nodes(x, R, device, "blake3_tail")
        if j == 0 or x.shape[1] == 0:
            continue
        if x.shape[1] > 1:
            raise ValueError("blake3_tail: at most one node a height above level 0")
        nodes[j], planes[j] = x.data_ptr(), x.stride(0)
        p0 += 1 << j
    return nodes, planes, levels[0], p0


def _launch_tree(levels: List[torch.Tensor], R: int, device: torch.device,
                 tail: Optional[torch.Tensor], tail_len: int, hash_out: Optional[torch.Tensor],
                 stack_out: Optional[torch.Tensor]) -> int:
    """One launch of blake3_tail_kernel; returns the chunks the levels hold."""
    global LAUNCHES
    nodes, planes, level0, p0 = _stack_args(levels, R, device)
    c0 = level0.shape[1]
    if R == 0:
        return p0 + c0
    lib = _build.kernels()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.reverie_blake3_tail(
            nodes, planes, level0.data_ptr() if c0 else None, c0, level0.stride(0),
            level0.stride(1), p0, None if tail is None else tail.data_ptr(),
            0 if tail is None else tail.stride(0), tail_len, R,
            None if hash_out is None else hash_out.data_ptr(),
            None if stack_out is None else stack_out.data_ptr(),
            0 if stack_out is None else stack_out.shape[1], stream)
    _build.check(rc, "blake3_tail kernel")
    LAUNCHES += 1
    return p0 + c0


def _cuda_device(t: torch.Tensor, what: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: needs CUDA tensors, got {t.device}")
    return t.device


def finalize(levels: List[torch.Tensor], rem: torch.Tensor, rem_len: int) -> torch.Tensor:
    """(R, 32) uint8 per-column hashes of a stream whose chunks but the last
    are levels' nodes and whose last chunk is rem's first rem_len rows
    ((>= rem_len, R) uint8, rows of one column rem.stride(0) apart; its
    counter the chunks the levels hold).  One launch."""
    device = _cuda_device(rem, "blake3_tail.finalize")
    R = rem.shape[1] if rem.dim() == 2 else -1
    if rem.dtype != torch.uint8 or R < 0 or (R > 1 and rem.stride(1) != 1) \
            or not 0 <= rem_len <= min(rem.shape[0], 1024):
        raise ValueError("blake3_tail.finalize: rem must be a (>= rem_len, R) uint8 tensor "
                         "with contiguous columns, 0 <= rem_len <= 1024")
    out = torch.empty((R, 32), dtype=torch.uint8, device=device)
    _launch_tree(levels, R, device, rem, rem_len, out, None)
    return out


def stack(levels: List[torch.Tensor]) -> List[torch.Tensor]:
    """The CV stack of levels' nodes (`_tree_reduce(root=False)`): a new
    levels list with one node at each height whose bit the chunk count has
    (views of one (8, n, R) tensor) and none at the others.  One launch."""
    if not levels:
        raise ValueError("blake3_tail.stack: no levels")
    device = _cuda_device(levels[0], "blake3_tail.stack")
    R = levels[0].shape[2] if levels[0].dim() == 3 else -1
    _check_nodes(levels[0], R, device, "blake3_tail.stack")
    n = sum(x.shape[1] << j for j, x in enumerate(levels))
    heights = [j for j in range(n.bit_length()) if n >> j & 1]
    out = torch.empty((8, len(heights), R), dtype=torch.int32, device=device)
    _launch_tree(levels, R, device, None, 0, None, out)
    new = [out.new_empty((8, 0, R)) for _ in range(max(1, n.bit_length()))]
    for i, j in enumerate(reversed(heights)):
        new[j] = out[:, i : i + 1]
    return new


def pairs(a: torch.Tensor, b: torch.Tensor, c: Optional[torch.Tensor] = None,
          d: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(R, 32) uint8: blake3(a_r || b_r) per row, or with c and d
    blake3(blake3(a_r || b_r) || blake3(c_r || d_r)).  One launch."""
    global LAUNCHES
    ins: Tuple[torch.Tensor, ...] = (a, b) if c is None and d is None else (a, b, c, d)
    device = _cuda_device(a, "blake3_tail.pairs")
    R = a.shape[0]
    for x in ins:
        if x is None or x.device != device or x.dtype != torch.uint8 \
                or tuple(x.shape) != (R, 32) or not x.is_contiguous():
            raise ValueError(f"blake3_tail.pairs: inputs must be contiguous ({R}, 32) uint8 "
                             f"tensors on {device}")
    out = torch.empty((R, 32), dtype=torch.uint8, device=device)
    if R == 0:
        return out
    lib = _build.kernels()
    ptrs = [x.data_ptr() for x in ins] + [None] * (4 - len(ins))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.reverie_blake3_tail_pairs(*ptrs, out.data_ptr(), R, stream)
    _build.check(rc, "blake3_tail pairs kernel")
    LAUNCHES += 1
    return out
