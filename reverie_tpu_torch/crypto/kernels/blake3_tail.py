"""Launcher of csrc/blake3_tail.cu, the tail of the per-column BLAKE3 on
CUDA tensors: one launch hashes a leg's streams and pairs their hashes
(`leg`), and the same kernel serves one stream's hash (`finalize`), the CV
stack of an unfinished stream (`stack`) and the pair hashes of given rows
(`pairs`).  Their plain versions, and the CPU path, are the torch tail of
crypto/kernels/blake3.py, which dispatches here for CUDA tensors; these
functions take CUDA tensors only and raise on anything else.

An input of a launch is a stream, (levels, rem, rem_len), or the (R, 32)
uint8 hashes of one given as they are (the committed online hashes of a
preprocessing verify).  `levels` is blake3.py's node list: levels[j] an
(8, c_j, R) int32 tensor of node CVs at height j (0: chunks), left to
right, each level's nodes left of those of the level below; above level 0
at most one node a height (the CV stack, as blake3.ColumnHasher and
hash_columns hold it).  rem is the stream's last chunk, its first rem_len
rows of a (>= rem_len, R) uint8 tensor.

`plan` cuts the work and `pieces` / `merge_order` are the schedule the
kernel runs; `model` runs that schedule with blake3.py's torch `compress`,
so that the CPU tests hold the kernel's order of work to the reference.
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ... import _build

#: kernel launches made by this module's functions
LAUNCHES = 0

#: the heights a CV stack holds (a stream of fewer than 2^64 chunks)
MAX_HEIGHT = 64
#: threads a block (the kernel's __launch_bounds__)
MAX_THREADS = 512
#: the SMs and the registers a thread that `plan` assumes where it is given
#: no card (the CPU tests and `model`): an H100 SXM's 132 and ptxas's count
#: for blake3_tail_kernel on sm_90a; a launch plans with its card's (`card`)
SMS, REGISTERS = 132, 80
#: compressions an SM completes in one compression's latency once four warps
#: compress (H100: 0.60 us a compression alone, 222 a us an SM)
COMPRESSIONS_PER_LATENCY = 128
#: adjacent columns a block: 8 x 4 bytes fill a 32-byte sector of a node word
MAX_COLUMNS = 8
#: a piece holds at most 2^MAX_PIECE nodes (the kernel's per-lane stack)
MAX_PIECE = 12
#: CV-stack nodes of one launch, all inputs together
MAX_STACK = 64
#: inputs of a launch: pre2, onl2, prez, onlz
MAX_INPUTS = 4
#: int64 words of the launch array: a header, 16 an input, 4 a stack node
HEADER_WORDS, INPUT_WORDS, STACK_WORDS = 16, 16, 4
#: shared memory of a lane's node (8 words, its height and next) and of a
#: column's input roots
NODE_SMEM, ROOTS_SMEM = 40, MAX_INPUTS * 32

Stream = Tuple[List[torch.Tensor], torch.Tensor, int]
Input = Union[Stream, torch.Tensor]


# -- the schedule ----------------------------------------------------------


def piece_height(q: int, end: int, k: int) -> int:
    """The height of the aligned piece of level 0 that starts at chunk
    q < end: as large as q's alignment, k and the nodes left allow."""
    h = min((q & -q).bit_length() - 1, k) if q else k
    while q + (1 << h) > end:
        h -= 1
    return h


def pieces(p0: int, c0: int, k: int) -> List[Tuple[int, int]]:
    """(first chunk, height) of the pieces of level 0's nodes p0 .. p0 + c0
    - 1, left to right: aligned runs of at most 2^k nodes, each reduced
    by one lane."""
    out, q, end = [], p0, p0 + c0
    while q < end:
        h = piece_height(q, end, k)
        out.append((q, h))
        q += 1 << h
    return out


def piece_at(p0: int, end: int, k: int, i: int) -> Tuple[int, int]:
    """The i-th of `pieces(p0, end - p0, k)` as the kernel finds it: the
    ragged left pieces walked, the whole ones of 2^k counted, the ragged
    right ones walked (at most k steps each side)."""
    q, mask = p0, (1 << k) - 1
    while i > 0 and q & mask:
        q += 1 << piece_height(q, end, k)
        i -= 1
    if not q & mask:
        whole = (end - q) >> k
        if i < whole:
            return q + (i << k), k
        q += whole << k
        i -= whole
    while i > 0:
        q += 1 << piece_height(q, end, k)
        i -= 1
    return q, piece_height(q, end, k)


def piece_index(p0: int, end: int, k: int, q: int) -> int:
    """The index in `pieces(p0, end - p0, k)` of the piece that starts at
    chunk q, as the kernel finds it (piece_at's walk the other way): the
    lane that holds the CV stack's node there once it is formed."""
    mask, i, x = (1 << k) - 1, 0, p0
    while x < q and x & mask:
        x += 1 << piece_height(x, end, k)
        i += 1
    if x < q:
        whole = min((q - x) >> k, (end - x) >> k)
        i, x = i + whole, x + (whole << k)
    while x < q:
        x += 1 << piece_height(x, end, k)
        i += 1
    return i


def holder_item(s: Shape, n: int, j: int, k: int) -> int:
    """The item that holds the CV stack's node of height j of n chunks (its
    first chunk n with bits 0..j cleared) once it is formed: a CV-stack
    node before p0, else a piece (the kernel's `holder`)."""
    q = n >> (j + 1) << (j + 1)
    return bin(q).count("1") if q < s.p0 else s.n_stack + piece_index(s.p0, n, k, q)


def merge_order(items: Sequence[Tuple[int, int]]) -> Tuple[List[List[Tuple[int, int]]], List[int]]:
    """The kernel's merge of a stream's nodes, (first chunk, height) left to
    right (the CV stack's nodes, then the pieces' roots): in each round
    every node that is a left child (its first chunk an even multiple of
    its size) and whose right neighbour has its height takes that
    neighbour in, all such pairs at once.  Returns the rounds' (left,
    right) item indices and the items left, left to right: the CV stack
    of the chunks (one node a set bit of their count; the kernel folds
    each into the last chunk's CV, right to left, as soon as it is
    formed)."""
    pos = [p for p, _ in items]
    h = [x for _, x in items]
    nxt = list(range(1, len(items))) + [-1]
    alive = list(range(len(items)))
    rounds = []
    while True:
        pairs = [(i, nxt[i]) for i in alive
                 if nxt[i] >= 0 and not (pos[i] >> h[i]) & 1 and h[nxt[i]] == h[i]]
        if not pairs:
            return rounds, alive
        rounds.append(pairs)
        for i, j in pairs:
            h[i] += 1
            nxt[i] = nxt[j]
        gone = {j for _, j in pairs}
        alive = [i for i in alive if i not in gone]


def stack_items(levels: Sequence[torch.Tensor]) -> Tuple[List[Tuple[int, int]], int]:
    """The CV stack's (first chunk, height) items above level 0, highest
    first, and p0, the chunks under them."""
    items, p0 = [], 0
    for j in range(len(levels) - 1, 0, -1):
        if levels[j].shape[1]:
            items.append((p0, j))
            p0 += 1 << j
    return items, p0


def tail_pad(tail_len: int) -> int:
    """Bytes of a last chunk of tail_len bytes staged in shared memory: its
    blocks, zero-padded (one block of zeros for an empty chunk)."""
    return 64 * max(1, -(-tail_len // 64))


class Shape(NamedTuple):
    """What the plan needs of an input: its CV stack's nodes, p0, level 0's
    c0 nodes and its last chunk's bytes (None for a stack launch); None in
    place of a Shape is an input of given hashes."""

    n_stack: int
    p0: int
    c0: int
    tail_len: Optional[int]


class TailPlan(NamedTuple):
    """A launch of blake3_tail_kernel: C adjacent columns a block, all of
    their inputs' lanes in it (lanes of one slot on adjacent columns);
    level 0 cut into pieces of at most 2^k nodes; `items` each input's
    nodes (CV stack and pieces) and `slots` a column's lanes (the items
    and one more an input: its last chunk, fold and hash)."""

    R: int
    C: int
    k: int
    items: Tuple[int, ...]
    slots: int
    threads: int
    blocks: int
    smem: int

    def line(self) -> str:
        return (f"C={self.C} k={self.k} items={list(self.items)} slots={self.slots} "
                f"threads={self.threads} blocks={self.blocks} smem={self.smem}")


def columns_per_block(R: int, sms: int = SMS) -> int:
    """The most adjacent columns a block (at most MAX_COLUMNS) that still
    leave the grid a block for 3/4 of the sms SMs; one at small R.  (A block of
    C columns reads C x 4 bytes of each 32-byte sector of a node word: on
    the H100 2 columns on 108 SMs beat 1 on 132, 4 on 64 lose to 2 on
    128.)"""
    C = MAX_COLUMNS
    while C > 1 and -(-R // C) < sms * 3 // 4:
        C //= 2
    return C


def plan_at(R: int, shapes: Sequence[Optional[Shape]], C: int, k: int) -> TailPlan:
    """The launch of C adjacent columns a block and pieces of at most 2^k
    nodes (whether or not it fits a block: `plan` checks)."""
    items = tuple(0 if s is None else s.n_stack + len(pieces(s.p0, s.c0, k)) for s in shapes)
    slots = sum(items) + len(shapes)
    threads = -(-C * slots // 32) * 32
    tail_bytes = sum(C * tail_pad(s.tail_len) for s in shapes
                     if s is not None and s.tail_len is not None)
    smem = threads * NODE_SMEM + C * ROOTS_SMEM + tail_bytes
    return TailPlan(R, C, k, items, slots, threads, -(-R // C), smem)


@functools.lru_cache(maxsize=1024)
def plan(R: int, shapes: Tuple[Optional[Shape], ...], sms: int = SMS,
         registers: int = REGISTERS) -> TailPlan:
    """The launch plan at R columns on a card of sms SMs, the kernel
    holding `registers` a thread.  C from R (columns_per_block), halved
    while no piece height fits a column's lanes into a block; then the
    piece height k (at most MAX_PIECE, and leaving the longest stream at
    least min(16, c0 / 4) pieces, so that its loads have lanes enough) of
    the least estimated time, in compression latencies: for each wave of
    the blocks the SMs hold at once, the longer of the
    SM's compressions at COMPRESSIONS_PER_LATENCY and a lane's longest
    chain (its piece or its last chunk), then two a merge round; the least
    k of equal estimates.  Raises ValueError where even one column's lanes
    at k = MAX_PIECE do not fit a block."""
    C = columns_per_block(R, sms)
    streams = [s for s in shapes if s is not None]
    tails = [tail_pad(s.tail_len) // 64 for s in streams if s.tail_len is not None]
    work = sum(s.n_stack + s.c0 for s in streams) + sum(tails) + 3  # a column's compressions
    c0 = max([s.c0 for s in streams] + [0])
    while True:
        best = None
        for k in range(MAX_PIECE + 1):
            cuts = [[] if s is None else pieces(s.p0, s.c0, k) for s in shapes]
            if c0 and max(len(c) for c in cuts) < min(16, c0 / 4) and best is not None:
                break
            p = plan_at(R, shapes, C, k)
            if p.threads > MAX_THREADS:
                continue
            per_sm = max(1, min(2048 // p.threads, 65536 // (p.threads * registers)))
            waves = max(1, -(-p.blocks // (sms * per_sm)))
            on_sm = min(p.blocks, sms * per_sm) / max(1, min(p.blocks, sms))
            longest = max([(1 << h) - 1 for c in cuts for _, h in c] + tails + [0])
            chain = max(C * work * on_sm / COMPRESSIONS_PER_LATENCY, longest)
            cost = waves * chain + 2 * max(p.items).bit_length()
            if best is None or cost < best[0]:
                best = (cost, p)
        if best is not None:
            return best[1]
        if C == 1:
            raise ValueError("blake3_tail: a column's streams need more lanes than a block "
                             f"holds at pieces of 2^{MAX_PIECE} nodes")
        C //= 2


# -- the schedule in torch (the CPU tests' model of the kernel) --------------


def model(inputs: Sequence[Input]) -> Tuple[torch.Tensor, List[Optional[torch.Tensor]]]:
    """The kernel's schedule run with blake3.py's torch `compress`, on any
    device: each input's pieces (`plan`'s cut) reduced, merged in
    `merge_order`'s rounds and folded with its last chunk, then the pair
    hashes.  Returns (the launch's output, each stream input's hashes)
    as `leg` does."""
    from . import blake3 as b3

    def node(left, right, flags):
        iv = b3._iv(left.device).view(8, *[1] * (left.dim() - 1))
        return b3.compress(iv, torch.cat([left, right]), 0, 64, flags)

    R, shapes = _shapes(inputs)
    p = plan(R, tuple(shapes))
    roots, hashes = [], []
    for x, s in zip(inputs, shapes):
        if s is None:
            roots.append(b3._bytes_to_words(x.t().contiguous()))
            hashes.append(None)
            continue
        levels, rem, rem_len = x
        items = stack_items(levels)[0]
        cvs = [b3._from_i32(levels[j][:, 0]) for _, j in items]
        for q, h in pieces(s.p0, s.c0, p.k):
            nodes = b3._from_i32(levels[0][:, q - s.p0 : q - s.p0 + (1 << h)])
            while nodes.shape[1] > 1:
                nodes = node(nodes[:, 0::2], nodes[:, 1::2], b3.PARENT)
            cvs.append(nodes[:, 0])
            items.append((q, h))
        rounds, live = merge_order(items)
        for pairs in rounds:
            for i, j in pairs:
                cvs[i] = node(cvs[i], cvs[j], b3.PARENT)
        n = s.p0 + s.c0
        cv = b3._tail_cv(rem, rem_len, n, n == 0)
        bits = [j for j in range(n.bit_length()) if n >> j & 1]
        for j in bits:  # the fold, right to left, by the lane that holds each node
            i = holder_item(s, n, j, p.k)
            assert i in live and items[i][0] == n >> (j + 1) << (j + 1)
            cv = node(cvs[i], cv, b3.PARENT | (b3.ROOT if j == bits[-1] else 0))
        roots.append(cv)
        hashes.append(b3._rows_to_bytes(cv))
    pair = b3.CHUNK_START | b3.CHUNK_END | b3.ROOT
    out = roots[0]
    if len(roots) >= 2:
        out = node(roots[0], roots[1], pair)
    if len(roots) == 4:
        out = node(out, node(roots[2], roots[3], pair), pair)
    return b3._rows_to_bytes(out), hashes


# -- the launch ------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def card(index: int) -> Tuple[int, int]:
    """(SMs, registers a thread of blake3_tail_kernel) of CUDA device
    `index`, read once: what a launch's `plan` takes."""
    lib = _build.kernels()
    with torch.cuda.device(index):
        registers = lib.reverie_blake3_tail_registers()
    if registers <= 0:
        raise RuntimeError("blake3_tail: the kernel's registers could not be read")
    return torch.cuda.get_device_properties(index).multi_processor_count, registers


def launch_plan(inputs: Sequence[Input]) -> TailPlan:
    """The plan of a launch on these inputs (CUDA tensors, as `leg` takes
    them): `plan` with their card's SMs and the kernel's registers."""
    first = inputs[0] if isinstance(inputs[0], torch.Tensor) else inputs[0][1]
    R, shapes = _shapes(inputs)
    return plan(R, tuple(shapes), *card(_cuda_device(first, "blake3_tail").index))


def _check_nodes(x: torch.Tensor, R: int, device: torch.device, what: str) -> None:
    if x.device != device or x.dtype != torch.int32 or x.dim() != 3 or x.shape[0] != 8 \
            or x.shape[2] != R or (R > 1 and x.stride(2) != 1):
        raise ValueError(f"{what}: node CVs must be (8, n, {R}) int32 tensors on {device} "
                         "with their columns contiguous")


def _check_rows(x: torch.Tensor, R: int, device: torch.device, what: str) -> None:
    if x.device != device or x.dtype != torch.uint8 or tuple(x.shape) != (R, 32) \
            or not x.is_contiguous():
        raise ValueError(f"{what}: hashes must be contiguous ({R}, 32) uint8 tensors on {device}")


def _cuda_device(t: torch.Tensor, what: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: needs CUDA tensors, got {t.device}")
    return t.device


def _shapes(inputs: Sequence[Input]) -> Tuple[int, List[Optional[Shape]]]:
    """(R, each input's Shape) of a launch's inputs."""
    R = inputs[0].shape[0] if isinstance(inputs[0], torch.Tensor) else inputs[0][1].shape[1]
    shapes: List[Optional[Shape]] = []
    for x in inputs:
        if isinstance(x, torch.Tensor):
            shapes.append(None)
            continue
        levels, _, rem_len = x
        items, p0 = stack_items(levels)
        c0 = levels[0].shape[1] if levels else 0
        shapes.append(Shape(len(items), p0, c0, rem_len))
    return R, shapes


def _input_words(x: Input, s: Optional[Shape], R: int, device: torch.device, what: str):
    """The input's launch words but its lane offsets, and its stack nodes
    (pointer, plane, first chunk, height)."""
    w = [0] * INPUT_WORDS
    if s is None:
        _check_rows(x, R, device, what)
        w[8] = x.data_ptr()
        return w, []
    levels, rem, rem_len = x
    if len(levels) > MAX_HEIGHT:
        raise ValueError(f"{what}: more than {MAX_HEIGHT} levels")
    for j, lv in enumerate(levels):
        _check_nodes(lv, R, device, what)
        if j and lv.shape[1] > 1:
            raise ValueError(f"{what}: at most one node a height above level 0")
    nodes = [(levels[j].data_ptr(), levels[j].stride(0), q, j)
             for q, j in stack_items(levels)[0]]
    if s.c0:
        w[0:4] = [levels[0].data_ptr(), s.c0, levels[0].stride(0), levels[0].stride(1)]
    w[4] = s.p0
    if s.tail_len is not None:
        if rem.device != device or rem.dtype != torch.uint8 or rem.dim() != 2 \
                or rem.shape[1] != R or (R > 1 and rem.stride(1) != 1) \
                or not 0 <= rem_len <= min(rem.shape[0], 1024):
            raise ValueError(f"{what}: the last chunk must be a (>= rem_len, {R}) uint8 tensor "
                             f"on {device} with contiguous columns, 0 <= rem_len <= 1024")
        w[5:8] = [rem.data_ptr() if rem_len else 0, rem.stride(0), rem_len]
    return w, nodes


def launch_words(inputs: Sequence[Input], want: Sequence[int] = (),
                 stack_out: Optional[torch.Tensor] = None, p: Optional[TailPlan] = None):
    """(the int64 launch words, the output, `want`'s hashes, the plan) of a
    launch of blake3_tail_kernel on 1, 2 or 4 inputs (`_launch`), its
    outputs allocated; the words None at R = 0.  p: the plan (by default
    `plan`'s on the inputs' card)."""
    if len(inputs) not in (1, 2, 4):
        raise ValueError("blake3_tail: a launch takes 1, 2 or 4 inputs")
    first = inputs[0] if isinstance(inputs[0], torch.Tensor) else inputs[0][1]
    device = _cuda_device(first, "blake3_tail")
    R, shapes = _shapes(inputs)
    if stack_out is not None:
        shapes = [s._replace(tail_len=None) for s in shapes]
    words = np.zeros(HEADER_WORDS + MAX_INPUTS * INPUT_WORDS + MAX_STACK * STACK_WORDS, np.int64)
    stack: List[Tuple[int, int, int, int]] = []
    per_input = []
    for x, s in zip(inputs, shapes):
        w, nodes = _input_words(x, s, R, device, "blake3_tail")
        w[12], w[13] = len(stack), len(nodes)
        stack += nodes
        per_input.append(w)
    if len(stack) > MAX_STACK:
        raise ValueError(f"blake3_tail: more than {MAX_STACK} CV-stack nodes in one launch")
    out = torch.empty((R, 32), dtype=torch.uint8, device=device)
    hashes = {i: torch.empty((R, 32), dtype=torch.uint8, device=device) for i in want}
    p = plan(R, tuple(shapes), *card(device.index)) if p is None else p
    if R == 0:
        return None, out, hashes, p
    slot0 = tail0 = 0
    for i, (w, s) in enumerate(zip(per_input, shapes)):
        w[9] = hashes[i].data_ptr() if i in hashes else 0
        w[10], w[11], w[14] = p.items[i], slot0, tail0
        slot0 += p.items[i] + 1
        if s is not None and s.tail_len is not None:
            tail0 += p.C * tail_pad(s.tail_len)
        base = HEADER_WORDS + i * INPUT_WORDS
        words[base : base + INPUT_WORDS] = w
    for e, node in enumerate(stack):
        base = HEADER_WORDS + MAX_INPUTS * INPUT_WORDS + e * STACK_WORDS
        words[base : base + STACK_WORDS] = node
    words[:12] = [len(inputs), R, p.C, p.k, p.slots, p.threads, p.blocks, p.smem,
                  0 if stack_out is not None else out.data_ptr(),
                  0 if stack_out is None else stack_out.data_ptr(),
                  0 if stack_out is None else stack_out.shape[1], len(stack)]
    return words, out, hashes, p


def _launch(inputs: Sequence[Input], want: Sequence[int] = (),
            stack_out: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict[int, torch.Tensor]]:
    """One launch of blake3_tail_kernel on 1, 2 or 4 inputs: the output is
    the one input's hash, H(x0 || x1), or H(H(x0 || x1) || H(x2 || x3)),
    (R, 32) uint8 (with stack_out: the one stream's CV stack written there
    instead); `want` the stream inputs whose own hashes are returned too."""
    global LAUNCHES
    words, out, hashes, _ = launch_words(inputs, want, stack_out)
    if words is None:
        return out, hashes
    device = out.device
    lib = _build.kernels()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.reverie_blake3_tail(words.ctypes.data, stream)
    _build.check(rc, "blake3_tail kernel")
    LAUNCHES += 1
    return out, hashes


def leg(inputs: Sequence[Input]) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                          Optional[torch.Tensor]]:
    """A hash leg in one launch: inputs (pre2, onl2, prez, onlz), each a
    stream or given (R, 32) hashes -> (H(H(pre2 || onl2) || H(prez ||
    onlz)), onl2's hashes, onlz's hashes): a stream's own hashes made by
    the launch, given ones returned as they are."""
    if len(inputs) != 4:
        raise ValueError("blake3_tail.leg: takes pre2, onl2, prez and onlz")
    want = [i for i in (1, 3) if not isinstance(inputs[i], torch.Tensor)]
    out, hashes = _launch(inputs, want)
    return out, hashes.get(1, inputs[1]), hashes.get(3, inputs[3])


def finalize(levels: List[torch.Tensor], rem: torch.Tensor, rem_len: int) -> torch.Tensor:
    """(R, 32) uint8 per-column hashes of a stream whose chunks but the last
    are levels' nodes and whose last chunk is rem's first rem_len rows
    ((>= rem_len, R) uint8, rows of one column rem.stride(0) apart; its
    counter the chunks the levels hold).  One launch."""
    _cuda_device(rem, "blake3_tail.finalize")
    if rem.dim() != 2:
        raise ValueError("blake3_tail.finalize: rem must be a (>= rem_len, R) uint8 tensor")
    return _launch([(levels, rem, rem_len)])[0]


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
    empty = torch.empty((0, R), dtype=torch.uint8, device=device)
    _launch([(levels, empty, 0)], stack_out=out)
    new = [out.new_empty((8, 0, R)) for _ in range(max(1, n.bit_length()))]
    for i, j in enumerate(reversed(heights)):
        new[j] = out[:, i : i + 1]
    return new


def pairs(a: torch.Tensor, b: torch.Tensor, c: Optional[torch.Tensor] = None,
          d: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(R, 32) uint8: blake3(a_r || b_r) per row, or with c and d
    blake3(blake3(a_r || b_r) || blake3(c_r || d_r)).  One launch."""
    ins = (a, b) if c is None and d is None else (a, b, c, d)
    _cuda_device(a, "blake3_tail.pairs")
    for x in ins:
        if not isinstance(x, torch.Tensor):
            raise ValueError("blake3_tail.pairs: takes two or four (R, 32) uint8 tensors")
    return _launch(ins)[0]
