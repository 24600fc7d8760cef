"""Per-column BLAKE3 of transcript buffers.

Port of reverie_tpu/crypto/kernels/blake3_jax.py (`hash_columns`,
`_bulk_cvs`, `_chunk_cvs`, `_tree_reduce`, `_rows_to_bytes`,
`hash_pair_columns`, and the streaming prover's incremental
`absorb_columns`, `finalize_columns` and `ColumnHasher`) and of the Pallas
kernel blake3_pallas.py:_fb_kernel / `chunk_cvs_from_bytes`, which becomes
the CUDA kernel csrc/blake3_chunks.cu.

A transcript buffer is a (T, R) uint8 tensor whose columns are the
per-repetition streams.  The whole chunks go through `chunk_cvs` (CPU
tensors: the plain version `chunk_cvs_ref`; CUDA tensors: the kernel, at
`plan`'s route, tiles and stages; `model` runs its staged read in torch for
the CPU tests).  The
rest of a stream's hash, its tail (the final partial chunk, the tree
reduction and the pair hashes; XLA in the reference), is plain torch on CPU
tensors (`finalize_columns_ref`, `_tree_reduce`, `hash_pair_columns_ref`,
`hash_leg_ref`) and on CUDA tensors the kernel of csrc/blake3_tail.cu
(crypto/kernels/blake3_tail.py): one launch a hash leg (`hash_leg`: its
streams' tails and the pair hashes), one for a stream's CV stack, one for
a stream or a pair hash alone.

Words are carried as int64 holding values in [0, 2^32) and masked after
every add and shift; the chunk CVs leave `chunk_cvs` as int32 (the kernel's
u32 bit patterns).
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from ... import _build
from . import blake3_tail

#: kernel launches made by `chunk_cvs` (CUDA tensors only; the tail's are
#: blake3_tail.LAUNCHES)
LAUNCHES = 0

IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)
MSG_PERM = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)
CHUNK_START, CHUNK_END, PARENT, ROOT = 1, 2, 4, 8
CHUNK_LEN = 1024
M32 = 0xFFFFFFFF


# per round, the message words of the column G mixes (x, y) and of the
# diagonal G mixes (x, y): round r reads m[_SCHED[r][...]]
_SCHED = []
_perm = list(range(16))
for _ in range(7):
    _SCHED.append([_perm[j] for j in (0, 2, 4, 6, 1, 3, 5, 7,
                                      8, 10, 12, 14, 9, 11, 13, 15)])
    _perm = [_perm[i] for i in MSG_PERM]


def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & M32


def _g(a, b, c, d, mx, my):
    """Four G mixes at once on (4, ...) rows."""
    a = (a + b + mx) & M32
    d = _rotr(d ^ a, 16)
    c = (c + d) & M32
    b = _rotr(b ^ c, 12)
    a = (a + b + my) & M32
    d = _rotr(d ^ a, 8)
    c = (c + d) & M32
    b = _rotr(b ^ c, 7)
    return a, b, c, d


def compress(cv, m, counter, block_len, flags):
    """One BLAKE3 compression on row tensors.  cv: (8, *S) int64 chaining
    value, m: (16, *S) int64 message words (both broadcastable to the
    batch shape S); counter/block_len/flags: ints or int64 tensors
    broadcastable to S.  Returns the (8, *S) chaining-value words
    v[i] ^ v[i + 8].  The 4 column mixes, then the 4 diagonal mixes, run as
    one op each on (4, *S) rows; the diagonal phase rolls rows b, c, d."""
    S = torch.broadcast_shapes(cv.shape[1:], m.shape[1:],
                               *(x.shape for x in (counter, block_len, flags)
                                 if isinstance(x, torch.Tensor)))
    dev = m.device
    cv = cv.expand(8, *S)
    a, b = cv[:4], cv[4:]
    c = _iv(dev)[:4].view(4, *[1] * len(S))
    d = torch.stack([_word(x, S, dev)
                     for x in (counter & M32, counter >> 32, block_len, flags)])
    ms = torch.stack([m[j] for sched in _SCHED for j in sched]).expand(16 * 7, *S)
    for rnd in range(7):
        w = ms[16 * rnd : 16 * rnd + 16]
        a, b, c, d = _g(a, b, c, d, w[0:4], w[4:8])
        b, c, d = b.roll(-1, 0), c.roll(-2, 0), d.roll(-3, 0)
        a, b, c, d = _g(a, b, c, d, w[8:12], w[12:16])
        b, c, d = b.roll(1, 0), c.roll(2, 0), d.roll(3, 0)
    return torch.cat([a ^ c, b ^ d])


@functools.lru_cache(maxsize=None)
def _iv(device: torch.device) -> torch.Tensor:
    """The IV words as an (8,) int64 tensor on `device` (made once: a
    host-to-device copy per compression would stall the stream)."""
    return torch.tensor(IV, dtype=torch.int64, device=device)


def _word(x, S, device) -> torch.Tensor:
    """An int or int64 tensor as a tensor of batch shape S."""
    if isinstance(x, torch.Tensor):
        return x.expand(S)
    return torch.full(S, x, dtype=torch.int64, device=device)


def _bytes_to_words(buf: torch.Tensor) -> torch.Tensor:
    """(4k, ...) uint8 -> (k, ...) int64 little-endian words."""
    b = buf.reshape(buf.shape[0] // 4, 4, *buf.shape[1:]).to(torch.int64)
    return b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)


def _to_i32(w: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 with the same bit pattern."""
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def _from_i32(w: torch.Tensor) -> torch.Tensor:
    return w.to(torch.int64) & M32


def chunk_cvs_ref(buf: torch.Tensor, n_chunks: int, chunk_base: int = 0
                  ) -> torch.Tensor:
    """Plain PyTorch version of the chunk kernel: CVs of the first n_chunks
    whole 1024-byte chunks of each column of buf (>= n_chunks*1024 rows, R)
    uint8, chunk i with counter chunk_base + i, non-root.  -> (8, n, R)
    int32."""
    R = buf.shape[1]
    n = n_chunks
    if buf.shape[0] < n * CHUNK_LEN:
        raise ValueError("buffer shorter than n_chunks*1024 rows")
    words = _bytes_to_words(buf[: n * CHUNK_LEN]).reshape(n, 16, 16, R)
    ctr = (chunk_base + torch.arange(n, dtype=torch.int64, device=buf.device))[:, None]
    cv = _iv(buf.device)[:, None, None]
    for blk in range(16):
        flags = (CHUNK_START if blk == 0 else 0) | (CHUNK_END if blk == 15 else 0)
        cv = compress(cv, words[:, blk].transpose(0, 1), ctr, 64, flags)
    return _to_i32(cv)


# -- the chunk kernel's plan (csrc/blake3_chunks.cu) --------------------------

#: the kernel's routes (csrc/blake3_chunks.cu Route), by index: a tile of
#: whole rows (`chunks` chunks x all R columns, R <= MAX_THREADS), one copy a
#: chunk, its rows at the runtime pitch R, or at a compile-time pitch for the
#: verify legs' widths (ProtocolParams' 40 online and 216 preprocessing reps);
#: a tile of one chunk x ROW_COLS columns: for R a multiple of 16 on a
#: 16-byte-aligned buffer one 2-D tensor copy a stage, rows at the pitch
#: ROW_COLS ("rows"); on any other buffer past MAX_THREADS columns a copy a
#: row at the pitch ROW_PITCH, each at its own offset mod 16 ("rows_shifted")
ROUTES = ("span", "span40", "span216", "rows", "rows_shifted")
SPAN_PITCHES = {40: 1, 216: 2}
#: threads a block (the kernel's __launch_bounds__) and stages a ring at most
MAX_THREADS, MAX_STAGES = 256, 4
#: columns of a tile on the rows routes, and the row pitch of rows_shifted
#: (the columns and 16 bytes of alignment)
ROW_COLS, ROW_PITCH = 128, 144
#: the most rows the rows route's tensor copies reach (their coordinates are
#: int32)
MAX_TENSOR_ROWS = 2**31 - 1
#: the SMs and registers a thread that `plan` assumes where it is given no
#: card (the CPU tests and `model`): an H100 SXM's 132 and the kernel's
#: __launch_bounds__ cap; a launch plans with its card's (`card`)
SMS, REGISTERS = 132, 64
#: an H100's shared memory: an SM's, a block's at most, and what the runtime
#: keeps of an SM's a block; the kernel's barriers after its ring
SMEM_PER_SM, SMEM_PER_BLOCK, SMEM_RESERVED = 233_472, 232_448, 1_024
BARRIER_BYTES = 8 * MAX_STAGES
#: warps an SM needs to compress at its full rate (blake3_tail: four warps
#: fill its issue, 128 compressions a compression's latency an SM)
SATURATION_WARPS = 4


class ChunkPlan(NamedTuple):
    """A launch of csrc/blake3_chunks.cu on R columns of n chunks whose
    buffer lies `delta` bytes past a 16-byte boundary: one block a tile of
    `chunks` chunks x `cols` columns (a thread a (chunk, column)), a ring of
    `stages` stages of `chunk_stage` bytes a chunk; `per_sm` blocks an SM
    holds; `cost` the estimate `plan` minimised, in compression latencies."""

    R: int
    n: int
    delta: int
    route: int
    cols: int
    chunks: int
    chunk_stage: int
    stages: int
    threads: int
    blocks: int
    smem: int
    per_sm: int
    cost: float

    @property
    def col_tiles(self) -> int:
        return -(-self.R // self.cols)

    def line(self) -> str:
        return (f"route={ROUTES[self.route]} tile={self.chunks}x{self.cols} "
                f"stages={self.stages} chunk_stage={self.chunk_stage} threads={self.threads} "
                f"blocks={self.blocks} smem={self.smem} per_sm={self.per_sm}")


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def chunk_stage_bytes(route: int, R: int, delta: int) -> int:
    """A chunk's bytes in a stage.  Rows routes: 64 rows at their pitch.  Span
    routes: the 16-byte-aligned run of its 64 rows (delta + 64 R bytes),
    rounded up so that the next chunk's rows start 16 * ceil(R / 16) bytes
    on, mod 128, from this one's: a warp's lanes in two chunks then read
    other banks."""
    if route == ROUTES.index("rows"):
        return 64 * ROW_COLS
    if route > ROUTES.index("rows"):
        return 64 * ROW_PITCH
    run = _round16(delta + 64 * R)
    return run + (16 * -(-R // 16) - run) % 128


def _estimate(blocks: int, threads: int, per_sm: int, sms: int) -> float:
    """The busiest SM's time in compression latencies: the block scheduler
    hands each free slot the next tile, so it runs ceil(blocks / sms) of
    them; at SATURATION_WARPS warps or more it retires four warp-compressions
    a latency, fewer warps proportionally fewer; and no round of its
    resident tiles takes less than their chains of 16 compressions and a
    copy's latency."""
    warps = threads // 32
    load = -(-blocks // sms)
    live = min(load, per_sm) * warps
    busy = load * warps * 16 / (4 * min(1.0, live / SATURATION_WARPS))
    return max(busy, -(-load // per_sm) * 17.0)


def plan_at(R: int, n: int, delta: int, route: int, chunks: int = 1,
            stages: Optional[int] = None, sms: int = SMS,
            registers: int = REGISTERS) -> ChunkPlan:
    """The launch on route `route` with tiles of `chunks` chunks (one on the
    rows routes), and `stages` stages (None: the most, up to MAX_STAGES,
    that keep the blocks an SM holds by its registers and threads)."""
    rows = route >= ROUTES.index("rows")
    cols = ROW_COLS if rows else R
    chunks = 1 if rows else max(1, min(chunks, n))
    threads = ROW_COLS if rows else 32 * -(-chunks * R // 32)
    cs = chunk_stage_bytes(route, R, delta)
    blocks = -(-n // chunks) * -(-R // cols)
    by_regs = max(1, min(2048 // threads, 32, 65536 // (threads * -(-registers // 8) * 8)))

    def held(s):
        smem = s * chunks * cs + BARRIER_BYTES
        return smem, (0 if smem > SMEM_PER_BLOCK else
                      min(by_regs, SMEM_PER_SM // (smem + SMEM_RESERVED)))

    if stages is None:
        stages = max([s for s in range(2, MAX_STAGES + 1) if held(s)[1] == held(2)[1]] or [2])
    smem, per_sm = held(stages)
    cost = _estimate(blocks, threads, per_sm, sms) if per_sm else float("inf")
    return ChunkPlan(R, n, delta, route, cols, chunks, cs, stages, threads, blocks, smem,
                     per_sm, cost)


@functools.lru_cache(maxsize=1024)
def plan(R: int, n: int, delta: int = 0, sms: int = SMS, registers: int = REGISTERS) -> ChunkPlan:
    """The launch plan of `chunk_cvs` at R >= 1 columns of n >= 1 chunks, the
    buffer `delta` = data_ptr mod 16 bytes past a 16-byte boundary, on a
    card of sms SMs, the kernel holding `registers` a thread.  The route
    follows R and the alignment: span (span40, span216 at those widths) with
    whole rows for R <= MAX_THREADS; rows for R a multiple of 16 on an
    aligned buffer (delta 0) of at most MAX_TENSOR_ROWS rows of chunks;
    rows_shifted for any other buffer past
    MAX_THREADS (a copy a row: a tile's 64 copies a stage issue one by one,
    so it comes last).  Of
    the span tiles (1 to MAX_THREADS // R chunks) and the rows tile, the
    least `_estimate`, then a compile-time pitch, then the fewest threads a
    block (where the estimates tie the smaller tiles spread over more SMs),
    then the most stages.  delta also sizes a span chunk's stage and the
    rows' copies (every route takes any alignment: the 1-D copies move
    16-byte-aligned runs)."""
    cands = []
    if R <= MAX_THREADS:
        route = SPAN_PITCHES.get(R, 0)
        cands += [plan_at(R, n, delta, route, ct, None, sms, registers)
                  for ct in range(1, min(n, MAX_THREADS // R) + 1)]
    if R % 16 == 0 and delta == 0 and n * CHUNK_LEN <= MAX_TENSOR_ROWS:
        rows = "rows"
    else:
        rows = "rows_shifted" if R > MAX_THREADS else None
    if rows:
        cands.append(plan_at(R, n, delta, ROUTES.index(rows), 1, None, sms, registers))
    runtime_pitch = (ROUTES.index("span"), ROUTES.index("rows_shifted"))
    return min(cands, key=lambda p: (round(p.cost, 6), p.route in runtime_pitch, p.threads,
                                     -p.stages))


def tile(p: ChunkPlan, block: int) -> Tuple[int, int, int, int]:
    """(first chunk, chunks, first column, columns) of a block's tile."""
    group, ct = divmod(block, p.col_tiles)
    c0, r0 = group * p.chunks, ct * p.cols
    return c0, min(p.chunks, p.n - c0), r0, min(p.cols, p.R - r0)


def copies(p: ChunkPlan, block: int, step: int) -> List[Tuple[int, int, int]]:
    """(offset in the stage, offset from the buffer's 16-byte boundary,
    bytes) of each copy that fills a stage with block `step` of a tile: the
    16-byte-aligned runs of device memory that hold a chunk's 64 rows (span
    routes) or each row's columns (rows_shifted); on rows the rows of the
    tile's one 2-D copy (its box's columns past R are zeros)."""
    c0, chunks, r0, cols = tile(p, block)
    if p.route < ROUTES.index("rows"):
        n_bytes = _round16(p.delta + 64 * p.R)
        return [(j * p.chunk_stage, ((c0 + j) * CHUNK_LEN + 64 * step) * p.R, n_bytes)
                for j in range(chunks)]
    if p.route == ROUTES.index("rows"):
        return [(row * ROW_COLS, (c0 * CHUNK_LEN + 64 * step + row) * p.R + r0, cols)
                for row in range(64)]
    out = []
    for j in range(chunks):
        for row in range(64):
            off = ((c0 + j) * CHUNK_LEN + 64 * step + row) * p.R + r0 + p.delta
            lo = off & ~15
            out.append((j * p.chunk_stage + row * ROW_PITCH, lo, _round16(off - lo + cols)))
    return out


def read_offsets(p: ChunkPlan, block: int) -> torch.Tensor:
    """(chunks, columns, 64) stage offsets of the bytes a tile's threads read
    for rows 0..63 of a block, as the kernel reads them."""
    _, chunks, r0, cols = tile(p, block)
    j = torch.arange(chunks)[:, None, None]
    col = torch.arange(cols)[None, :, None]
    row = torch.arange(64)[None, None, :]
    if p.route == ROUTES.index("rows_shifted"):
        pitch, shift = ROW_PITCH, (p.delta + r0 + row * p.R) & 15
    else:
        pitch, shift = (ROW_COLS if p.route == ROUTES.index("rows") else p.R), p.delta
    return j * p.chunk_stage + row * pitch + shift + col


def model(buf: torch.Tensor, n_chunks: int, chunk_base: int, p: ChunkPlan) -> torch.Tensor:
    """The kernel's staged read, in torch on the CPU: device memory is buf's
    first n_chunks * 1024 rows p.delta bytes past a 16-byte boundary, with
    filler around them; each block's stages are filled by `copies` (which
    must stay inside the stage and not overlap) and its words assembled from
    `read_offsets`, four rows a word little-endian; then the plain
    compression, as `chunk_cvs_ref`.  -> (8, n_chunks, R) int32."""
    R, n = buf.shape[1], n_chunks
    size = n * CHUNK_LEN * R
    mem = torch.full((_round16(p.delta + size),), 0xA5, dtype=torch.uint8)
    mem[p.delta : p.delta + size] = buf[:n * CHUNK_LEN].reshape(-1)
    words = torch.empty((n, 16, 16, R), dtype=torch.int64)
    for block in range(p.blocks):
        c0, chunks, r0, cols = tile(p, block)
        offs = read_offsets(p, block)
        for step in range(16):
            stage = torch.full((p.chunks * p.chunk_stage,), 0x5A, dtype=torch.uint8)
            written = torch.zeros(stage.shape, dtype=torch.bool)
            for dst, src, n_bytes in copies(p, block, step):
                if dst % 16 or src % 16 or n_bytes % 16 or dst + n_bytes > stage.numel() \
                        or src + n_bytes > mem.numel() or written[dst : dst + n_bytes].any():
                    raise AssertionError(f"blake3 model: copy ({dst}, {src}, {n_bytes}) "
                                         f"misplaced in {p.line()}")
                stage[dst : dst + n_bytes] = mem[src : src + n_bytes]
                written[dst : dst + n_bytes] = True
            b = stage[offs].to(torch.int64).reshape(chunks, cols, 16, 4)
            w = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
            words[c0 : c0 + chunks, step, :, r0 : r0 + cols] = w.transpose(1, 2)
    ctr = (chunk_base + torch.arange(n, dtype=torch.int64))[:, None]
    cv = _iv(buf.device)[:, None, None]
    for blk in range(16):
        flags = (CHUNK_START if blk == 0 else 0) | (CHUNK_END if blk == 15 else 0)
        cv = compress(cv, words[:, blk].transpose(0, 1), ctr, 64, flags)
    return _to_i32(cv)


@functools.lru_cache(maxsize=None)
def card(index: int) -> Tuple[int, int]:
    """(SMs, the most registers a thread of the chunk kernel's routes holds)
    of CUDA device `index`, read once: what a launch's `plan` takes."""
    lib = _build.kernels()
    with torch.cuda.device(index):
        registers = lib.reverie_blake3_chunk_cvs_registers()
    if registers <= 0:
        raise RuntimeError("blake3_chunks: the kernel's registers could not be read")
    return torch.cuda.get_device_properties(index).multi_processor_count, registers


def launch_plan(buf: torch.Tensor, n_chunks: int) -> ChunkPlan:
    """The plan of `chunk_cvs` on this CUDA buffer: `plan` with its
    alignment, its card's SMs and the kernel's registers."""
    return plan(buf.shape[1], n_chunks, buf.data_ptr() % 16, *card(buf.device.index))


def launch(buf: torch.Tensor, n_chunks: int, chunk_base: int, out: torch.Tensor,
           p: ChunkPlan, lib=None) -> None:
    """One launch of the kernel (`lib`'s, default the port's build) at plan p
    on the buffer's device and current stream; raises if it is refused."""
    lib = lib or _build.kernels()
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        rc = lib.reverie_blake3_chunk_cvs(buf.data_ptr(), p.R, n_chunks, chunk_base,
                                          out.data_ptr(), p.route, p.cols, p.chunks,
                                          p.chunk_stage, p.stages, p.threads, stream)
    _build.check(rc, "blake3_chunk_cvs kernel")


def chunk_cvs(buf: torch.Tensor, n_chunks: int, chunk_base: int = 0
              ) -> torch.Tensor:
    """(>= n_chunks*1024, R) uint8 -> (8, n_chunks, R) int32 chunk CVs.
    CPU tensors take the plain version; CUDA tensors one launch of
    csrc/blake3_chunks.cu at `launch_plan`."""
    global LAUNCHES
    dev = buf.device
    if dev.type == "cpu":
        return chunk_cvs_ref(buf, n_chunks, chunk_base)
    if dev.type != "cuda":
        raise ValueError(f"chunk_cvs: unsupported device {dev}")
    if buf.dtype != torch.uint8 or buf.dim() != 2 or not buf.is_contiguous():
        raise ValueError("chunk_cvs: buf must be a contiguous uint8 (T, R) tensor")
    R = buf.shape[1]
    if n_chunks < 1 or buf.shape[0] < n_chunks * CHUNK_LEN:
        raise ValueError("chunk_cvs: need 1 <= n_chunks <= T // 1024")
    if not 0 <= chunk_base < 2**63:
        raise ValueError("chunk_cvs: chunk_base out of range")
    out = torch.empty((8, n_chunks, R), dtype=torch.int32, device=dev)
    if R == 0:
        return out
    launch(buf, n_chunks, chunk_base, out, launch_plan(buf, n_chunks))
    LAUNCHES += 1
    return out


def _tail_cv(tail: torch.Tensor, length: int, counter: int, root: bool):
    """CV of one partial (or whole) chunk: tail (>= length rows, R) uint8,
    length in [0, 1024].  -> (8, R) int64 words."""
    R = tail.shape[1]
    nb = max(1, (length + 63) // 64)
    pad = torch.zeros((nb * 64, R), dtype=torch.uint8, device=tail.device)
    pad[:length] = tail[:length]
    words = _bytes_to_words(pad).reshape(nb, 16, R)
    cv = _iv(tail.device)[:, None]
    for blk in range(nb):
        blen = 64 if blk < nb - 1 else length - (nb - 1) * 64
        flags = (CHUNK_START if blk == 0 else 0)
        if blk == nb - 1:
            flags |= CHUNK_END | (ROOT if root else 0)
        cv = compress(cv, words[blk], counter, blen, flags)
    return cv


def _tree_reduce(levels: List[torch.Tensor], max_pairs: Optional[int] = None,
                 root: bool = True) -> Optional[torch.Tensor]:
    """BLAKE3's tree over nodes of several heights.  levels[j]: (8, c_j, R)
    int32 node CVs at height j (0: chunks), left to right, each level's
    first node at an even position of its height (the nodes before it are
    paired already); every node of levels[j] lies left of those of
    levels[j - 1].  Level by level, adjacent pairs become PARENT nodes of
    the next height, at most max_pairs compressions at a time (None: a
    level's all at once).

    root=True: an odd last node moves up a height unchanged (the level-wise
    pairing of BLAKE3's left-biased tree), and the last two nodes, once no
    others are left, are the ROOT compress -> (8, R) int64 root words; the
    levels need at least two nodes.  root=False (an unfinished stream): an
    odd last node waits at its height for its pair; levels is left with at
    most one node a height (the CV stack) and None is returned."""
    if root and sum(x.shape[1] for x in levels) < 2:
        raise ValueError("_tree_reduce: a tree needs at least two nodes")
    iv = _iv(levels[0].device)[:, None, None]
    j = 0
    while j < len(levels):
        nodes = levels[j]
        n, R = nodes.shape[1], nodes.shape[2]
        if root and n == 2 and all(x.shape[1] == 0 for x in levels[j + 1 :]):
            m = _from_i32(torch.cat([nodes[:, 0], nodes[:, 1]]))
            return compress(iv[:, 0], m, 0, 64, PARENT | ROOT)
        pairs = n // 2
        step = max_pairs or max(pairs, 1)
        up = torch.empty((8, pairs, R), dtype=torch.int32, device=nodes.device)
        for lo in range(0, pairs, step):
            hi = min(lo + step, pairs)
            m = torch.cat([nodes[:, 2 * lo : 2 * hi : 2], nodes[:, 2 * lo + 1 : 2 * hi : 2]])
            up[:, lo:hi] = _to_i32(compress(iv, _from_i32(m), 0, 64, PARENT))
        # a copy (or a new empty tensor), not a view: a view would keep the
        # whole level's nodes alive
        odd = nodes[:, 2 * pairs :].clone()
        above = [x for x in ([up, odd] if root else [up]) if x.shape[1]]
        levels[j] = nodes.new_empty((8, 0, R)) if root else odd
        if above:
            if j + 1 == len(levels):
                levels.append(nodes.new_empty((8, 0, R)))
            levels[j + 1] = torch.cat([levels[j + 1], *above], dim=1)
        j += 1
    return None


def _rows_to_bytes(words: torch.Tensor) -> torch.Tensor:
    """(8, R) int64 words -> (R, 32) uint8, little-endian per word."""
    sh = torch.arange(0, 32, 8, dtype=torch.int64, device=words.device)
    b = (words[:, :, None] >> sh) & 0xFF  # (8, R, 4)
    return b.permute(1, 0, 2).reshape(words.shape[1], 32).to(torch.uint8)


def stream_tail(buf: torch.Tensor, T: int):
    """buf: (>= T, R) uint8 -> (levels, rem, T): the chunk CVs of each
    column's first T bytes but the last chunk (`chunk_cvs`) and that
    chunk's rows, what `finalize_columns` and `hash_leg` take."""
    n_chunks = max(1, (T + CHUNK_LEN - 1) // CHUNK_LEN)
    bulk = [chunk_cvs(buf, n_chunks - 1, 0)] if n_chunks > 1 else []
    return bulk, buf[(n_chunks - 1) * CHUNK_LEN : T], T


def hash_columns(buf: torch.Tensor, T: int) -> torch.Tensor:
    """buf: (>= T, R) uint8 -> (R, 32) uint8, blake3 of each column's first
    T bytes (rows beyond T are ignored)."""
    return finalize_columns(*stream_tail(buf, T))


# ---------------------------------------------------------------------------
# Incremental column hashing (the streaming prover, backend/streaming.py).
# Port of blake3_jax.py `absorb_columns`, `finalize_columns` and
# `ColumnHasher`: a stream made segment by segment is absorbed chunk by
# chunk into node CVs and a (1024, R) remainder; the final chunk always
# stays in the remainder, so that CHUNK_END | ROOT land on it.  Unlike the
# reference's hasher, which keeps every chunk CV to the end, the CVs are
# paired into the CV stack (pair_levels) whenever they pass the hasher's
# bound: the state stays O(bound + log n), not O(n).
# ---------------------------------------------------------------------------

#: device bytes of one compression a column (hash_columns_transient_bytes)
COMPRESS_BYTES = 1472
#: device bytes of one node CV a column (8 int32 words)
CV_BYTES = 32


def absorb_columns(rem: torch.Tensor, rem_len: int, new: torch.Tensor, n_absorb: int,
                   chunk_base: int) -> torch.Tensor:
    """Absorb an (L, R) byte block after the rem_len bytes held in the
    (1024, R) remainder rem: returns the (8, n_absorb, R) int32 CVs of the
    stream's chunks chunk_base .. chunk_base + n_absorb - 1 (`chunk_cvs`),
    and leaves the bytes past them in rem (in place; the caller keeps
    rem_len + L - 1024 * n_absorb <= 1024)."""
    if n_absorb == 0:
        rem[rem_len : rem_len + new.shape[0]] = new
        return torch.empty((8, 0, new.shape[1]), dtype=torch.int32, device=new.device)
    buf = torch.cat([rem[:rem_len], new]) if rem_len else new
    consumed = n_absorb * CHUNK_LEN
    cvs = chunk_cvs(buf, n_absorb, chunk_base)
    rem[: buf.shape[0] - consumed] = buf[consumed:]
    return cvs


def _last_chunk(total_len: int):
    """(chunks, the last one's bytes) of a stream of total_len bytes (one
    chunk of 0 bytes for the empty stream)."""
    n_chunks = max(1, (total_len + CHUNK_LEN - 1) // CHUNK_LEN)
    return n_chunks, total_len - (n_chunks - 1) * CHUNK_LEN


def _check_held(levels: List[torch.Tensor], n_chunks: int) -> None:
    """Raise unless levels hold the nodes of a stream's chunks but its last."""
    held = sum(x.shape[1] << j for j, x in enumerate(levels))
    if held != n_chunks - 1:
        raise ValueError(f"finalize_columns: the levels hold {held} chunks, "
                         f"not the {n_chunks - 1} before the last")


def finalize_columns_ref(levels: List[torch.Tensor], rem: torch.Tensor, total_len: int,
                         max_pairs: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of `finalize_columns` (the torch tail, on any
    device)."""
    R = rem.shape[1]
    if total_len == 0:
        # the empty input: one zero-length root chunk (blake3(b""))
        zero = torch.zeros((16, R), dtype=torch.int64, device=rem.device)
        cv = compress(_iv(rem.device)[:, None], zero, 0, 0, CHUNK_START | CHUNK_END | ROOT)
        return _rows_to_bytes(cv)
    n_chunks, rem_len = _last_chunk(total_len)
    if n_chunks == 1:
        return _rows_to_bytes(_tail_cv(rem, rem_len, 0, True))
    last = _to_i32(_tail_cv(rem, rem_len, n_chunks - 1, False))[:, None]
    levels = list(levels)
    levels[0] = torch.cat([levels[0], last], dim=1)
    return _rows_to_bytes(_tree_reduce(levels, max_pairs))


def finalize_columns(levels: List[torch.Tensor], rem: torch.Tensor, total_len: int,
                     max_pairs: Optional[int] = None) -> torch.Tensor:
    """The node CVs (_tree_reduce's levels) of every chunk of a stream of
    total_len bytes but its last, and rem, its last chunk -> (R, 32) uint8
    per-column hashes.  CPU tensors take the plain version
    (`finalize_columns_ref`, at most max_pairs parent compressions at
    once); CUDA tensors one launch of csrc/blake3_tail.cu (max_pairs does
    not apply: the kernel holds its compressions in registers), with at
    most one node a height above level 0 (the CV stack)."""
    n_chunks, rem_len = _last_chunk(total_len)
    _check_held(levels, n_chunks)
    if rem.device.type == "cpu":
        return finalize_columns_ref(levels, rem, total_len, max_pairs)
    if rem.device.type != "cuda":
        raise ValueError(f"finalize_columns: unsupported device {rem.device}")
    return blake3_tail.finalize(levels, rem, rem_len)


def pair_levels(levels: List[torch.Tensor], max_pairs: Optional[int] = None) -> None:
    """Pair levels' node CVs into the CV stack of their chunks, in place:
    at most one node a height is left.  CPU tensors take the plain version
    (`_tree_reduce(root=False)`, at most max_pairs compressions at once);
    CUDA tensors one launch of csrc/blake3_tail.cu."""
    if levels[0].device.type == "cpu":
        _tree_reduce(levels, max_pairs, root=False)
    else:
        levels[:] = blake3_tail.stack(levels)


class ColumnHasher:
    """One stream's incremental per-column hash on a device.  The stream's
    length is known up front (the segments' compile-time bases):

        h = ColumnHasher(total_len, R, device, held_bytes, transient_bytes)
        for block in blocks: h.absorb(block)   # (L, R) uint8
        hashes = h.finalize()                  # (R, 32) uint8

    Each absorb of a whole chunk is one `chunk_cvs` (the chunk kernel on
    CUDA, at chunk_base = the chunks absorbed before).  The node CVs held
    between absorbs stay within held_bytes (at least two nodes): past it
    they are paired into the CV stack.  That pairing and the tree of
    finalize hold at most transient_bytes of parent compressions at once
    (at least one; on CUDA the tail kernel holds them in registers, and a
    pairing is one launch).  finalize runs the tail once a stream."""

    def __init__(self, total_len: int, R: int, device, held_bytes: int, transient_bytes: int):
        self.total_len, self.R = total_len, R
        self.max_nodes = max(2, held_bytes // (CV_BYTES * max(R, 1)))
        self.max_pairs = max(1, transient_bytes // (COMPRESS_BYTES * max(R, 1)))
        self.n_chunks = max(1, (total_len + CHUNK_LEN - 1) // CHUNK_LEN)
        self.levels = [torch.empty((8, 0, R), dtype=torch.int32, device=device)]
        self.rem = torch.zeros((CHUNK_LEN, R), dtype=torch.uint8, device=device)
        self.rem_len = 0
        self.chunk_base = 0

    def absorb(self, new: torch.Tensor) -> None:
        L = new.shape[0]
        if L == 0:
            return
        avail = self.rem_len + L
        if self.chunk_base * CHUNK_LEN + avail > self.total_len:
            raise ValueError("ColumnHasher: absorbed past the stream's length")
        n_absorb = min(avail // CHUNK_LEN, self.n_chunks - 1 - self.chunk_base)
        cvs = absorb_columns(self.rem, self.rem_len, new, n_absorb, self.chunk_base)
        self.chunk_base += n_absorb
        self.rem_len = avail - n_absorb * CHUNK_LEN
        if n_absorb:
            self.levels[0] = torch.cat([self.levels[0], cvs], dim=1)
            if sum(x.shape[1] for x in self.levels) > self.max_nodes:
                pair_levels(self.levels, self.max_pairs)

    def tail(self):
        """(levels, rem, total_len) of the whole stream, what
        `finalize_columns` and `hash_leg` take."""
        if self.chunk_base * CHUNK_LEN + self.rem_len != self.total_len:
            raise ValueError("ColumnHasher: finalized before the whole stream was absorbed")
        return self.levels, self.rem, self.total_len

    def finalize(self) -> torch.Tensor:
        return finalize_columns(*self.tail(), self.max_pairs)


def hash_columns_transient_bytes(T: int, R: int) -> int:
    """Device bytes of hash_columns' largest transient on a (T, R) stream
    (on CUDA the chunk kernel allocates only its CVs, 32 bytes a chunk, and
    the tail kernel its (R, 32) output: the bound holds on both devices), as
    the CPU allocation trace measures its tensors
    (tests/test_torch_footprint.py).  Per column:
    one compression holds ~184 int64 words (the 112-word message stack, 16
    message words, the chaining value and the G mixes' rows), 1,472 bytes;
    the tail chunk's padded bytes become int64 words, ~15 bytes per byte; the
    first tree level holds 832 bytes per chunk (the chunk CVs as int32 and
    twice as int64, and half a compression)."""
    n = max(1, -(-T // CHUNK_LEN))
    tail = 64 * max(1, -(-(T - (n - 1) * CHUNK_LEN) // 64))
    return R * max(COMPRESS_BYTES, 15 * tail, 832 * n)


def hash_pair_columns_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `hash_pair_columns` (on any device)."""
    m = _bytes_to_words(torch.cat([a, b], dim=1).t().contiguous())  # (16, R)
    cv = compress(_iv(m.device)[:, None], m, 0, 64, CHUNK_START | CHUNK_END | ROOT)
    return _rows_to_bytes(cv)


def hash_pair_columns(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (R, 32) uint8 -> (R, 32) uint8, blake3(a_r || b_r) per row (one
    64-byte root block).  CPU tensors take the plain version; CUDA tensors
    one launch of csrc/blake3_tail.cu."""
    if a.device.type == "cpu":
        return hash_pair_columns_ref(a, b)
    return blake3_tail.pairs(a, b)


def hash_rep_columns_ref(hp2: torch.Tensor, ho2: torch.Tensor, hpz: torch.Tensor,
                         hoz: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `hash_rep_columns` (on any device)."""
    return hash_pair_columns_ref(hash_pair_columns_ref(hp2, ho2),
                                 hash_pair_columns_ref(hpz, hoz))


def hash_rep_columns(hp2: torch.Tensor, ho2: torch.Tensor, hpz: torch.Tensor,
                     hoz: torch.Tensor) -> torch.Tensor:
    """The per-rep combined hashes H(H(pre2 || onl2) || H(prez || onlz))
    from the four streams' (R, 32) uint8 hashes (transcript/mod.rs:77-96 +
    combine.rs:104-118).  CPU tensors take the plain version; CUDA tensors
    one launch of csrc/blake3_tail.cu."""
    if hp2.device.type == "cpu":
        return hash_rep_columns_ref(hp2, ho2, hpz, hoz)
    return blake3_tail.pairs(hp2, ho2, hpz, hoz)


def hash_leg_ref(pre2, onl2, prez, onlz, max_pairs: Optional[int] = None):
    """Plain PyTorch version of `hash_leg` (on any device)."""
    def h(x):
        return x if isinstance(x, torch.Tensor) else finalize_columns_ref(*x, max_pairs)

    hp2, ho2, hpz, hoz = map(h, (pre2, onl2, prez, onlz))
    return hash_rep_columns_ref(hp2, ho2, hpz, hoz), ho2, hoz


def hash_leg(pre2, onl2, prez, onlz, max_pairs: Optional[int] = None):
    """A hash leg: the four streams, each (levels, rem, total_len)
    (`stream_tail`, `ColumnHasher.tail`), or for onl2 and onlz their given
    (R, 32) uint8 hashes (the committed ones of a preprocessing verify) ->
    (H(H(pre2 || onl2) || H(prez || onlz)), onl2's hashes, onlz's hashes),
    each (R, 32) uint8 (transcript/mod.rs:77-96 + combine.rs:104-118, as
    TpuKKW._hash_fn).  CPU tensors take the plain version (at most
    max_pairs parent compressions at once); CUDA tensors one launch of
    csrc/blake3_tail.cu for the whole leg."""
    legs = (pre2, onl2, prez, onlz)
    for x in legs:
        if not isinstance(x, torch.Tensor):
            _check_held(x[0], _last_chunk(x[2])[0])
    first = pre2 if isinstance(pre2, torch.Tensor) else pre2[1]
    if first.device.type == "cpu":
        return hash_leg_ref(*legs, max_pairs)
    if first.device.type != "cuda":
        raise ValueError(f"hash_leg: unsupported device {first.device}")
    return blake3_tail.leg([x if isinstance(x, torch.Tensor) else (x[0], x[1], _last_chunk(x[2])[1])
                            for x in legs])
