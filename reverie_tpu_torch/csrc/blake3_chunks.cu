// BLAKE3 chaining values of whole 1024-byte chunks, read from a transcript
// buffer whose columns are the per-repetition byte streams.
//
// Replaces reverie_tpu/crypto/kernels/blake3_pallas.py:74 _fb_kernel (entry
// chunk_cvs_from_bytes, :151).
//
// Contract: buf is (T, R) u8 with row stride R; for chunk c < n_chunks and
// column r, out[i, c, r] (i < 8) is the chaining value of bytes
// buf[c*1024 : (c+1)*1024, r] as a non-root BLAKE3 chunk with counter
// chunk_base + c (64-bit; CHUNK_START on block 0, CHUNK_END on block 15).  A
// message word is 4 consecutive rows of one column, little-endian.
//
// What bounds it on the H100: at the main path's shape (n = 976 chunks,
// R = 256) the kernel reads 256 MB once, 0.0764 ms at 3.35 TB/s, and its 4.0M
// compressions need at least 2.85G integer instructions (712 each,
// roofline.py), 0.0851 ms at the SMs' issue rate (132 SMs x 128 lanes x
// 1,980 MHz): the operations bound it, the bytes close behind.  Nearer: a
// compression's 456 XORs and rotations issue only on the ALU pipe, 64 lanes
// an SM, 0.109 ms for these.
//
// What held the first kernel (one thread a (chunk, column), 0.224 ms on an
// H100 at 700 W): each thread read a block's 64 rows as 64 one-byte loads at
// a runtime stride, each with its own 64-bit address arithmetic, and then
// compressed; nothing was fetched ahead, so a warp waited out a round trip to
// device memory 16 times a chunk; 976 blocks of 256 threads at 48 registers
// were 1.5 waves of the card, the last one half empty; and the compiler put
// most of a compression's adds beside its XORs and rotations on the ALU
// pipe, ~600 of its ~700 instructions.
//
// What this design does about it (crypto/kernels/blake3.py `plan`, which also
// models the reads in torch for the CPU tests):
// - A block takes one tile: `chunks` consecutive chunks x `cols` columns, a
//   thread a (chunk, column).  Its 16 steps are the chunks' 16 blocks of 64
//   rows; a ring of `stages` stages in shared memory holds the rows of the
//   next steps while the threads compress the current one.  Warp 0 fills a
//   stage with the TMA's asynchronous copies, which complete on the stage's
//   mbarrier; one __syncthreads a step frees the stage just read for the
//   step `stages` ahead.
// - Routes (Route; the copies and the row pitch of a stage):
//   span      the tile holds every column (R <= 256): a chunk's 64 rows of a
//             block are one contiguous run, one 1-D bulk copy a chunk, rows
//             at the runtime pitch R;
//   span40, span216  the same at a compile-time pitch, for the verify legs'
//             widths (ProtocolParams' 40 online and 216 preprocessing reps);
//   rows      one chunk x 128 columns, R a multiple of 16, the buffer
//             16-byte aligned and its chunks' rows fewer than 2^31: one 2-D
//             tensor copy (a box of 64 rows x 128 columns; columns past R
//             come in as zeros) a stage, rows at a compile-time pitch of 128;
//   rows_shifted  one chunk x 128 columns on any other buffer past 256
//             columns: a 1-D copy a row (64 a stage, issued one by one:
//             slower), rows at a compile-time pitch of 144 bytes (128 and 16
//             of alignment), each at its own offset mod 16,
//             (delta + r0 + row * R) mod 16.
// - Alignment: a 1-D copy moves the 16-byte-aligned run of device memory
//   that holds its bytes (no 16-byte line past the buffer's own), so every
//   width and every data_ptr takes 16-byte copies; a byte's offset in its
//   row is then delta + column, delta the buffer's address mod 16.
// - On the compile-time pitches a message word's four rows are read from
//   shared memory at immediate offsets: the loop has no address arithmetic.
//   32 lanes read neighbouring bytes of one row, at most 9 banks' words, with
//   broadcast; a span stage's chunks are spaced so that a warp's lanes in two
//   chunks meet in no bank.  A word's four bytes merge by IMADs, and the
//   compression's adds are IMADs (blake3_core.cuh ImadAdds): the FMA pipe
//   takes them, and the ALU pipe keeps only the XORs and rotations.
// - The grid is one block a tile, and `plan` sizes the tiles so that the
//   SMs' loads come out even (the block scheduler hands each free slot the
//   next tile): at the main path's shape 1,952 tiles of 128 columns, 15 on
//   the busiest SM against 14.8 on average, where a chunk of 256 columns a
//   block would give 8 against 7.4.
// At the main path's shape it takes 0.141 ms on an H100 at 700 W, 60% of the
// bound (tools/k3_times.py); its copies and reads alone take 0.097 and its
// compressions alone 0.125.
//
// tools/k3_times.py --probe builds this file alone with one of two macros
// that cut it, to split its time: BLAKE3_CHUNKS_CUT_COMPRESSIONS stages and
// reads the rows but compresses nothing, BLAKE3_CHUNKS_CUT_READS compresses
// words made in registers and copies nothing.  The port's build defines
// neither.

#include <cstddef>
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "blake3_core.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxStages = 4;
constexpr int kBlocks = 16;     // BLAKE3 blocks a chunk: a tile's steps
constexpr int kRows = 64;       // rows of a block
constexpr int kRowCols = 128;   // columns of a tile on the rows routes
constexpr int kRowPitch = 144;  // rows_shifted: 128 columns and 16 of alignment

enum Route { kSpanRoute, kSpan40Route, kSpan216Route, kRowsRoute, kRowsShiftedRoute, kRoutes };
// how a stage is filled and read: one copy a chunk (span), one 2-D tensor
// copy a stage (rows), one copy a row at its own offset (rows_shifted)
enum Layout { kSpanLayout, kTensorLayout, kShiftedLayout };

struct Tiles {
  const uint8_t* src;        // the buffer rounded down to 16 bytes
  uint32_t* out;             // (8, n_chunks, R)
  long long n_chunks;
  unsigned long long chunk_base;
  int R, delta;              // delta: the buffer's address less src
  int cols, chunks;          // a tile: `chunks` chunks x `cols` columns
  int col_tiles;             // tiles across R
  int chunk_stage;           // bytes of one chunk's rows in a stage
  int stages;
  uint32_t one;              // 1, which the compiler cannot see (ImadAdds)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// One arrival on the stage's barrier, which then also waits for `bytes` more
// of the copies' bytes.
__device__ __forceinline__ void bar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16) from src to dst (both 16-byte aligned), completing
// on bar.
__device__ __forceinline__ void bulk_copy(uint8_t* dst, const uint8_t* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The tensor map's box at column x, row y to dst (128-byte aligned),
// completing on bar.
__device__ __forceinline__ void tensor_copy(uint8_t* dst, const CUtensorMap* map, int x, int y,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

// Warp 0 fills a stage with block `step` of the tile's chunks.  rows: lane 0
// arrives on the stage's barrier expecting the box's bytes and copies the
// box; the others arrive.  Otherwise each lane arrives expecting the bytes
// of its copies (one a chunk on span, one a row on rows_shifted) and issues
// them.
template <int L>
__device__ __forceinline__ void fill(const Tiles& t, const CUtensorMap* map, uint8_t* stage,
                                     uint64_t* bar, long long c0, int chunks, int r0, int cols,
                                     int step, int lane) {
#ifdef BLAKE3_CHUNKS_CUT_READS
  bar_arrive_expect(bar, 0);
#else
  if (L == kTensorLayout) {
    bar_arrive_expect(bar, lane == 0 ? kRows * kRowCols : 0);
    if (lane == 0) tensor_copy(stage, map, r0, static_cast<int>(c0 * 1024 + kRows * step), bar);
  } else if (L == kSpanLayout) {
    const uint32_t bytes = (t.delta + kRows * t.R + 15) & ~15;
    uint32_t mine = 0;
    for (int j = lane; j < chunks; j += 32) mine += bytes;
    bar_arrive_expect(bar, mine);
    for (int j = lane; j < chunks; j += 32) {
      const size_t row = static_cast<size_t>(c0 + j) * 1024 + kRows * step;
      bulk_copy(stage + j * t.chunk_stage, t.src + row * t.R, bytes, bar);
    }
  } else {
    // row k of chunk j: its first byte lies `off` bytes past src
    auto run = [&](int k, size_t& lo, uint32_t& bytes) {
      const int j = k / kRows, row = k % kRows;
      const size_t off =
          (static_cast<size_t>(c0 + j) * 1024 + kRows * step + row) * t.R + r0 + t.delta;
      lo = off & ~static_cast<size_t>(15);
      bytes = (static_cast<uint32_t>(off - lo) + cols + 15) & ~15u;
    };
    uint32_t mine = 0;
    for (int k = lane; k < kRows * chunks; k += 32) {
      size_t lo;
      uint32_t bytes;
      run(k, lo, bytes);
      mine += bytes;
    }
    bar_arrive_expect(bar, mine);
    for (int k = lane; k < kRows * chunks; k += 32) {
      size_t lo;
      uint32_t bytes;
      run(k, lo, bytes);
      bulk_copy(stage + (k / kRows) * t.chunk_stage + (k % kRows) * kRowPitch, t.src + lo, bytes,
                bar);
    }
  }
#endif
}

// The 16 message words of a block from a stage: row i of this thread's column
// at s + i * pitch (P when P > 0, a compile-time offset), and on rows_shifted
// each row's own offset mod 16 added; the four bytes of a word merged by
// IMADs (b0 + b1 s8 + b2 s16 + b3 s24, s8 = one << 8 ...), off the ALU pipe.
template <int P, int L>
__device__ __forceinline__ void load_words(const uint8_t* s, int pitch, int d0, int rm,
                                           uint32_t one, uint32_t m[16]) {
  const uint32_t s8 = one << 8, s16 = one << 16, s24 = one << 24;
#pragma unroll
  for (int w = 0; w < 16; ++w) {
    uint32_t b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 4 * w + i;
      int off = row * (P > 0 ? P : pitch);
      if (L == kShiftedLayout) off += (d0 + row * rm) & 15;
      b[i] = s[off];
    }
    m[w] = b[3] * s24 + (b[2] * s16 + (b[1] * s8 + b[0]));
  }
}

template <int P, int L>
__global__ void __launch_bounds__(kMaxThreads, 4)
    blake3_chunk_cvs_kernel(const Tiles t, const __grid_constant__ CUtensorMap map) {
  // the ring, then a barrier a stage
  extern __shared__ __align__(128) uint8_t ring[];
  const int tid = threadIdx.x, lane = tid & 31;
  const long long group = blockIdx.x / t.col_tiles;
  const int r0 = static_cast<int>(blockIdx.x - group * t.col_tiles) * t.cols;
  const long long c0 = group * t.chunks;
  const int cols = min(t.cols, t.R - r0);
  const int chunks = static_cast<int>(min(static_cast<long long>(t.chunks), t.n_chunks - c0));
  const int j = tid / t.cols, col = tid - j * t.cols;
  const bool active = j < chunks && col < cols;
  const int stage_bytes = t.chunks * t.chunk_stage;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + t.stages * stage_bytes);

  if (tid == 0) {
    for (int s = 0; s < t.stages; ++s) bar_init(&full[s], 32);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid < 32)
    for (int s = 0; s < t.stages; ++s)
      fill<L>(t, &map, ring + s * stage_bytes, &full[s], c0, chunks, r0, cols, s, lane);

  const uint8_t* mine = ring + j * t.chunk_stage + col + (L == kShiftedLayout ? 0 : t.delta);
  const int d0 = (t.delta + r0) & 15, rm = t.R & 15;
  const ImadAdds add{t.one};
  uint32_t cv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) cv[i] = kIV[i];
  const uint64_t counter = t.chunk_base + static_cast<uint64_t>(c0 + j);
  int s = 0;
  uint32_t parity = 0;
  for (int step = 0; step < kBlocks; ++step) {
    uint32_t m[16];
    bar_wait(&full[s], parity);
    if (active) {
#ifdef BLAKE3_CHUNKS_CUT_READS
#pragma unroll
      for (int w = 0; w < 16; ++w)
        m[w] = (static_cast<uint32_t>(step) << 20) ^ (w * 0x9E3779B9u) ^ col;
#else
      // rows_shifted: the rows' 64 offsets are the same every step; d0 passed
      // through an opaque move keeps the compiler from holding all 64 across
      // the loop (ptxas spilled them)
      int d = d0;
      if (L == kShiftedLayout) asm volatile("mov.b32 %0, %1;" : "=r"(d) : "r"(d0));
      load_words<P, L>(mine + s * stage_bytes, t.R, d, rm, t.one, m);
#endif
    }
    __syncthreads();  // every thread has read stage s: refill it for step + stages
    if (tid < 32 && step + t.stages < kBlocks) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      fill<L>(t, &map, ring + s * stage_bytes, &full[s], c0, chunks, r0, cols, step + t.stages,
              lane);
    }
    if (active) {
#ifdef BLAKE3_CHUNKS_CUT_COMPRESSIONS
#pragma unroll
      for (int i = 0; i < 8; ++i) cv[i] ^= m[i] + m[i + 8];
#else
      const uint32_t flags =
          (step == 0 ? kChunkStart : 0u) | (step == kBlocks - 1 ? kChunkEnd : 0u);
      compress(cv, m, counter, 64u, flags, add);
#endif
    }
    if (++s == t.stages) {
      s = 0;
      parity ^= 1u;
    }
  }
  if (active) {
    const size_t plane = static_cast<size_t>(t.n_chunks) * t.R;
    uint32_t* o = t.out + static_cast<size_t>(c0 + j) * t.R + r0 + col;
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i * plane] = cv[i];
  }
}

template <int P, int L>
int launch(const Tiles& t, const CUtensorMap& map, int threads, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        blake3_chunk_cvs_kernel<P, L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const long long tiles = (t.n_chunks + t.chunks - 1) / t.chunks * t.col_tiles;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  blake3_chunk_cvs_kernel<P, L>
      <<<static_cast<unsigned int>(tiles), threads, smem, stream>>>(t, map);
  return static_cast<int>(cudaGetLastError());
}

int registers(const void* kernel) {
  cudaFuncAttributes attr;
  return cudaFuncGetAttributes(&attr, kernel) == cudaSuccess ? attr.numRegs : -1;
}

// The rows route's tensor map: the buffer as `rows` rows of R bytes, a box of
// 64 rows x 128 columns.  The driver's encoder is reached through the
// runtime, so the library links no driver library.
cudaError_t encode_rows_map(CUtensorMap* map, const void* buf, int R, long long rows) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t rc =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (rc != cudaSuccess) return rc;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(R), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(R)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kRowCols), static_cast<cuuint32_t>(kRows)};
  const cuuint32_t element_strides[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(buf), dims,
                            strides, box, element_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// The most registers a thread of any route's kernel holds (blake3.py `plan`
// sizes the blocks an SM holds by it), or -1 on an error.
extern "C" int reverie_blake3_chunk_cvs_registers() {
  const void* kernels[kRoutes] = {
      reinterpret_cast<const void*>(blake3_chunk_cvs_kernel<0, kSpanLayout>),
      reinterpret_cast<const void*>(blake3_chunk_cvs_kernel<40, kSpanLayout>),
      reinterpret_cast<const void*>(blake3_chunk_cvs_kernel<216, kSpanLayout>),
      reinterpret_cast<const void*>(blake3_chunk_cvs_kernel<kRowCols, kTensorLayout>),
      reinterpret_cast<const void*>(blake3_chunk_cvs_kernel<kRowPitch, kShiftedLayout>)};
  int most = 0;
  for (const void* k : kernels) {
    const int r = registers(k);
    if (r < 0) return -1;
    most = r > most ? r : most;
  }
  return most;
}

// One launch at a plan of blake3.py `plan`: the route, a tile's columns and
// chunks, a chunk's bytes in a stage, the stages and a block's threads.
// Returns cudaErrorInvalidValue for a plan that does not fit the route.
extern "C" int reverie_blake3_chunk_cvs(const void* buf, int R, long long n_chunks,
                                        long long chunk_base, void* out, int route, int cols,
                                        int chunks, int chunk_stage, int stages, int threads,
                                        void* stream) {
  Tiles t = {};
  const uintptr_t addr = reinterpret_cast<uintptr_t>(buf);
  t.delta = static_cast<int>(addr & 15);
  t.src = reinterpret_cast<const uint8_t*>(addr - t.delta);
  t.out = static_cast<uint32_t*>(out);
  t.n_chunks = n_chunks;
  t.chunk_base = static_cast<unsigned long long>(chunk_base);
  t.R = R;
  t.cols = cols;
  t.chunks = chunks;
  t.chunk_stage = chunk_stage;
  t.stages = stages;
  t.one = 1;
  const int pitches[3] = {0, 40, 216};
  const bool span = route >= kSpanRoute && route <= kSpan216Route;
  const bool rows = route == kRowsRoute || route == kRowsShiftedRoute;
  const int span_run = (t.delta + kRows * R + 15) & ~15;
  const bool ok =
      R >= 1 && n_chunks >= 1 && stages >= 1 && stages <= kMaxStages && threads >= 32 &&
      threads <= kMaxThreads && threads % 32 == 0 && chunk_stage % 16 == 0 &&
      ((span && cols == R && chunks >= 1 && chunks * R <= threads && chunk_stage >= span_run &&
        (route == kSpanRoute || R == pitches[route])) ||
       (rows && cols == kRowCols && chunks == 1 && threads == kRowCols &&
        (route == kRowsRoute
             ? R % 16 == 0 && t.delta == 0 && chunk_stage == kRows * kRowCols &&
                   n_chunks * 1024 <= 0x7fffffffLL  // a tensor copy's row is an int32
             : chunk_stage == kRows * kRowPitch)));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  t.col_tiles = (R + cols - 1) / cols;
  // the ring, then a barrier a stage
  const long long smem_ll =
      static_cast<long long>(stages) * chunks * chunk_stage + 8LL * kMaxStages;
  if (smem_ll > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(smem_ll);
  CUtensorMap map = {};
  if (route == kRowsRoute) {
    const cudaError_t rc = encode_rows_map(&map, buf, R, n_chunks * 1024);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (route) {
    case kSpanRoute: return launch<0, kSpanLayout>(t, map, threads, smem, s);
    case kSpan40Route: return launch<40, kSpanLayout>(t, map, threads, smem, s);
    case kSpan216Route: return launch<216, kSpanLayout>(t, map, threads, smem, s);
    case kRowsRoute: return launch<kRowCols, kTensorLayout>(t, map, threads, smem, s);
    default: return launch<kRowPitch, kShiftedLayout>(t, map, threads, smem, s);
  }
}
