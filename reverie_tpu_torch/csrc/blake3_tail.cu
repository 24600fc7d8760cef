// The tail of the per-column BLAKE3 of transcript streams: what is left of a
// stream's hash once the chunk kernel (blake3_chunks.cu) has the CVs of its
// whole chunks but the last.
//
// Replaces no Pallas kernel.  In reverie_tpu this is XLA, fused into the one
// device program of TpuKKW._hash_fn (reverie_tpu/backend/tpu_host.py:920-954):
// the tail chunk's CV and the tree of blake3_jax.py `hash_columns` (:320-365),
// `_tree_reduce` (:293), `finalize_columns` (:409) and the pair hashes of
// `hash_pair_columns` (:492).  Carried over as torch ops it took ~21K launches
// a prove, dispatched from the host; here it is one launch a stream and one
// for the three pair hashes.
//
// Contracts (a column r of R; node words are u32, word w of a node at
// w * plane + r in its (8, n, R) array):
//   blake3_tail_kernel: the nodes of one stream's chunks but the last, as
//     crypto/kernels/blake3.py's `levels` hold them: the CV stack (at most one
//     node a height j >= 1, node[j], covering p0 chunks together, left to
//     right from the highest) and then level 0's c0 nodes, chunks p0 ..
//     p0 + c0 - 1.  With `hash` set it adds the last chunk (tail_len bytes,
//     byte i of column r at tail[i * tail_step + r], counter p0 + c0, ROOT
//     when it is the only chunk) and writes the root, hash[32 r + i], the
//     32 bytes of blake3 of the column's stream.  Without, it pairs the nodes
//     into the CV stack of p0 + c0 chunks (`_tree_reduce(root=False)`) and
//     writes its nodes, highest first, to stack_out (8, n_out, R).
//   blake3_tail_kernel_pairs: out[r] = H(a[r] || b[r]), or with c and d
//     H(H(a[r] || b[r]) || H(c[r] || d[r])), each H one 64-byte root block;
//     rows of 32 bytes.
//
// What bounds it on the H100: at the main path's shape (977 chunks, R = 256)
// a stream's tree is 976 parent compressions and 16 tail blocks a column,
// 0.25M compressions (0.18G integer instructions, 0.011 ms at 16.7 T/s) and
// 8 MB of CVs read (0.0025 ms): the operations bound it (roofline.py
// blake3_tail_work).  What it meets first is latency: a compression is ~840
// cycles of dependent instructions, and a column's tree is a chain of them.
//
// What the design does about it: a warp per column.  Level 0 is cut into
// aligned power-of-two pieces of at most 2^k nodes (k the least with c0 / 2^k
// <= 32, at most 10), and each lane reduces one piece serially, 32 pieces a
// round; lane 0 merges each round's piece roots into the CV stack in shared
// memory with BLAKE3's stack rule (a piece of 2^h chunks pushed at height
// h), then adds the tail chunk and folds the stack into the root.  At the
// main path's shape a column is ~110 dependent compressions, not ~1,000.

#include <cstdint>
#include <cuda_runtime.h>

#include "blake3_core.cuh"

namespace {

constexpr int kWarps = 4;           // columns a block, a warp each
constexpr int kMaxHeight = 64;      // heights of the CV stack (< 2^64 chunks)
constexpr int kPieceHeight = 10;    // a lane's piece holds at most 2^10 nodes
constexpr int kPairThreads = 256;

struct Stack {
  const uint32_t* node[kMaxHeight];  // height j's node, or null
  long long plane[kMaxHeight];       // its word stride
};

struct Tree {
  const uint32_t* level0;  // node i's word w at level0[w * plane0 + i * step0 + r]
  long long c0, plane0, step0;
  unsigned long long p0;   // the chunks under the stack's nodes
  const uint8_t* tail;     // the last chunk (hash only)
  long long tail_step;
  int tail_len, R;
  uint8_t* hash;           // (R, 32), or null: write the CV stack
  uint32_t* stack_out;     // (8, n_out, R)
  int n_out;
};

__device__ __forceinline__ void copy8(uint32_t dst[8], const uint32_t src[8]) {
#pragma unroll
  for (int w = 0; w < 8; ++w) dst[w] = src[w];
}

// cv := the CV of the parent node of (left, cv)
__device__ __forceinline__ void parent(uint32_t cv[8], const uint32_t left[8],
                                       uint32_t flags) {
  uint32_t m[16];
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    m[w] = left[w];
    m[w + 8] = cv[w];
    cv[w] = kIV[w];
  }
  compress(cv, m, 0, 64u, kParent | flags);
}

// Push the CV of a subtree of 2^h chunks onto the stack of the `done` chunks
// before it (done a multiple of 2^h): BLAKE3's stack rule, the subtree merged
// with each node to its left that it completes.
__device__ __forceinline__ void push(uint32_t (*st)[8], int& sp, uint32_t cv[8],
                                     int h, unsigned long long done) {
  for (unsigned long long t = (done >> h) + 1; !(t & 1); t >>= 1) parent(cv, st[--sp], 0);
  copy8(st[sp++], cv);
}

// The height of the aligned piece of level 0 that starts at chunk q < end:
// as large as q's alignment, k and the nodes left allow.
__device__ __forceinline__ int piece_height(unsigned long long q, unsigned long long end,
                                            int k) {
  int h = q ? min(__ffsll(static_cast<long long>(q)) - 1, k) : k;
  while (q + (1ull << h) > end) --h;
  return h;
}

__device__ __forceinline__ void load_node(uint32_t cv[8], const uint32_t* p, long long plane) {
#pragma unroll
  for (int w = 0; w < 8; ++w) cv[w] = p[w * plane];
}

// The CV (or, as the stream's only chunk, the root) of the last chunk.
__device__ __forceinline__ void tail_cv(uint32_t cv[8], const Tree& t, int r,
                                        uint64_t counter, bool root) {
#pragma unroll
  for (int w = 0; w < 8; ++w) cv[w] = kIV[w];
  const int nb = t.tail_len > 64 ? (t.tail_len + 63) / 64 : 1;
  const uint8_t* col = t.tail + r;
  for (int blk = 0; blk < nb; ++blk) {
    uint32_t m[16];
#pragma unroll
    for (int w = 0; w < 16; ++w) {
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = blk * 64 + 4 * w + b;
        if (i < t.tail_len) word |= static_cast<uint32_t>(col[i * t.tail_step]) << (8 * b);
      }
      m[w] = word;
    }
    const bool last = blk == nb - 1;
    const uint32_t flags = (blk == 0 ? kChunkStart : 0u) |
                           (last ? kChunkEnd | (root ? kRoot : 0u) : 0u);
    compress(cv, m, counter, last ? static_cast<uint32_t>(t.tail_len - 64 * blk) : 64u, flags);
  }
}

__global__ void __launch_bounds__(kWarps * 32)
blake3_tail_kernel(const Stack stack, const Tree t) {
  __shared__ uint32_t roots[kWarps][32][8];          // a round's piece roots
  __shared__ uint32_t stacks[kWarps][kMaxHeight][8];  // each column's CV stack
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= t.R) return;  // the whole warp
  uint32_t(*st)[8] = stacks[warp];
  int sp = 0;
  if (lane == 0) {
    for (int j = kMaxHeight - 1; j >= 1; --j) {
      if (stack.node[j] != nullptr) load_node(st[sp++], stack.node[j] + r, stack.plane[j]);
    }
  }

  int k = 0;
  while (k < kPieceHeight && (t.c0 >> k) > 32) ++k;
  const unsigned long long end = t.p0 + static_cast<unsigned long long>(t.c0);
  unsigned long long pos = t.p0, done = t.p0;
  while (pos < end) {
    // this round's pieces: lane i reduces the i-th
    unsigned long long q = pos, mine = 0;
    int n = 0, my_h = -1;
    for (; n < 32 && q < end; ++n) {
      const int h = piece_height(q, end, k);
      if (n == lane) mine = q, my_h = h;
      q += 1ull << h;
    }
    if (my_h >= 0) {
      uint32_t lst[kPieceHeight + 1][8];
      int lsp = 0;
      const uint32_t* p = t.level0 + (mine - t.p0) * t.step0 + r;
      for (long long i = 0; i < (1ll << my_h); ++i) {
        uint32_t cv[8];
        load_node(cv, p + i * t.step0, t.plane0);
        push(lst, lsp, cv, 0, static_cast<unsigned long long>(i));
      }
      copy8(roots[warp][lane], lst[0]);
    }
    __syncwarp();
    if (lane == 0) {
      unsigned long long q2 = pos;
      for (int i = 0; i < n; ++i) {
        const int h = piece_height(q2, end, k);
        uint32_t cv[8];
        copy8(cv, roots[warp][i]);
        push(st, sp, cv, h, done);
        done += 1ull << h;
        q2 += 1ull << h;
      }
    }
    __syncwarp();
    pos = q;
  }
  if (lane != 0) return;

  if (t.hash != nullptr) {
    uint32_t cv[8];
    tail_cv(cv, t, r, done, done == 0);
    for (int i = sp - 1; i >= 0; --i) parent(cv, st[i], i == 0 ? kRoot : 0u);
    uint32_t* out = reinterpret_cast<uint32_t*>(t.hash + 32ll * r);
#pragma unroll
    for (int w = 0; w < 8; ++w) out[w] = cv[w];  // little-endian words
  } else {
    const long long plane = static_cast<long long>(t.n_out) * t.R;
    for (int i = 0; i < sp && i < t.n_out; ++i) {
#pragma unroll
      for (int w = 0; w < 8; ++w) t.stack_out[w * plane + static_cast<long long>(i) * t.R + r] = st[i][w];
    }
  }
}

__device__ __forceinline__ void load_row(uint32_t w[8], const uint8_t* p) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    w[i] = static_cast<uint32_t>(p[4 * i]) | (static_cast<uint32_t>(p[4 * i + 1]) << 8) |
           (static_cast<uint32_t>(p[4 * i + 2]) << 16) |
           (static_cast<uint32_t>(p[4 * i + 3]) << 24);
  }
}

// h := blake3(x || y) of one 64-byte block
__device__ __forceinline__ void hash64(uint32_t h[8], const uint32_t x[8], const uint32_t y[8]) {
  uint32_t m[16];
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    m[w] = x[w];
    m[w + 8] = y[w];
    h[w] = kIV[w];
  }
  compress(h, m, 0, 64u, kChunkStart | kChunkEnd | kRoot);
}

__global__ void __launch_bounds__(kPairThreads)
blake3_tail_kernel_pairs(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                         const uint8_t* __restrict__ c, const uint8_t* __restrict__ d,
                         uint8_t* __restrict__ out, int R) {
  const int r = blockIdx.x * kPairThreads + threadIdx.x;
  if (r >= R) return;
  const long long row = 32ll * r;
  uint32_t x[8], y[8], h[8];
  load_row(x, a + row);
  load_row(y, b + row);
  hash64(h, x, y);
  if (c != nullptr) {
    uint32_t h2[8];
    load_row(x, c + row);
    load_row(y, d + row);
    hash64(h2, x, y);
    copy8(x, h);
    hash64(h, x, h2);
  }
  uint32_t* o = reinterpret_cast<uint32_t*>(out + row);
#pragma unroll
  for (int w = 0; w < 8; ++w) o[w] = h[w];
}

}  // namespace

extern "C" int reverie_blake3_tail(const void* const* nodes, const long long* planes,
                                   const void* level0, long long c0, long long plane0,
                                   long long step0, long long p0, const void* tail,
                                   long long tail_step, int tail_len, int R, void* hash,
                                   void* stack_out, int n_out, void* stream) {
  Stack s;
  for (int j = 0; j < kMaxHeight; ++j) {
    s.node[j] = static_cast<const uint32_t*>(nodes[j]);
    s.plane[j] = planes[j];
  }
  Tree t;
  t.level0 = static_cast<const uint32_t*>(level0);
  t.c0 = c0;
  t.plane0 = plane0;
  t.step0 = step0;
  t.p0 = static_cast<unsigned long long>(p0);
  t.tail = static_cast<const uint8_t*>(tail);
  t.tail_step = tail_step;
  t.tail_len = tail_len;
  t.R = R;
  t.hash = static_cast<uint8_t*>(hash);
  t.stack_out = static_cast<uint32_t*>(stack_out);
  t.n_out = n_out;
  const unsigned int grid = static_cast<unsigned int>((R + kWarps - 1) / kWarps);
  blake3_tail_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(s, t);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int reverie_blake3_tail_pairs(const void* a, const void* b, const void* c,
                                         const void* d, void* out, int R, void* stream) {
  const unsigned int grid = static_cast<unsigned int>((R + kPairThreads - 1) / kPairThreads);
  blake3_tail_kernel_pairs<<<grid, kPairThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
      static_cast<const uint8_t*>(c), static_cast<const uint8_t*>(d),
      static_cast<uint8_t*>(out), R);
  return static_cast<int>(cudaGetLastError());
}
