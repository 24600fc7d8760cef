// The tail of the per-column BLAKE3 of transcript streams: what is left of a
// hash leg once the chunk kernel (blake3_chunks.cu) has the CVs of its
// streams' whole chunks but the last.
//
// Replaces no Pallas kernel.  In reverie_tpu this is XLA, fused into the one
// device program of TpuKKW._hash_fn (reverie_tpu/backend/tpu_host.py:920-954):
// the tail chunk's CV and the tree of blake3_jax.py `hash_columns` (:320-365),
// `_tree_reduce` (:293), `finalize_columns` (:409) and the pair hashes of
// `hash_pair_columns` (:492).  Here it is one launch a leg as well.
//
// Contract (a column r of R; node words are u32, word w of a node at
// w * plane + r in its (8, n, R) array).  A launch takes 1, 2 or 4 inputs,
// each a stream or given hashes (rows, 32 bytes a column).  A stream is the
// nodes of its chunks but the last, as crypto/kernels/blake3.py's `levels`
// hold them (the CV stack: at most one node a height j >= 1, covering p0
// chunks together, left to right from the highest; then level 0's c0 nodes,
// chunks p0 .. p0 + c0 - 1), and its last chunk (tail_len bytes, byte i of
// column r at tail[i * tail_step + r], counter p0 + c0, ROOT when it is the
// only chunk).  The kernel writes out[32 r + i]: the one input's hash, or
// H(x0 || x1), or H(H(x0 || x1) || H(x2 || x3)), each H one 64-byte root
// block, and a stream's own hash where hash_out is given.  With stack_out
// (one stream, no last chunk) it pairs the nodes into the CV stack of
// p0 + c0 chunks (`_tree_reduce(root=False)`) and writes its nodes, highest
// first, to stack_out (8, n_out, R).
//
// What bounds it on the H100: at the main path's shape (two streams of 977
// chunks, R = 256) a leg is 2 x (976 parent compressions + 10 tail blocks) a
// column and 3 pair hashes, 0.5M compressions (0.34G integer instructions,
// 0.010 ms at the SMs' issue rate of 33.5 T/s) and 16 MB of CVs read
// (0.005 ms): the operations bound it (roofline.py blake3_tail_work,
// blake3_pairs_work).  What it meets
// first is latency: a compression is ~0.6 us of dependent instructions
// (four warps an SM fill its issue), a tree a chain of them; and the
// (8, n, R) CVs, contiguous along R, give a block of few columns a few
// bytes of each 32-byte sector.
//
// What the design does about it (crypto/kernels/blake3_tail.py `plan`):
// - A block holds C adjacent columns (8 at large R; fewer where R is small,
//   as long as the grid still covers 3/4 of the SMs) and all of their
//   inputs' lanes: lane (slot, c) is thread slot * C + c, so a node word's C
//   columns are one load (C = 8: a whole 32-byte sector).
// - Each stream's level 0 is cut into aligned pieces of at most 2^k nodes,
//   k from the plan's estimate of the SMs' compression time and the chain;
//   a lane reduces one piece, another lane loads each CV-stack node, and
//   one more lane an input hashes the last chunk, staged in shared memory
//   by coalesced loads, while the pieces run.
// - The nodes then merge as a tree across lanes in shared memory: in each
//   round every left child takes in its right neighbour of the same height,
//   all pairs at once (BLAKE3's stack rule at the ragged edges and at the
//   stack's offset p0 follows from the positions); ~log2(pieces) rounds.
//   Meanwhile the input's lane folds each node of the CV stack into the last
//   chunk's CV, right to left, as soon as the node is formed, the last fold
//   the root; the pair hashes follow in the same block.
// At the main path's shape (C = 2, pieces of 32) a column's chain is ~40
// compressions against ~110, and a block's SM does ~31 compressions' time
// of work: the SM's throughput and the loads, not the chain, set it.
//
// tools/tail_probe.py builds this file alone with one of two macros that
// cut it, to time its phases: BLAKE3_TAIL_CUT_AFTER_PIECES returns once the
// pieces are reduced, BLAKE3_TAIL_CUT_COMPRESSIONS loads the pieces' nodes
// but compresses none.  The port's build defines neither.

#include <cstdint>
#include <cuda_runtime.h>

#include "blake3_core.cuh"

namespace {

constexpr int kMaxInputs = 4;
constexpr int kMaxStack = 64;     // CV-stack nodes of a launch
constexpr int kMaxPiece = 12;     // a piece holds at most 2^12 nodes
constexpr int kMaxThreads = 512;
constexpr int kStage = 8;         // the last chunks' byte loads in flight a thread
constexpr int kHeaderWords = 16, kInputWords = 16, kStackWords = 4;

struct Input {
  const uint32_t* level0;  // node i's word w at level0[w * plane0 + i * step0 + r]
  long long c0, plane0, step0;
  unsigned long long p0;   // the chunks under the stack's nodes
  const uint8_t* tail;     // the last chunk, or null (none, or a stack launch)
  long long tail_step;
  const uint8_t* rows;     // given hashes (R, 32), or null: a stream
  uint8_t* hash_out;       // the stream's own hashes (R, 32), or null
  int tail_len, items, slot0, stack0, n_stack, tail_smem;
};

struct Leg {
  Input in[kMaxInputs];
  const uint32_t* stack_node[kMaxStack];
  long long stack_plane[kMaxStack];
  unsigned long long stack_pos[kMaxStack];
  int stack_h[kMaxStack];
  uint8_t* out;         // (R, 32), or null (a stack launch)
  uint32_t* stack_out;  // (8, n_out, R), or null
  int n_out, n_in, R, C, k, slots, stack_launch;
};

__device__ __forceinline__ void copy8(uint32_t dst[8], const uint32_t src[8]) {
#pragma unroll
  for (int w = 0; w < 8; ++w) dst[w] = src[w];
}

// h := the 64-byte block x || y compressed from the IV (h may alias x or y)
__device__ __forceinline__ void node2(uint32_t h[8], const uint32_t x[8], const uint32_t y[8],
                                      uint32_t flags) {
  uint32_t m[16];
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    m[w] = x[w];
    m[w + 8] = y[w];
  }
#pragma unroll
  for (int w = 0; w < 8; ++w) h[w] = kIV[w];
  compress(h, m, 0, 64u, flags);
}

__device__ __forceinline__ void load_node(uint32_t cv[8], const uint32_t* p, long long plane) {
#pragma unroll
  for (int w = 0; w < 8; ++w) cv[w] = p[w * plane];
}

// The height of the aligned piece of level 0 that starts at chunk q < end:
// as large as q's alignment, k and the nodes left allow (blake3_tail.py
// piece_height).
__device__ __forceinline__ int piece_height(unsigned long long q, unsigned long long end, int k) {
  int h = q ? min(__ffsll(static_cast<long long>(q)) - 1, k) : k;
  while (q + (1ull << h) > end) --h;
  return h;
}

// The i-th piece of [p0, end) (blake3_tail.py piece_at): the ragged left
// pieces walked, the whole ones counted, the ragged right ones walked.
__device__ void piece_at(unsigned long long p0, unsigned long long end, int k, long long i,
                         unsigned long long& q, int& h) {
  const unsigned long long mask = (1ull << k) - 1;
  q = p0;
  while (i > 0 && (q & mask)) {
    q += 1ull << piece_height(q, end, k);
    --i;
  }
  if (!(q & mask)) {
    const long long whole = static_cast<long long>((end - q) >> k);
    if (i < whole) {
      q += static_cast<unsigned long long>(i) << k;
      h = k;
      return;
    }
    q += static_cast<unsigned long long>(whole) << k;
    i -= whole;
  }
  for (; i > 0; --i) q += 1ull << piece_height(q, end, k);
  h = piece_height(q, end, k);
}

// The index of the piece of [p0, end) that starts at chunk q
// (blake3_tail.py piece_index): piece_at's walk the other way.
__device__ long long piece_index(unsigned long long p0, unsigned long long end, int k,
                                 unsigned long long q) {
  const unsigned long long mask = (1ull << k) - 1;
  long long i = 0;
  unsigned long long x = p0;
  for (; x < q && (x & mask); ++i) x += 1ull << piece_height(x, end, k);
  if (x < q) {
    const unsigned long long whole = min((q - x) >> k, (end - x) >> k);
    i += static_cast<long long>(whole);
    x += whole << k;
  }
  for (; x < q; ++i) x += 1ull << piece_height(x, end, k);
  return i;
}

// The lane that holds the CV stack's node of height j of n chunks (its
// first chunk n with bits 0..j cleared): a CV-stack node before p0, else a
// piece's.
__device__ __forceinline__ int holder(const Input& in, unsigned long long n, int j, int k, int C,
                                      int c) {
  const unsigned long long q = j < 63 ? n & ~((2ull << j) - 1) : 0;
  const long long item = q < in.p0 ? __popcll(q) : in.n_stack + piece_index(in.p0, n, k, q);
  return (in.slot0 + static_cast<int>(item)) * C + c;
}

// The root of 2^h level-0 nodes from node `first` of column col, left to
// right with BLAKE3's stack rule; the next node's load runs ahead of the
// current one's compressions.
__device__ void piece_root(uint32_t cv[8], const Input& in, long long first, int h,
                           long long col) {
  uint32_t st[kMaxPiece + 1][8];
  int sp = 0;
  const long long n = 1ll << h;
  const uint32_t* p = in.level0 + first * in.step0 + col;
  uint32_t ahead[8];
  load_node(ahead, p, in.plane0);
  for (long long i = 0; i < n; ++i) {
    copy8(cv, ahead);
    if (i + 1 < n) load_node(ahead, p + (i + 1) * in.step0, in.plane0);
#ifdef BLAKE3_TAIL_CUT_COMPRESSIONS
    for (long long t = i + 1; !(t & 1); t >>= 1) {
      --sp;
      for (int w = 0; w < 8; ++w) cv[w] ^= st[sp][w];
    }
#else
    for (long long t = i + 1; !(t & 1); t >>= 1) node2(cv, st[--sp], cv, kParent);
#endif
    copy8(st[sp++], cv);
  }
  copy8(cv, st[0]);
}

// Block b of nb of a last chunk of len bytes staged at `bytes` (zero-padded)
__device__ __forceinline__ void tail_block(uint32_t cv[8], const uint8_t* bytes, int b, int nb,
                                           int len, unsigned long long counter, bool root) {
  uint32_t m[16];
  const uint32_t* words = reinterpret_cast<const uint32_t*>(bytes + 64 * b);
#pragma unroll
  for (int w = 0; w < 16; ++w) m[w] = words[w];
  const bool last = b == nb - 1;
  const uint32_t flags = (b == 0 ? kChunkStart : 0u) | (last ? kChunkEnd | (root ? kRoot : 0u) : 0u);
  compress(cv, m, counter, last ? static_cast<uint32_t>(len - 64 * b) : 64u, flags);
}

__device__ __forceinline__ int tail_blocks(int len) { return len > 64 ? (len + 63) / 64 : 1; }

__device__ __forceinline__ void store_row(uint8_t* row, const uint32_t h[8]) {
  uint32_t* o = reinterpret_cast<uint32_t*>(row);
#pragma unroll
  for (int w = 0; w < 8; ++w) o[w] = h[w];  // little-endian words
}

__global__ void __launch_bounds__(kMaxThreads, 1)
blake3_tail_kernel(const __grid_constant__ Leg g) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int T = blockDim.x, tid = threadIdx.x, C = g.C;
  uint32_t* s_cv = smem;                                       // [8][T]: each lane's node
  int* s_next = reinterpret_cast<int*>(smem + 8 * T);          // [T]: the next live node
  int* s_h = s_next + T;                                       // [T]: its height
  uint32_t* s_root = reinterpret_cast<uint32_t*>(s_h + T);     // [C][4][8]: the inputs' roots
  uint8_t* s_tail = reinterpret_cast<uint8_t*>(s_root + C * kMaxInputs * 8);
  const long long col0 = static_cast<long long>(blockIdx.x) * C;

  // the last chunks' bytes, C adjacent columns a row: column c's at
  // s_tail[tail_smem + c * pad + i]; kStage loads in flight a thread
  const int log_c = __ffs(C) - 1;
  for (int s = 0; s < g.n_in; ++s) {
    const Input& in = g.in[s];
    if (in.rows != nullptr || g.stack_launch) continue;
    const int pad = 64 * tail_blocks(in.tail_len);
    uint8_t* dst = s_tail + in.tail_smem;
    for (int i0 = tid; i0 < C * pad; i0 += kStage * T) {
      uint8_t b[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int i = i0 + u * T, row = i >> log_c;
        const long long col = col0 + (i & (C - 1));
        b[u] = i < C * pad && row < in.tail_len && col < g.R ? in.tail[row * in.tail_step + col] : 0;
      }
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int i = i0 + u * T;
        if (i < C * pad) dst[(i & (C - 1)) * pad + (i >> log_c)] = b[u];
      }
    }
  }

  const int c = tid % C, slot = tid / C;
  const long long col = col0 + c;
  const bool valid = col < g.R && slot < g.slots;
  int s = 0;
  for (int i = 1; i < g.n_in; ++i) {
    if (slot >= g.in[i].slot0) s = i;
  }
  const Input& in = g.in[s];
  const int item = slot - in.slot0;
  const bool is_item = valid && item < in.items;
  const bool own = valid && item == in.items;  // the input's own lane
  const bool hashing = own && in.rows == nullptr && !g.stack_launch;
  const unsigned long long n_chunks = in.p0 + static_cast<unsigned long long>(in.c0);
  __syncthreads();

  // the nodes: a CV-stack node loaded, or a piece reduced
  uint32_t cv[8];
  unsigned long long pos = 0;
  int h = 0;
  if (is_item) {
    if (item < in.n_stack) {
      const int e = in.stack0 + item;
      load_node(cv, g.stack_node[e] + col, g.stack_plane[e]);
      pos = g.stack_pos[e];
      h = g.stack_h[e];
    } else {
      piece_at(in.p0, n_chunks, g.k, item - in.n_stack, pos, h);
      piece_root(cv, in, static_cast<long long>(pos - in.p0), h, col);
    }
  }
  // the own lane: the last chunk's first blocks meanwhile
  uint32_t tcv[8];
  int blk = 0, nb = 0;
  const uint8_t* tbytes = nullptr;
  if (hashing) {
    nb = tail_blocks(in.tail_len);
    tbytes = s_tail + in.tail_smem + c * 64 * nb;
#pragma unroll
    for (int w = 0; w < 8; ++w) tcv[w] = kIV[w];
    for (; blk < nb && blk < (1 << g.k); ++blk)
      tail_block(tcv, tbytes, blk, nb, in.tail_len, n_chunks, n_chunks == 0);
  }
  int next = -1;
  if (is_item) {
    next = item + 1 < in.items ? tid + C : -1;
#pragma unroll
    for (int w = 0; w < 8; ++w) s_cv[w * T + tid] = cv[w];
    s_h[tid] = h;
    s_next[tid] = next;
  }

#ifdef BLAKE3_TAIL_CUT_AFTER_PIECES
  if (g.R > 0) return;
#endif
  // the merge: each round every left child takes in its right neighbour of
  // its height (blake3_tail.py merge_order); the own lanes hash a block of
  // their last chunk a round and then fold the CV stack's nodes into it,
  // right to left, each as soon as it is formed (height j for bit j of the
  // chunk count, the last fold the root)
  unsigned long long fold = hashing ? n_chunks : 0;  // the bits still to fold
  int fold_t = fold ? holder(in, n_chunks, __ffsll(static_cast<long long>(fold)) - 1, g.k, C, c) : 0;
  for (;;) {
    __syncthreads();
    bool merged = false;
    int after = -1;
    if (is_item && next >= 0 && !((pos >> h) & 1ull) && s_h[next] == h) {
      uint32_t right[8];
#pragma unroll
      for (int w = 0; w < 8; ++w) right[w] = s_cv[w * T + next];
      after = s_next[next];
      node2(cv, cv, right, kParent);
      merged = true;
    }
    if (blk < nb) {
      tail_block(tcv, tbytes, blk, nb, in.tail_len, n_chunks, n_chunks == 0);
      ++blk;
    }
    while (blk == nb && fold && s_h[fold_t] == __ffsll(static_cast<long long>(fold)) - 1) {
      uint32_t left[8];
#pragma unroll
      for (int w = 0; w < 8; ++w) left[w] = s_cv[w * T + fold_t];
      fold &= fold - 1;
      node2(tcv, left, tcv, kParent | (fold ? 0u : kRoot));
      if (fold) fold_t = holder(in, n_chunks, __ffsll(static_cast<long long>(fold)) - 1, g.k, C, c);
    }
    if (!__syncthreads_or(merged || blk < nb || fold)) break;
    if (merged) {
      ++h;
      next = after;
#pragma unroll
      for (int w = 0; w < 8; ++w) s_cv[w * T + tid] = cv[w];
      s_h[tid] = h;
      s_next[tid] = next;
    }
  }

  // the own lane: its root, or the CV stack left (the live nodes from the
  // input's first) written out
  const int first = in.slot0 * C + c;
  if (hashing) {
    copy8(s_root + (c * kMaxInputs + s) * 8, tcv);
    if (in.hash_out != nullptr) store_row(in.hash_out + 32 * col, tcv);
  } else if (own && in.rows != nullptr) {
    const uint8_t* row = in.rows + 32 * col;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      s_root[(c * kMaxInputs + s) * 8 + w] =
          static_cast<uint32_t>(row[4 * w]) | (static_cast<uint32_t>(row[4 * w + 1]) << 8) |
          (static_cast<uint32_t>(row[4 * w + 2]) << 16) |
          (static_cast<uint32_t>(row[4 * w + 3]) << 24);
    }
  } else if (own && g.stack_launch && in.items) {
    const long long plane = static_cast<long long>(g.n_out) * g.R;
    int i = 0;
    for (int t = first; t >= 0 && i < g.n_out; t = s_next[t], ++i) {
#pragma unroll
      for (int w = 0; w < 8; ++w) g.stack_out[w * plane + i * static_cast<long long>(g.R) + col] = s_cv[w * T + t];
    }
  }
  __syncthreads();

  // the pair hashes: H(x0 || x1) on input 0's lane, H(x2 || x3) on input 2's,
  // then H of the two
  const uint32_t kPair = kChunkStart | kChunkEnd | kRoot;
  uint32_t* roots = s_root + c * kMaxInputs * 8;
  uint32_t top[8];
  if (own && s == 0 && !g.stack_launch) {
    copy8(top, roots);
    if (g.n_in >= 2) node2(top, roots, roots + 8, kPair);
  }
  if (own && s == 2) node2(roots + 16, roots + 16, roots + 24, kPair);
  __syncthreads();
  if (own && s == 0 && !g.stack_launch) {
    if (g.n_in == 4) node2(top, top, roots + 16, kPair);
    store_row(g.out + 32 * col, top);
  }
}

}  // namespace

// The registers a thread of blake3_tail_kernel holds (blake3_tail.py plan
// sizes the blocks an SM holds by it), or -1 on an error.
extern "C" int reverie_blake3_tail_registers() {
  cudaFuncAttributes attr;
  return cudaFuncGetAttributes(&attr, blake3_tail_kernel) == cudaSuccess ? attr.numRegs : -1;
}

// The launch's int64 words (crypto/kernels/blake3_tail.py _launch): a
// header, 16 words an input, 4 a CV-stack node.
extern "C" int reverie_blake3_tail(const long long* w, void* stream) {
  Leg g = {};
  g.n_in = static_cast<int>(w[0]);
  g.R = static_cast<int>(w[1]);
  g.C = static_cast<int>(w[2]);
  g.k = static_cast<int>(w[3]);
  g.slots = static_cast<int>(w[4]);
  const int threads = static_cast<int>(w[5]), blocks = static_cast<int>(w[6]);
  const int smem = static_cast<int>(w[7]);
  g.out = reinterpret_cast<uint8_t*>(w[8]);
  g.stack_out = reinterpret_cast<uint32_t*>(w[9]);
  g.n_out = static_cast<int>(w[10]);
  g.stack_launch = g.stack_out != nullptr;
  const int n_stack = static_cast<int>(w[11]);
  if (g.n_in < 1 || g.n_in > kMaxInputs || n_stack > kMaxStack || g.k > kMaxPiece ||
      threads > kMaxThreads || threads < g.C * g.slots || g.C < 1 || (g.C & (g.C - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int s = 0; s < g.n_in; ++s) {
    const long long* v = w + kHeaderWords + s * kInputWords;
    Input& in = g.in[s];
    in.level0 = reinterpret_cast<const uint32_t*>(v[0]);
    in.c0 = v[1];
    in.plane0 = v[2];
    in.step0 = v[3];
    in.p0 = static_cast<unsigned long long>(v[4]);
    in.tail = reinterpret_cast<const uint8_t*>(v[5]);
    in.tail_step = v[6];
    in.tail_len = static_cast<int>(v[7]);
    in.rows = reinterpret_cast<const uint8_t*>(v[8]);
    in.hash_out = reinterpret_cast<uint8_t*>(v[9]);
    in.items = static_cast<int>(v[10]);
    in.slot0 = static_cast<int>(v[11]);
    in.stack0 = static_cast<int>(v[12]);
    in.n_stack = static_cast<int>(v[13]);
    in.tail_smem = static_cast<int>(v[14]);
  }
  for (int e = 0; e < n_stack; ++e) {
    const long long* v = w + kHeaderWords + kMaxInputs * kInputWords + e * kStackWords;
    g.stack_node[e] = reinterpret_cast<const uint32_t*>(v[0]);
    g.stack_plane[e] = v[1];
    g.stack_pos[e] = static_cast<unsigned long long>(v[2]);
    g.stack_h[e] = static_cast<int>(v[3]);
  }
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        blake3_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  blake3_tail_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}
