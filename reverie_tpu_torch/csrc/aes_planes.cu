// Raw AES-128-CTR keystream of K keys as bitsliced planes, without a mask.
//
// Replaces reverie_tpu/crypto/kernels/aes_pallas.py:_aes_kernel (entry
// aes_ctr_planes_pallas), the TPU's bitsliced keystream kernel.
//
// Contract: out is (16, 8, B, Kw) u32 with Kw = K / 32.  Bit j of
// out[by][bit][b][w] is bit `bit` (LSB first) of byte `by` of the keystream
// block b under key 32w + j (round keys rep-major, (K, 11, 16) u8).  The
// CTR block is a big-endian 128-bit counter with block index b and a zero
// IV, as in the tape kernels.
//
// What bounds it on the H100: the AES table lookups.  At the probe's shape
// (B = 15,626, K = 2,048: 32M AES blocks) it stores 512 MB, 0.15 ms at
// 3.35 TB/s, and runs 242 ALU instructions per block (0.46 ms, roofline.py)
// and 160 shared-memory lookups, 160M warp lookups, 0.61 ms at one
// wavefront per clock per SM: the AES work of the GF(2) tape kernel
// (aes_tape.cu) at the main path's shape.
//
// What the design does about it: the core of aes_core.cuh (the four
// T-tables replicated once per bank, one byte permute per lookup address,
// round keys in registers, two counter blocks at a time, a persistent grid
// that builds the tables once per thread block).  A work item is 16
// consecutive plane words w0 .. w0 + 15 and a run of counter blocks; lane l
// of warp g holds key 32(w0 + g) + l.  Per counter block, each of a lane's 4
// big-endian column words goes through a 32 x 32 bit transpose across the
// warp (5 shuffle stages, where one ballot per bit would take 128 ballots
// and selects), after which lane l of word q holds the plane word of byte
// 4q + 3 - (l >> 3), bit l & 7.  The warps stage the 128 x 16 words of
// each of a pair's counter blocks in shared memory (two stages of a pair,
// one barrier per pair, a swizzle under which both the warps' writes and
// the block's reads meet no bank conflict), and each plane row's 16 words at
// b leave as one 64-byte segment.  When Kw is not a multiple of 16, the last
// group's surplus warps skip the AES and their words are not stored.  On an
// H100 it runs at ~0.94 ms (PERF.md): one barrier per counter block took
// ~0.96, and unstaged stores (32 rows a warp store) ~3.1.

#include <cstdint>
#include <cuda_runtime.h>

#include "aes_core.cuh"

namespace {

constexpr int kThreads = kTapeThreads;
constexpr int kWarps = kThreads / 32;  // plane words per work item
constexpr int kPlanes = 128;           // (byte, bit) planes per counter block
constexpr int kStageWords = kPlanes * kWarps;  // one counter block
constexpr size_t kSmemBytes = kTeBytes + 2 * kIlp * kStageWords * 4;  // tables, 2 stages of a pair

// Staged word of plane `plane`, plane word w0 + w, within a counter block's
// kStageWords: rows of kWarps words, w swizzled by bits 1..4 of the plane.
// A warp's write (32 planes 32q .. 32q + 31, one w) and a warp's read
// (planes 2i, 2i + 1, every w) each touch 32 banks.
__device__ __forceinline__ int stage_at(int plane, int w) {
  return plane * kWarps + (w ^ ((plane >> 1) & (kWarps - 1)));
}

__global__ void __launch_bounds__(kThreads, 1)
aes_ctr_planes_kernel(const uint8_t* __restrict__ round_keys,  // (K, 11, 16)
                      uint32_t* __restrict__ out,              // (16, 8, B, Kw)
                      long long n_blocks, int kw, long long run) {
  extern __shared__ uint32_t smem[];
  uint32_t* te = smem;
  uint32_t* stage = smem + kTeBytes / 4;
  build_te_x32(te);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long n_groups = (kw + kWarps - 1) / kWarps;
  const long long n_items = (n_blocks + run - 1) / run * n_groups;
  // after the transpose, lane l of word q holds plane 32q + lane_plane
  const int lane_plane = (3 - (lane >> 3)) * 8 + (lane & 7);
  const size_t plane_stride = static_cast<size_t>(n_blocks) * kw;
  int buf = 0;

  // items and runs are uniform across the thread block
  for (long long item = blockIdx.x; item < n_items; item += gridDim.x) {
    const long long run_i = item / n_groups;
    const int w0 = static_cast<int>(item - run_i * n_groups) * kWarps;
    const bool warp_live = w0 + warp < kw;  // uniform across the warp
    uint32_t k[44];
    if (warp_live) {
      load_round_keys(round_keys + (static_cast<size_t>(w0 + warp) * 32 + lane) * 176, k);
    }

    const long long b0 = run_i * run;
    const long long b1 = b0 + run < n_blocks ? b0 + run : n_blocks;
    for (long long b = b0; b < b1; b += kIlp) {
      uint32_t ks[kIlp][4];
      if (warp_live) {
        uint64_t ctr[kIlp];
#pragma unroll
        for (int i = 0; i < kIlp; ++i) ctr[i] = static_cast<uint64_t>(b + i);
        aes_ctr_blocks_x32(k, ctr, te, lane, ks);
      }
      // the pair's words; the __syncthreads that follows is uniform across the block
      uint32_t* st = stage + buf * kIlp * kStageWords;
      if (warp_live) {
#pragma unroll
        for (int i = 0; i < kIlp; ++i) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            st[i * kStageWords + stage_at(32 * q + lane_plane, warp)] =
                warp_transpose32(ks[i][q], lane);
          }
        }
      }
      __syncthreads();
      // plane rows at b + i, words w0 .. w0 + 15: 32 rows a pass
      const int w = threadIdx.x % kWarps;
#pragma unroll
      for (int i = 0; i < kIlp; ++i) {
        if (b + i >= b1 || w0 + w >= kw) break;
        uint32_t* dst = out + static_cast<size_t>(b + i) * kw + w0 + w;
#pragma unroll
        for (int pass = 0; pass < kStageWords / kThreads; ++pass) {
          const int plane = pass * (kThreads / kWarps) + threadIdx.x / kWarps;
          dst[plane * plane_stride] = st[i * kStageWords + stage_at(plane, w)];
        }
      }
      buf ^= 1;  // the next pair writes the other stage; this one is read before its barrier
    }
  }
}

}  // namespace

// The launch at (B, Kw): plan = {dynamic shared bytes, resident thread
// blocks on the card, counter blocks per work item, grid}.
extern "C" int reverie_aes_ctr_planes_plan(long long n_blocks, int kw, long long* plan) {
  int slots = 0;
  const cudaError_t e = persistent_blocks<aes_ctr_planes_kernel>(kThreads, kSmemBytes, &slots);
  const long long n_groups = (kw + kWarps - 1) / kWarps;
  const long long run = run_length(n_blocks, n_groups, slots);
  plan[0] = static_cast<long long>(kSmemBytes);
  plan[1] = slots;
  plan[2] = run;
  plan[3] = std::min<long long>(slots, (n_blocks + run - 1) / run * n_groups);
  return static_cast<int>(e);
}

extern "C" int reverie_aes_ctr_planes(const void* round_keys, void* out,
                                      long long n_blocks, int kw, void* stream) {
  long long plan[4];
  const int e = reverie_aes_ctr_planes_plan(n_blocks, kw, plan);
  if (e != 0) return e;
  aes_ctr_planes_kernel<<<static_cast<unsigned int>(plan[3]), kThreads, kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(round_keys), static_cast<uint32_t*>(out), n_blocks, kw,
      plan[2]);
  return static_cast<int>(cudaGetLastError());
}
