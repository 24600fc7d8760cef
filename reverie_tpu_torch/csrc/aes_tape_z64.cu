// Z64 mask tape: the AES-128-CTR keystream of every player key of every
// repetition, read as little-endian 64-bit words.
//
// Replaces reverie_tpu/crypto/kernels/aes_pallas.py:_aes_tape_z64_kernel
// (the bitsliced Pallas z64 tape kernel, entry aes_ctr_tape_z64_pallas) and
// its key-row permutation and zero-key rep padding, which exist only for
// the TPU's lane layout.
//
// Contract (equal to tpu_host.build_tapes(keys, omit, 0, mz)'s lo | hi << 32):
//   out[m, p, r] = little-endian u64 of keystream bytes 8*(m%2) .. +8 of the
//   CTR block `start_block + m/2` of player key r*8 + p, and 0 where
//   p == omit[r] (omit 8 = no player omitted).  The CTR block is a
//   big-endian 128-bit counter with a zero IV.
//
// What bounds it on the H100: the AES table lookups.  The main path's tape
// (mz = 100,002, R = 256) is 1.64 GB of stores, 0.5 ms at 3.35 TB/s, and
// 50,001 x 2,048 = 102M AES blocks: 242 ALU instructions each (0.74 ms at
// the SMs' issue rate, roofline.py) and 160 shared-memory lookups, 512M warp
// lookups, 1.96 ms at one wavefront per clock per SM if no lookup meets a
// bank conflict (one shared 1 KiB table costs ~3.16 wavefronts a lookup).
//
// What the design does about it: the tape core of aes_core.cuh (the four
// T-tables replicated once per bank, one byte permute per lookup address,
// round keys in registers, two counter blocks at a time, a persistent grid
// that builds the tables once per thread block and walks (key warp, counter
// run) work items).  The 8R keys are numbered j = p*R + r, the order of a
// tape row, and a warp's 32 lanes take 32 consecutive j: each of a block's
// two 8-byte stores is one 256-byte coalesced row segment, and every R
// fills all but the last warp.  An omitted player's lane stores zeros and
// skips the AES.  The second word of the last block is masked at row mz
// when mz is odd.  On an H100 it runs at ~2.0 ms, at the lookups' 1.96 ms
// (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

#include "aes_core.cuh"

namespace {

constexpr int kThreads = kTapeThreads;
constexpr int kWarps = kThreads / 32;

// two big-endian column words (keystream bytes 4c..4c+7) -> the
// little-endian u64 of those 8 bytes
__device__ __forceinline__ unsigned long long le_word(uint32_t c0, uint32_t c1) {
  return static_cast<unsigned long long>(__byte_perm(c0, 0, 0x0123)) |
         (static_cast<unsigned long long>(__byte_perm(c1, 0, 0x0123)) << 32);
}

__global__ void __launch_bounds__(kThreads, 1)
aes_tape_z64_kernel(const uint8_t* __restrict__ round_keys,  // (R*8, 11, 16)
                    const uint8_t* __restrict__ omit,        // (R,), 8 = none
                    unsigned long long* __restrict__ out,    // (mz, 8, R)
                    long long mz, int R, long long n_blocks, long long run,
                    unsigned long long start_block) {
  extern __shared__ uint32_t te[];
  build_te_x32(te);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int n_keys = 8 * R;
  const long long n_kw = (n_keys + 31) / 32;
  const long long n_items = (n_blocks + run - 1) / run * n_kw;
  const size_t row = static_cast<size_t>(n_keys);  // one tape row: (8, R) words

  for (long long item = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       item < n_items; item += static_cast<long long>(gridDim.x) * kWarps) {
    const long long run_i = item / n_kw;
    const int j = static_cast<int>(item - run_i * n_kw) * 32 + lane;  // p*R + r
    if (j >= n_keys) continue;
    const int p = j / R;
    const int r = j - p * R;
    const bool live = omit[r] != p;
    uint32_t k[44];
    load_round_keys(round_keys + (static_cast<size_t>(r) * 8 + p) * 176, k);

    const long long b0 = run_i * run;
    const long long b1 = b0 + run < n_blocks ? b0 + run : n_blocks;
    for (long long b = b0; b < b1; b += kIlp) {
      uint32_t ks[kIlp][4] = {};
      if (live) {
        uint64_t ctr[kIlp];
#pragma unroll
        for (int i = 0; i < kIlp; ++i) ctr[i] = start_block + static_cast<unsigned long long>(b + i);
        aes_ctr_blocks_x32(k, ctr, te, lane, ks);
      }
#pragma unroll
      for (int i = 0; i < kIlp; ++i) {
        const long long m = 2 * (b + i);  // tape rows m, m + 1
        if (b + i < b1) {
          unsigned long long* dst = out + static_cast<size_t>(m) * row + j;
          dst[0] = le_word(ks[i][0], ks[i][1]);
          if (m + 1 < mz) dst[row] = le_word(ks[i][2], ks[i][3]);
        }
      }
    }
  }
}

}  // namespace

// The launch at (mz, R): plan = {dynamic shared bytes, resident thread
// blocks on the card, counter blocks per work item, grid}.
extern "C" int reverie_aes_tape_z64_plan(long long mz, int R, long long* plan) {
  const long long n_blocks = (mz + 1) / 2;
  int slots = 0;
  const cudaError_t e = persistent_blocks<aes_tape_z64_kernel>(kThreads, kTeBytes, &slots);
  const long long n_kw = (8LL * R + 31) / 32;
  const long long run = run_length(n_blocks, n_kw, static_cast<long long>(slots) * kWarps);
  const long long n_warps = (n_blocks + run - 1) / run * n_kw;
  plan[0] = static_cast<long long>(kTeBytes);
  plan[1] = slots;
  plan[2] = run;
  plan[3] = std::min<long long>(slots, (n_warps + kWarps - 1) / kWarps);
  return static_cast<int>(e);
}

extern "C" int reverie_aes_tape_z64(const void* round_keys, const void* omit,
                                    void* out, long long mz, int R,
                                    long long start_block, void* stream) {
  long long plan[4];
  const int e = reverie_aes_tape_z64_plan(mz, R, plan);
  if (e != 0) return e;
  aes_tape_z64_kernel<<<static_cast<unsigned int>(plan[3]), kThreads, kTeBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(round_keys), static_cast<const uint8_t*>(omit),
      static_cast<unsigned long long*>(out), mz, R, (mz + 1) / 2, plan[2],
      static_cast<unsigned long long>(start_block));
  return static_cast<int>(cudaGetLastError());
}
