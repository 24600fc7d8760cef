// GF(2) mask tape: AES-128-CTR keystream of the 8 player keys of every
// repetition, bit-transposed into one tape byte per (tape slot, repetition).
//
// Replaces reverie_tpu/crypto/kernels/aes_pallas.py:_aes_tape_kernel (the
// bitsliced Pallas tape kernel) together with its u8 store tail
// _u8_relayout_kernel: this kernel stores rep-ordered u8 rows itself.
//
// Contract (equal to tpu_host.build_tapes(keys, omit, m2, 0)[0]):
//   out[b*128 + by*8 + j, r] bit (7-p) = bit (7-j) of byte `by` of the
//   keystream block `start_block + b` of player key r*8 + p, for p != omit[r];
//   the omitted player's bit is 0.  The CTR block is a big-endian 128-bit
//   counter with a zero IV.
//
// What bounds it on the H100: the AES table lookups.  The main path's tape
// (m2 = 2,000,002, R = 256) is 512 MB of stores, 0.15 ms at 3.35 TB/s, and
// 15,626 x 2,048 = 32M AES blocks: 242 ALU instructions each (0.46 ms,
// roofline.py) and 160 shared-memory lookups, 160M warp lookups, 0.61 ms at
// one wavefront per clock per SM if no lookup meets a bank conflict (one
// shared 1 KiB table costs ~3.16 wavefronts a lookup).
//
// What the design does about it: the tape core of aes_core.cuh (the four
// T-tables replicated once per bank, one byte permute per lookup address,
// round keys in registers, two counter blocks at a time, a persistent grid
// that builds the tables once per thread block).  A thread block of kThreads
// keys takes kThreads / 8 reps and a run of counter blocks.  Lane m of warp
// w holds player 7 - (m & 7) of rep r0 + 4w + (m >> 3), so that bit m of a
// 32-bit word is bit (7-p) of rep (m >> 3)'s tape byte.  Per counter block,
// each lane's 128 keystream bits (bit-reversed column words: bit c of word
// q is tape slot 32q + c) go through a 32 x 32 bit transpose across the warp
// (5 shuffle stages on 4 words, where one ballot per bit would take 128
// ballots and selects), after which lane l holds, for slots 32q + l, the 4
// tape bytes of the warp's 4 reps.  The warps stage their words in shared
// memory, so that each tape row's bytes of the block's reps leave as one
// contiguous segment: a warp's 4-byte stores cover whole row segments.  R
// not a multiple of 4 stores bytes; lanes past R vote zero; a ragged m2 is
// masked at row m2.  On an H100 it runs at ~1.0 ms against the lookups'
// 0.61 ms: the shuffles share the lookups' pipe, and a block barrier per
// counter block holds the warps together (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

#include "aes_core.cuh"

namespace {

constexpr int kThreads = kTapeThreads;          // kThreads / 8 reps per block
constexpr int kReps = kThreads / 8;
constexpr int kWarps = kThreads / 32;             // 4-byte words of a staged row
constexpr int kSlots = 128;                       // tape slots per counter block
constexpr int kStageStride = kWarps + 1;          // odd: a warp's column stores hit 32 banks
constexpr int kStageWords = kSlots * kStageStride;
constexpr size_t kSmemBytes = kTeBytes + 2 * kStageWords * 4;  // tables, 2 stages

__global__ void __launch_bounds__(kThreads, 1)
aes_tape_gf2_kernel(const uint8_t* __restrict__ round_keys,  // (R*8, 11, 16)
                    const uint8_t* __restrict__ omit,        // (R,), 8 = none
                    uint8_t* __restrict__ out,               // (m2, R)
                    long long m2, int R, long long n_blocks, long long run,
                    unsigned long long start_block) {
  extern __shared__ uint32_t smem[];
  uint32_t* te = smem;
  uint32_t* stage = smem + kTeBytes / 4;
  build_te_x32(te);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long n_groups = (R + kReps - 1) / kReps;
  const long long n_items = (n_blocks + run - 1) / run * n_groups;
  const bool words = (R & 3) == 0;
  int buf = 0;

  // items are uniform across the thread block, so the __syncthreads below are
  for (long long item = blockIdx.x; item < n_items; item += gridDim.x) {
    const long long run_i = item / n_groups;
    const int r0 = static_cast<int>(item - run_i * n_groups) * kReps;
    const bool warp_live = r0 + 4 * warp < R;  // uniform across the warp
    const int r = r0 + 4 * warp + (lane >> 3);
    const int p = 7 - (lane & 7);
    uint32_t k[44];
    uint32_t keep = 0;
    if (warp_live) {
      const int rc = r < R ? r : R - 1;  // lanes past R run a valid key, vote 0
      load_round_keys(round_keys + (static_cast<size_t>(rc) * 8 + p) * 176, k);
      keep = r < R && omit[r] != p ? 0xffffffffu : 0u;
    }

    const long long b0 = run_i * run;
    const long long b1 = b0 + run < n_blocks ? b0 + run : n_blocks;
    for (long long b = b0; b < b1; b += kIlp) {
      uint32_t ks[kIlp][4];
      if (warp_live) {
        uint64_t ctr[kIlp];
#pragma unroll
        for (int i = 0; i < kIlp; ++i) ctr[i] = start_block + static_cast<unsigned long long>(b + i);
        aes_ctr_blocks_x32(k, ctr, te, lane, ks);
      }
#pragma unroll
      for (int i = 0; i < kIlp; ++i) {
        if (b + i >= b1) break;  // uniform across the thread block
        uint32_t* st = stage + buf * kStageWords;
        if (warp_live) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            // bit c of brev(ks[q]) is bit (7 - c%8) of keystream byte 4q + c/8: slot 32q + c
            st[(q * 32 + lane) * kStageStride + warp] =
                warp_transpose32(__brev(ks[i][q] & keep), lane);
          }
        }
        __syncthreads();
        // tape rows (b+i)*128 .. +127, the block's reps: kWarps words a row, 32 rows a pass
        const int w = threadIdx.x % kWarps;
        const int rr = r0 + 4 * w;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int slot = q * 32 + threadIdx.x / kWarps;
          const long long s = (b + i) * kSlots + slot;
          if (s < m2 && rr < R) {
            const uint32_t v = st[slot * kStageStride + w];
            uint8_t* dst = out + s * R + rr;
            if (words) {
              *reinterpret_cast<uint32_t*>(dst) = v;
            } else {
              for (int e = 0; e < 4 && rr + e < R; ++e) dst[e] = static_cast<uint8_t>(v >> (8 * e));
            }
          }
        }
        buf ^= 1;  // the next block writes the other stage; this one is read before its barrier
      }
    }
  }
}

}  // namespace

// The launch at (m2, R): plan = {dynamic shared bytes, resident thread
// blocks on the card, counter blocks per work item, grid}.
extern "C" int reverie_aes_tape_gf2_plan(long long m2, int R, long long* plan) {
  const long long n_blocks = (m2 + kSlots - 1) / kSlots;
  int slots = 0;
  const cudaError_t e = persistent_blocks<aes_tape_gf2_kernel>(kThreads, kSmemBytes, &slots);
  const long long n_groups = (R + kReps - 1) / kReps;
  const long long run = run_length(n_blocks, n_groups, slots);
  plan[0] = static_cast<long long>(kSmemBytes);
  plan[1] = slots;
  plan[2] = run;
  plan[3] = std::min<long long>(slots, (n_blocks + run - 1) / run * n_groups);
  return static_cast<int>(e);
}

extern "C" int reverie_aes_tape_gf2(const void* round_keys, const void* omit,
                                    void* out, long long m2, int R,
                                    long long start_block, void* stream) {
  long long plan[4];
  const int e = reverie_aes_tape_gf2_plan(m2, R, plan);
  if (e != 0) return e;
  aes_tape_gf2_kernel<<<static_cast<unsigned int>(plan[3]), kThreads, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(round_keys), static_cast<const uint8_t*>(omit),
      static_cast<uint8_t*>(out), m2, R, (m2 + kSlots - 1) / kSlots, plan[2],
      static_cast<unsigned long long>(start_block));
  return static_cast<int>(cudaGetLastError());
}
