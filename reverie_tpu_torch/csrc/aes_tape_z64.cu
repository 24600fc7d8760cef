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
// What bounds it on the H100: the AES rounds, as for aes_tape.cu.  The main
// path's tape (mz = 100,002, R = 256) is 1.64 GB of stores, 0.5 ms at
// 3.35 TB/s, but 50,001 x 2,048 = 102M AES blocks at 160 table lookups each.
//
// What the design does about it: one thread per (counter block b, player p,
// repetition r), r fastest, running the T-table AES of aes_core.cuh with its
// tables in shared memory.  A warp's 32 threads then hold 32 neighbouring
// int64 of one (m, p) row and each of its two stores is one 256-byte
// coalesced write.  The 16 keystream bytes become the two words by byte
// swaps of the big-endian column words.  Only ceil(mz/2) blocks run; the
// second word of the last block is masked at row mz when mz is odd.
// Bitslicing and wider stores are later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "aes_core.cuh"

namespace {

constexpr int kThreads = 256;

// two big-endian column words (keystream bytes 4c..4c+7) -> the
// little-endian u64 of those 8 bytes
__device__ __forceinline__ unsigned long long le_word(uint32_t c0, uint32_t c1) {
  return static_cast<unsigned long long>(__byte_perm(c0, 0, 0x0123)) |
         (static_cast<unsigned long long>(__byte_perm(c1, 0, 0x0123)) << 32);
}

__global__ void __launch_bounds__(kThreads)
aes_tape_z64_kernel(const uint8_t* __restrict__ round_keys,  // (R*8, 11, 16)
                    const uint8_t* __restrict__ omit,        // (R,), 8 = none
                    unsigned long long* __restrict__ out,    // (mz, 8, R)
                    long long mz, int R, long long n_blocks,
                    unsigned long long start_block) {
  __shared__ uint32_t te[4][256];
  __shared__ uint32_t sbox[256];
  build_aes_tables(te, sbox);
  __syncthreads();

  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n_blocks * 8 * R) return;
  const long long bp = idx / R;  // b * 8 + p
  const int r = static_cast<int>(idx - bp * R);
  const int p = static_cast<int>(bp & 7);
  const long long b = bp >> 3;

  unsigned long long w0 = 0, w1 = 0;
  if (omit[r] != p) {
    uint32_t ks[4];
    aes_ctr_block(round_keys + (static_cast<size_t>(r) * 8 + p) * 176,
                  start_block + static_cast<unsigned long long>(b), te, sbox, ks);
    w0 = le_word(ks[0], ks[1]);
    w1 = le_word(ks[2], ks[3]);
  }
  const long long row = 2 * b;  // word 2b, then 2b + 1
  const size_t stride = static_cast<size_t>(8) * R;
  unsigned long long* dst = out + static_cast<size_t>(row) * stride +
                            static_cast<size_t>(p) * R + r;
  dst[0] = w0;
  if (row + 1 < mz) dst[stride] = w1;
}

}  // namespace

extern "C" int reverie_aes_tape_z64(const void* round_keys, const void* omit,
                                    void* out, long long mz, int R,
                                    long long start_block, void* stream) {
  const long long n_blocks = (mz + 1) / 2;
  const long long n_threads = n_blocks * 8 * R;
  const long long grid = (n_threads + kThreads - 1) / kThreads;
  aes_tape_z64_kernel<<<static_cast<unsigned int>(grid), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(round_keys), static_cast<const uint8_t*>(omit),
      static_cast<unsigned long long*>(out), mz, R, n_blocks,
      static_cast<unsigned long long>(start_block));
  return static_cast<int>(cudaGetLastError());
}
