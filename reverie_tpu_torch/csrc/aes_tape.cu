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
// What bounds it on the H100: the AES rounds, not memory.  The main path's
// tape (m2 = 2,000,002, R = 256) is 512 MB of stores, 0.15 ms at 3.35 TB/s,
// but 15,626 x 2,048 = 32M AES blocks at 160 table lookups each, i.e. 5.1G
// shared-memory lookups with data-dependent bank conflicts, plus 512M
// one-byte stores issued through the load/store units.
//
// What the design does about it: one thread per (counter block, repetition),
// neighbouring threads on neighbouring repetitions.  AES uses the four
// 1 KiB T-tables (S-box and MixColumns folded together) built in shared
// memory per block, so a round is 16 lookups and 16 XORs (aes_core.cuh,
// shared with the z64 tape kernel).  The 8 players'
// keystream stays in 32 registers; each of the 16 byte positions becomes 8
// tape bytes through one 8x8 bit transpose of a 64-bit word.  Each tape row
// store is 32 neighbouring bytes per warp, so the stores coalesce.  Ragged
// final blocks are masked at row m2.  Bitslicing (the TPU design) and
// wider stores are later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "aes_core.cuh"

namespace {

constexpr int kThreads = 256;

// 8x8 bit-matrix transpose; row i is byte (7-i) of x (the top byte is row
// 0), column c is bit (7-c) of a row byte (Hacker's Delight 7-3).
__device__ __forceinline__ uint64_t transpose8x8(uint64_t x) {
  uint64_t t;
  t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAull;
  x = x ^ t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCull;
  x = x ^ t ^ (t << 14);
  t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ull;
  x = x ^ t ^ (t << 28);
  return x;
}

__global__ void __launch_bounds__(kThreads)
aes_tape_gf2_kernel(const uint8_t* __restrict__ round_keys,  // (R*8, 11, 16)
                    const uint8_t* __restrict__ omit,        // (R,), 8 = none
                    uint8_t* __restrict__ out,               // (m2, R)
                    long long m2, int R, long long n_blocks,
                    unsigned long long start_block) {
  __shared__ uint32_t te[4][256];
  __shared__ uint32_t sbox[256];
  build_aes_tables(te, sbox);
  __syncthreads();

  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n_blocks * R) return;
  const long long b = idx / R;
  const int r = static_cast<int>(idx - b * R);
  const uint64_t ctr = start_block + static_cast<uint64_t>(b);

  uint32_t ks[8][4];
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    aes_ctr_block(round_keys + (static_cast<size_t>(r) * 8 + p) * 176, ctr, te,
                  sbox, ks[p]);
  }
  const int om = omit[r];
  const uint8_t keep = om < 8 ? static_cast<uint8_t>(~(0x80u >> om)) : 0xff;

  uint8_t* col = out + r;
  const long long row0 = b * 128;
#pragma unroll
  for (int by = 0; by < 16; ++by) {
    const int sh = 24 - 8 * (by & 3);
    uint64_t x = 0;
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      x |= static_cast<uint64_t>((ks[p][by >> 2] >> sh) & 0xff) << (8 * (7 - p));
    }
    x = transpose8x8(x);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long row = row0 + by * 8 + j;
      if (row < m2) {
        col[row * R] = static_cast<uint8_t>(x >> (8 * (7 - j))) & keep;
      }
    }
  }
}

}  // namespace

extern "C" int reverie_aes_tape_gf2(const void* round_keys, const void* omit,
                                    void* out, long long m2, int R,
                                    long long start_block, void* stream) {
  const long long n_blocks = (m2 + 127) / 128;
  const long long n_threads = n_blocks * R;
  const long long grid = (n_threads + kThreads - 1) / kThreads;
  aes_tape_gf2_kernel<<<static_cast<unsigned int>(grid), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(round_keys), static_cast<const uint8_t*>(omit),
      static_cast<uint8_t*>(out), m2, R, n_blocks,
      static_cast<unsigned long long>(start_block));
  return static_cast<int>(cudaGetLastError());
}
