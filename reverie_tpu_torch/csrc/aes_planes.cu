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
// What bounds it on the H100: the AES rounds.  At the probe's shape
// (B = 15,626, K = 2,048: 32M AES blocks) it stores 512 MB, 0.15 ms at
// 3.35 TB/s, but runs at least 32M x 242 integer instructions
// (roofline.py) and 32M x 160 shared-memory table lookups, the work of the
// GF(2) tape kernel
// (aes_tape.cu) at the main path's shape.
//
// What the design does about it: one thread per (block, key) runs the
// T-table core of aes_core.cuh, the 32 lanes of a warp on the 32 keys of one
// plane word.  Bitslicing then costs one __ballot_sync per (byte, bit): the
// ballot is the plane word itself, with no bit shuffling.  Lane l keeps the
// words of planes l, l+32, l+64 and l+96 and stores them; the 8 warps of a
// thread block hold neighbouring words of one block index, so each plane
// row gets 32 neighbouring bytes per thread block.  Any B is taken.

#include <cstdint>
#include <cuda_runtime.h>

#include "aes_core.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
aes_ctr_planes_kernel(const uint8_t* __restrict__ round_keys,  // (K, 11, 16)
                      uint32_t* __restrict__ out,              // (16, 8, B, Kw)
                      long long n_blocks, int kw) {
  __shared__ uint32_t te[4][256];
  __shared__ uint32_t sbox[256];
  build_aes_tables(te, sbox);
  __syncthreads();

  // n_blocks * kw * 32 threads do work; the rest are whole warps (kThreads
  // is a multiple of 32), so every ballot below has its 32 lanes.
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (warp >= n_blocks * kw) return;
  const int lane = threadIdx.x & 31;
  const long long b = warp / kw;
  const int w = static_cast<int>(warp - b * kw);

  uint32_t ks[4];
  aes_ctr_block(round_keys + (static_cast<size_t>(w) * 32 + lane) * 176,
                static_cast<uint64_t>(b), te, sbox, ks);

  uint32_t mine[4] = {0, 0, 0, 0};  // plane words lane, lane+32, lane+64, lane+96
#pragma unroll
  for (int by = 0; by < 16; ++by) {
    const uint32_t byte = (ks[by >> 2] >> (24 - 8 * (by & 3))) & 0xff;
#pragma unroll
    for (int bit = 0; bit < 8; ++bit) {
      const uint32_t word = __ballot_sync(0xffffffffu, (byte >> bit) & 1u);
      const int plane = by * 8 + bit;
      if ((plane & 31) == lane) mine[plane >> 5] = word;
    }
  }
  const size_t plane_stride = static_cast<size_t>(n_blocks) * kw;
  const size_t col = static_cast<size_t>(b) * kw + w;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    out[static_cast<size_t>(q * 32 + lane) * plane_stride + col] = mine[q];
  }
}

}  // namespace

extern "C" int reverie_aes_ctr_planes(const void* round_keys, void* out,
                                      long long n_blocks, int kw, void* stream) {
  const long long n_threads = n_blocks * kw * 32;
  const long long grid = (n_threads + kThreads - 1) / kThreads;
  aes_ctr_planes_kernel<<<static_cast<unsigned int>(grid), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(round_keys), static_cast<uint32_t*>(out),
      n_blocks, kw);
  return static_cast<int>(cudaGetLastError());
}
