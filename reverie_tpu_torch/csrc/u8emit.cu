// u32 words -> u8 bytes, in the exact (little-endian) order or in the
// sigma (byte-plane) order.
//
// Replaces the byte-emission probe kernels of tools/r5_u8emit.py:
// kern_bitcast, kern_shift and kern_repeat (exact order; entries run_check
// and run_check2) and kern_concat (sigma order, run_check2(perm=True)).
// One kernel with a `perm` flag stands for all four.
//
// Contract: w is (T, 128) u32, out (T, 2, 256) u8.  Exact order: out
// viewed as (T, 512) has byte b of word k at lane 4k + b.  Sigma order:
// out[t, g, b*64 + k] is byte b of word g*64 + k.
//
// What bounds it on the H100: memory.  At the 1M-tape shape
// (T = 1,000,001) it reads 512 MB and writes 512 MB: 0.306 ms at
// 3.35 TB/s; the byte moves are a few register permutes per 16 bytes.
//
// What the design does about it: one thread per 4 neighbouring words of a
// row (one 16-byte load), a warp per row.  The exact order stores the same
// 16 bytes back (a warp writes 512 neighbouring bytes).  The sigma order
// gathers byte b of the 4 words into one u32 with __byte_perm and stores 4
// words, one per byte plane, so each byte plane of a row is 64 neighbouring
// bytes written by 16 threads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunksPerRow = 32;  // 128 words / 4

__global__ void __launch_bounds__(kThreads)
u32_to_u8_rows_kernel(const uint4* __restrict__ w,  // (T, 128) u32 as (T, 32) uint4
                      uint8_t* __restrict__ out,    // (T, 2, 256)
                      long long T, int perm) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= T * kChunksPerRow) return;
  const uint4 v = w[idx];
  if (!perm) {
    reinterpret_cast<uint4*>(out)[idx] = v;
    return;
  }
  const long long t = idx / kChunksPerRow;
  const int c = static_cast<int>(idx - t * kChunksPerRow);
  const int g = c >> 4;         // word group of 64
  const int k4 = (c & 15) * 4;  // first word of the 4 within the group
  uint8_t* row = out + t * 512 + g * 256 + k4;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const unsigned sel = b | ((b + 4) << 4);  // byte b of x, byte b of y
    const uint32_t lo = __byte_perm(v.x, v.y, sel);
    const uint32_t hi = __byte_perm(v.z, v.w, sel);
    *reinterpret_cast<uint32_t*>(row + b * 64) = __byte_perm(lo, hi, 0x5410);
  }
}

}  // namespace

extern "C" int reverie_u32_to_u8_rows(const void* w, void* out, long long T, int perm,
                                      void* stream) {
  const long long n_threads = T * kChunksPerRow;
  const long long grid = (n_threads + kThreads - 1) / kThreads;
  u32_to_u8_rows_kernel<<<static_cast<unsigned int>(grid), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(w), static_cast<uint8_t*>(out), T, perm);
  return static_cast<int>(cudaGetLastError());
}
