// Pack-shift: one selected bit of every byte, packed 8 rows to a byte.
//
// Replaces the pack+shift kernels of tools/r4_extract_probe.py:
// _pack_kernel (entry pack_shift_pallas), _pack_kernel_u8 and
// _pack_kernel_mxu (entry pack_shift_pallas2).  The three compute one
// function; the MXU body is a TPU workaround (a banded bf16 matmul for the
// sum over 8 rows), so one kernel stands for all three.
//
// Contract: x is (n, R) u8, sh (R,) u8, out (n/8 + 1, R) u8 with
//   out[c, r] = sum_j ((x[8c + j, r] >> sh[r]) & 1) << (7 - j),
// rows >= n read as 0, and the last row always emitted (the reference's
// remainder byte, also when n % 8 == 0).  R % 4 == 0; x and sh 4-byte
// aligned.
//
// What bounds it on the H100: memory.  At the GF(2) extractor's shape
// (n = 1,000,002, R = 256) it reads 256 MB and writes 32 MB: 0.086 ms at
// 3.35 TB/s; the arithmetic is 6 integer instructions per output byte.
//
// What the design does about it: one thread per (output row, 4 columns)
// reads 8 rows x 4 columns as one u32 each (a warp reads 128 neighbouring
// bytes of a row) and writes one u32.  The bit test needs no per-byte
// shifts: the mask M holds 1 << sh[r] in each column's byte, so x & M keeps
// the selected bits and __vcmpne4 widens each to 0xff, of which bit 7 - j
// is kept.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pack_shift_kernel(const uint8_t* __restrict__ x,   // (n, R)
                  const uint8_t* __restrict__ sh,  // (R,)
                  uint8_t* __restrict__ out,       // (n/8 + 1, R)
                  long long n, int R) {
  const int q_per_row = R / 4;
  const long long nc = n / 8 + 1;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= nc * q_per_row) return;
  const long long c = idx / q_per_row;
  const int q = static_cast<int>(idx - c * q_per_row);

  const uint32_t s = reinterpret_cast<const uint32_t*>(sh)[q];
  uint32_t mask = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t si = (s >> (8 * i)) & 0xff;
    mask |= (si < 8 ? (1u << si) : 0u) << (8 * i);
  }
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const long long row = c * 8 + j;
    if (row < n) {
      const uint32_t v = reinterpret_cast<const uint32_t*>(x + row * R)[q];
      acc |= __vcmpne4(v & mask, 0u) & (0x01010101u << (7 - j));
    }
  }
  reinterpret_cast<uint32_t*>(out + c * R)[q] = acc;
}

}  // namespace

extern "C" int reverie_pack_shift(const void* x, const void* sh, void* out,
                                  long long n, int R, void* stream) {
  const long long n_threads = (n / 8 + 1) * (R / 4);
  const long long grid = (n_threads + kThreads - 1) / kThreads;
  pack_shift_kernel<<<static_cast<unsigned int>(grid), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(sh),
      static_cast<uint8_t*>(out), n, R);
  return static_cast<int>(cudaGetLastError());
}
