// Device-memory copy: the card's copy roof.
//
// Replaces tools/r4_bwroof.py:_copy_kernel (entry pallas_copy), the TPU's
// bandwidth-roof probe kernel.
//
// Contract: dst[i] = src[i] for the n bytes of a contiguous tensor of any
// dtype; src and dst 16-byte aligned.
//
// What bounds it on the H100: memory.  At the probe's shapes (512 MB in
// u8 and in u32) it reads 512 MB and writes 512 MB: 0.306 ms at 3.35 TB/s.
// It does no arithmetic.
//
// What the design does about it: one 16-byte vector load and store per
// thread (a warp moves 512 neighbouring bytes), over a flat grid of
// 1024-thread blocks that covers the whole array, so the card keeps as
// many loads in flight as it can hold; the n % 16 tail bytes go one per
// thread of the first block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
copy_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst, long long n16,
            const uint8_t* __restrict__ src_tail, uint8_t* __restrict__ dst_tail,
            int n_tail) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n16) dst[i] = src[i];
  if (i < n_tail) dst_tail[i] = src_tail[i];
}

}  // namespace

extern "C" int reverie_copy(const void* src, void* dst, long long n_bytes, void* stream) {
  const long long n16 = n_bytes / 16;
  const int n_tail = static_cast<int>(n_bytes - n16 * 16);
  const long long grid = (n16 + kThreads - 1) / kThreads;
  copy_kernel<<<static_cast<unsigned int>(grid > 0 ? grid : 1), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), n16,
      static_cast<const uint8_t*>(src) + n16 * 16, static_cast<uint8_t*>(dst) + n16 * 16,
      n_tail);
  return static_cast<int>(cudaGetLastError());
}
