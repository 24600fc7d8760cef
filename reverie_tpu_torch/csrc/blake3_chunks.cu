// BLAKE3 chaining values of whole 1024-byte chunks, read straight from a
// transcript buffer whose columns are the per-repetition byte streams.
//
// Replaces reverie_tpu/crypto/kernels/blake3_pallas.py:_fb_kernel (entry
// chunk_cvs_from_bytes).
//
// Contract: buf is (T, R) u8 with row stride R; for chunk c < n_chunks and
// column r, out[i, c, r] (i < 8) is the chaining value of bytes
// buf[c*1024 : (c+1)*1024, r] as a non-root BLAKE3 chunk with counter
// chunk_base + c (CHUNK_START on block 0, CHUNK_END on block 15).  A message
// word is 4 consecutive rows of one column, little-endian.
//
// What bounds it on the H100: at the main path's shape (n = 976 chunks,
// R = 256) the kernel reads 256 MB, 0.08 ms at 3.35 TB/s, and needs at
// least 2.8G 32-bit integer instructions (4.0M compressions x 712,
// roofline.py), 0.17 ms at the H100's 1,980 MHz: the ALU bound is the
// larger.  What it meets
// first is latency: each thread runs 16 dependent compressions behind its
// own strided loads, and the 250K threads are only ~1.5 waves of the card
// at 48 registers a thread.
//
// What the design does about it: one thread per (chunk, repetition),
// neighbouring threads on neighbouring repetitions, so each one-byte load
// of a warp touches 32 neighbouring bytes of one row and coalesces into one
// sector; the 16-word state and the 16 message words stay in registers for
// the whole chunk.  Staging rows through shared memory with 16-byte loads
// and a transpose, and more threads in flight, are later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "blake3_core.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
blake3_chunk_cvs_kernel(const uint8_t* __restrict__ buf,  // (T, R)
                        int R, long long n_chunks,
                        unsigned long long chunk_base,
                        uint32_t* __restrict__ out) {     // (8, n_chunks, R)
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n_chunks * R) return;
  const long long c = idx / R;
  const int r = static_cast<int>(idx - c * R);
  const uint8_t* col = buf + static_cast<size_t>(c) * 1024 * R + r;
  const size_t stride = static_cast<size_t>(R);

  uint32_t cv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) cv[i] = kIV[i];
  const uint64_t counter = chunk_base + static_cast<uint64_t>(c);
  for (int blk = 0; blk < 16; ++blk) {
    uint32_t m[16];
    const uint8_t* p = col + static_cast<size_t>(blk) * 64 * stride;
#pragma unroll
    for (int w = 0; w < 16; ++w) {
      const uint8_t* q = p + static_cast<size_t>(4 * w) * stride;
      m[w] = static_cast<uint32_t>(q[0]) |
             (static_cast<uint32_t>(q[stride]) << 8) |
             (static_cast<uint32_t>(q[2 * stride]) << 16) |
             (static_cast<uint32_t>(q[3 * stride]) << 24);
    }
    const uint32_t flags = (blk == 0 ? kChunkStart : 0u) | (blk == 15 ? kChunkEnd : 0u);
    compress(cv, m, counter, 64u, flags);
  }
  const size_t plane = static_cast<size_t>(n_chunks) * R;
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i * plane + static_cast<size_t>(c) * R + r] = cv[i];
}

}  // namespace

extern "C" int reverie_blake3_chunk_cvs(const void* buf, int R,
                                        long long n_chunks,
                                        long long chunk_base, void* out,
                                        void* stream) {
  const long long n_threads = n_chunks * R;
  const long long grid = (n_threads + kThreads - 1) / kThreads;
  blake3_chunk_cvs_kernel<<<static_cast<unsigned int>(grid), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), R, n_chunks,
      static_cast<unsigned long long>(chunk_base), static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
