// The AES-128 core shared by the AES kernels, in the T-table form
// (rijndael-alg-fst), with big-endian column words in and out (FIPS-197
// byte order).
//
// What bounds T-table AES on the H100: the shared-memory table lookups and
// the instructions that address them.  A CTR block takes 160 data-dependent
// lookups.  With one 1 KiB table per thread block, 32 random byte indices
// fall on ~3.16 shared-memory wavefronts per warp lookup instead of 1 (bank
// conflicts; a model of it is in tests/test_torch_package.py).  Without
// conflicts, each lookup still takes one wavefront, and an address computed
// as a byte extract, a scale and an add costs 2-3 issued instructions: ~1,250
// per block in all against the 242 ALU instructions of roofline.py, so the
// kernel becomes issue-bound.
//
// The core, in aes_tape.cu, aes_tape_z64.cu and aes_planes.cu.  The four
// T-tables are replicated once per bank in shared memory (128 KiB),
// so lane l reads only copy l, in bank l, and every warp lookup is one
// wavefront.  Entry x of lane l's copy sits at byte x * 256 + 4l of its
// table: one byte permute of the state word is the whole address
// (`entry_offset`), the table is the load's immediate offset, and there are
// no rotations.  That cuts a block to ~650 issued instructions, as many
// cycles as its 160 lookups take.  The last round's S-box byte is byte 2 of
// Te0 (Te0[i] = (2s, s, s, 3s)), so no S-box table is needed.  A thread
// holds its key's 44 round-key words in registers (`load_round_keys`,
// byte-swapped once) and runs many counter blocks under it, two at a time
// for ILP (`aes_ctr_blocks_x32`), in a persistent grid that builds the
// tables once per thread block (`persistent_blocks`, `run_length`).  One
// table replicated (32 KiB, Te1..Te3 by rotation) and one counter block at a
// time were both slower on the H100 (PERF.md).  `warp_transpose32` turns
// the 32 lanes' keystream words into bitsliced words for the kernels that
// pack one bit per key (aes_tape.cu, aes_planes.cu).

#pragma once

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__constant__ uint8_t kSbox[256] = {
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b, 0xfe, 0xd7, 0xab, 0x76,
    0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0, 0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0,
    0xb7, 0xfd, 0x93, 0x26, 0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2, 0xeb, 0x27, 0xb2, 0x75,
    0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0, 0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84,
    0x53, 0xd1, 0x00, 0xed, 0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f, 0x50, 0x3c, 0x9f, 0xa8,
    0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5, 0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2,
    0xcd, 0x0c, 0x13, 0xec, 0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14, 0xde, 0x5e, 0x0b, 0xdb,
    0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c, 0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79,
    0xe7, 0xc8, 0x37, 0x6d, 0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f, 0x4b, 0xbd, 0x8b, 0x8a,
    0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e, 0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e,
    0xe1, 0xf8, 0x98, 0x11, 0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f, 0xb0, 0x54, 0xbb, 0x16,
};

constexpr int kIlp = 2;        // counter blocks a thread runs interleaved
constexpr int kTeCopies = 32;  // one copy per bank
constexpr size_t kTeBytes = 4 * 256 * kTeCopies * 4;  // 128 KiB: one thread block per SM
constexpr int kTapeThreads = 512;  // threads per block of the tape kernels: 16 warps per SM

// The four replicated tables, Ten = Te0 rotated right by 8n bits, Te0[i] =
// (2s, s, s, 3s) for s = S-box[i], copy c of an entry in bank c: two 64 KiB
// halves of 256-byte entry rows, row i of half h holding Te(h)[i] in words
// 0..31 and Te(h + 2)[i] in words 32..63, so that the byte offset of lane
// l's copy of entry x, x * 256 + 4l, is one byte permute of the state word
// (`entry_offset`), and the table is the load's immediate offset.  The 32
// lanes of a warp build one entry, so each read of the __constant__ S-box
// is one broadcast address (blockDim is a multiple of 32).  The caller
// __syncthreads() before the first lookup.
__device__ __forceinline__ void build_te_x32(uint32_t* te) {
  for (int w = threadIdx.x; w < 4 * 256 * kTeCopies; w += blockDim.x) {
    const int n = (w >> 14) + 2 * ((w >> 5) & 1);
    const int i = (w >> 6) & 0xff;
    const uint32_t s = kSbox[i];
    const uint32_t s2 = ((s << 1) ^ ((s & 0x80) ? 0x1b : 0)) & 0xff;
    const uint32_t v = (s2 << 24) | (s << 16) | (s << 8) | (s2 ^ s);
    te[w] = __funnelshift_r(v, v, 8 * n);
  }
}

// 11 x 16 round-key bytes -> 44 big-endian column words, kept in registers
__device__ __forceinline__ void load_round_keys(const uint8_t* rk, uint32_t (&k)[44]) {
  const uint4* v = reinterpret_cast<const uint4*>(rk);
#pragma unroll
  for (int i = 0; i < 11; ++i) {
    const uint4 q = v[i];
    k[4 * i] = __byte_perm(q.x, 0, 0x0123);
    k[4 * i + 1] = __byte_perm(q.y, 0, 0x0123);
    k[4 * i + 2] = __byte_perm(q.z, 0, 0x0123);
    k[4 * i + 3] = __byte_perm(q.w, 0, 0x0123);
  }
}

// x * 256 + lane4 for x = byte k of s (lane4 = 4 * lane < 256)
template <int k>
__device__ __forceinline__ uint32_t entry_offset(uint32_t s, uint32_t lane4) {
  return __byte_perm(s, lane4, 0x6504 | (k << 4));
}

// Ten[byte k of s] from lane `lane`'s copy of the tables at `te`
template <int n, int k>
__device__ __forceinline__ uint32_t te_at(const uint32_t* te, uint32_t lane, uint32_t s) {
  constexpr uint32_t table = (n & 1) * 65536 + (n >> 1) * 128;
  return *reinterpret_cast<const uint32_t*>(reinterpret_cast<const char*>(te) + table +
                                            entry_offset<k>(s, 4 * lane));
}

// one column of a middle round: Te0[a >> 24] ^ Te1[b >> 16] ^ Te2[c >> 8] ^
// Te3[d] (bytes) ^ key
__device__ __forceinline__ uint32_t round_column(const uint32_t* te, uint32_t lane, uint32_t a,
                                                 uint32_t b, uint32_t c, uint32_t d, uint32_t key) {
  return te_at<0, 3>(te, lane, a) ^ te_at<1, 2>(te, lane, b) ^ te_at<2, 1>(te, lane, c) ^
         te_at<3, 0>(te, lane, d) ^ key;
}

// one column of the last round: S[a >> 24] S[b >> 16] S[c >> 8] S[d]
// (bytes 3..0) ^ key, the S-box bytes taken from bytes 2 and 1 of Te0 (both
// are s)
__device__ __forceinline__ uint32_t last_column(const uint32_t* te, uint32_t lane, uint32_t a,
                                                uint32_t b, uint32_t c, uint32_t d, uint32_t key) {
  const uint32_t hi = __byte_perm(te_at<0, 3>(te, lane, a), te_at<0, 2>(te, lane, b), 0x2600);
  const uint32_t lo = __byte_perm(te_at<0, 1>(te, lane, c), te_at<0, 0>(te, lane, d), 0x0015);
  return __byte_perm(hi, lo, 0x3254) ^ key;
}

// kIlp AES-128 blocks of counters ctr[i] (bytes 0..7 zero, 8..15 big-endian
// ctr) under the round-key words k, on the replicated tables, their rounds
// interleaved.  out[i][c] is column c of block i as a big-endian word:
// keystream byte 4c + j is (out[i][c] >> (24 - 8j)) & 0xff.  `te` is the
// tables of build_te_x32, lane the caller's lane.
__device__ __forceinline__ void aes_ctr_blocks_x32(const uint32_t (&k)[44],
                                                   const uint64_t (&ctr)[kIlp], const uint32_t* te,
                                                   uint32_t lane, uint32_t (&out)[kIlp][4]) {
  uint32_t s[kIlp][4];
#pragma unroll
  for (int i = 0; i < kIlp; ++i) {
    s[i][0] = k[0];
    s[i][1] = k[1];
    s[i][2] = static_cast<uint32_t>(ctr[i] >> 32) ^ k[2];
    s[i][3] = static_cast<uint32_t>(ctr[i]) ^ k[3];
  }
#pragma unroll
  for (int rnd = 1; rnd < 10; ++rnd) {
#pragma unroll
    for (int i = 0; i < kIlp; ++i) {
      const uint32_t t0 = round_column(te, lane, s[i][0], s[i][1], s[i][2], s[i][3], k[4 * rnd]);
      const uint32_t t1 = round_column(te, lane, s[i][1], s[i][2], s[i][3], s[i][0], k[4 * rnd + 1]);
      const uint32_t t2 = round_column(te, lane, s[i][2], s[i][3], s[i][0], s[i][1], k[4 * rnd + 2]);
      const uint32_t t3 = round_column(te, lane, s[i][3], s[i][0], s[i][1], s[i][2], k[4 * rnd + 3]);
      s[i][0] = t0;
      s[i][1] = t1;
      s[i][2] = t2;
      s[i][3] = t3;
    }
  }
#pragma unroll
  for (int i = 0; i < kIlp; ++i) {
    out[i][0] = last_column(te, lane, s[i][0], s[i][1], s[i][2], s[i][3], k[40]);
    out[i][1] = last_column(te, lane, s[i][1], s[i][2], s[i][3], s[i][0], k[41]);
    out[i][2] = last_column(te, lane, s[i][2], s[i][3], s[i][0], s[i][1], k[42]);
    out[i][3] = last_column(te, lane, s[i][3], s[i][0], s[i][1], s[i][2], k[43]);
  }
}

// 32 x 32 bit transpose across the warp: on return bit m of lane l's word
// is bit l of lane m's word on entry.  5 shuffle stages.
__device__ __forceinline__ uint32_t warp_transpose32(uint32_t x, int lane) {
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    // the low j bits of every 2j-bit group
    const uint32_t m = j == 16 ? 0x0000FFFFu : j == 8 ? 0x00FF00FFu : j == 4 ? 0x0F0F0F0Fu
                     : j == 2 ? 0x33333333u : 0x55555555u;
    const uint32_t y = __shfl_xor_sync(0xffffffffu, x, j);
    x = (lane & j) ? ((x & ~m) | ((y >> j) & m)) : ((x & m) | ((y << j) & ~m));
  }
  return x;
}

// Thread blocks of `kernel` resident on the whole card at once (SMs x
// blocks per SM), the size of a persistent grid; also lets the kernel take
// `smem` bytes of dynamic shared memory.  Worked out once per device and
// kernel: later calls read the cached count.
template <auto kernel>
cudaError_t persistent_blocks(int threads, size_t smem, int* blocks) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> cached[kMaxDevices];  // 0: not yet known
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && (*blocks = cached[dev].load()) > 0) return cudaSuccess;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  }
  *blocks = sms * std::max(per_sm, 1);
  if (e == cudaSuccess && dev < kMaxDevices) cached[dev].store(*blocks);
  return e;
}

// Counter blocks per work item when `units` key groups share `n_blocks`
// counter blocks among `slots` resident workers: about 4 items per worker,
// so that the last round of items is short.
inline long long run_length(long long n_blocks, long long units, long long slots) {
  const long long target = 4 * slots;
  const long long run = (n_blocks * units + target - 1) / target;
  return std::min(std::max(run, 1LL), std::max(n_blocks, 1LL));
}

}  // namespace
