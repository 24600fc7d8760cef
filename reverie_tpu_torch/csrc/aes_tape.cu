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
// memory per block, so a round is 16 lookups and 16 XORs.  The 8 players'
// keystream stays in 32 registers; each of the 16 byte positions becomes 8
// tape bytes through one 8x8 bit transpose of a 64-bit word.  Each tape row
// store is 32 neighbouring bytes per warp, so the stores coalesce.  Ragged
// final blocks are masked at row m2.  Bitslicing (the TPU design) and
// wider stores are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

__device__ __forceinline__ uint32_t ror32(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

// 16 round-key bytes -> 4 big-endian column words
__device__ __forceinline__ void load_round_key(const uint8_t* rk, uint32_t w[4]) {
  const uint4 v = *reinterpret_cast<const uint4*>(rk);
  w[0] = __byte_perm(v.x, 0, 0x0123);
  w[1] = __byte_perm(v.y, 0, 0x0123);
  w[2] = __byte_perm(v.z, 0, 0x0123);
  w[3] = __byte_perm(v.w, 0, 0x0123);
}

// One AES-128 block: counter block `ctr` (bytes 0..7 zero, 8..15 big-endian
// ctr) under the 11 round keys at `rk` (11 x 16 bytes).  Big-endian column
// words in and out (FIPS-197 byte order, rijndael-alg-fst T-table form).
__device__ __forceinline__ void aes_ctr_block(const uint8_t* rk, uint64_t ctr,
                                              const uint32_t (*te)[256],
                                              const uint32_t* sbox,
                                              uint32_t out[4]) {
  uint32_t k[4];
  load_round_key(rk, k);
  uint32_t s0 = k[0];
  uint32_t s1 = k[1];
  uint32_t s2 = static_cast<uint32_t>(ctr >> 32) ^ k[2];
  uint32_t s3 = static_cast<uint32_t>(ctr) ^ k[3];
#pragma unroll
  for (int rnd = 1; rnd < 10; ++rnd) {
    load_round_key(rk + 16 * rnd, k);
    const uint32_t t0 = te[0][s0 >> 24] ^ te[1][(s1 >> 16) & 0xff] ^
                        te[2][(s2 >> 8) & 0xff] ^ te[3][s3 & 0xff] ^ k[0];
    const uint32_t t1 = te[0][s1 >> 24] ^ te[1][(s2 >> 16) & 0xff] ^
                        te[2][(s3 >> 8) & 0xff] ^ te[3][s0 & 0xff] ^ k[1];
    const uint32_t t2 = te[0][s2 >> 24] ^ te[1][(s3 >> 16) & 0xff] ^
                        te[2][(s0 >> 8) & 0xff] ^ te[3][s1 & 0xff] ^ k[2];
    const uint32_t t3 = te[0][s3 >> 24] ^ te[1][(s0 >> 16) & 0xff] ^
                        te[2][(s1 >> 8) & 0xff] ^ te[3][s2 & 0xff] ^ k[3];
    s0 = t0;
    s1 = t1;
    s2 = t2;
    s3 = t3;
  }
  load_round_key(rk + 160, k);
  out[0] = (sbox[s0 >> 24] << 24) ^ (sbox[(s1 >> 16) & 0xff] << 16) ^
           (sbox[(s2 >> 8) & 0xff] << 8) ^ sbox[s3 & 0xff] ^ k[0];
  out[1] = (sbox[s1 >> 24] << 24) ^ (sbox[(s2 >> 16) & 0xff] << 16) ^
           (sbox[(s3 >> 8) & 0xff] << 8) ^ sbox[s0 & 0xff] ^ k[1];
  out[2] = (sbox[s2 >> 24] << 24) ^ (sbox[(s3 >> 16) & 0xff] << 16) ^
           (sbox[(s0 >> 8) & 0xff] << 8) ^ sbox[s1 & 0xff] ^ k[2];
  out[3] = (sbox[s3 >> 24] << 24) ^ (sbox[(s0 >> 16) & 0xff] << 16) ^
           (sbox[(s1 >> 8) & 0xff] << 8) ^ sbox[s2 & 0xff] ^ k[3];
}

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
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    const uint32_t s = kSbox[i];
    const uint32_t s2 = ((s << 1) ^ ((s & 0x80) ? 0x1b : 0)) & 0xff;
    const uint32_t t = (s2 << 24) | (s << 16) | (s << 8) | (s2 ^ s);
    te[0][i] = t;
    te[1][i] = ror32(t, 8);
    te[2][i] = ror32(t, 16);
    te[3][i] = ror32(t, 24);
    sbox[i] = s;
  }
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
