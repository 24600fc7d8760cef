// BLAKE3's compression function on 32-bit words in registers, shared by the
// chunk kernel (blake3_chunks.cu) and the tail kernels (blake3_tail.cu).
#pragma once

#include <cstdint>

namespace {

constexpr uint32_t kChunkStart = 1;
constexpr uint32_t kChunkEnd = 2;
constexpr uint32_t kParent = 4;
constexpr uint32_t kRoot = 8;

__constant__ uint32_t kIV[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u,
                                0xA54FF53Au, 0x510E527Fu, 0x9B05688Cu,
                                0x1F83D9ABu, 0x5BE0CD19u};

__device__ __forceinline__ uint32_t rotr32(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

// The adds of a compression.  AluAdds leaves them to the compiler, which
// issues most as IADD3 on the ALU pipe beside the XORs and rotations;
// ImadAdds issues each as an IMAD, a * one + b with `one` a 1 the compiler
// cannot see (a kernel argument), on the FMA pipe: the ALU pipe (64 lanes an
// SM, half the issue rate) then holds only the 456 XORs and rotations of a
// compression.
struct AluAdds {
  __device__ __forceinline__ uint32_t operator()(uint32_t a, uint32_t b) const { return a + b; }
};
struct ImadAdds {
  uint32_t one;
  __device__ __forceinline__ uint32_t operator()(uint32_t a, uint32_t b) const {
    return a * one + b;
  }
};

template <class Add>
__device__ __forceinline__ void g(uint32_t& a, uint32_t& b, uint32_t& c,
                                  uint32_t& d, uint32_t mx, uint32_t my, const Add& add) {
  a = add(add(a, b), mx);
  d = rotr32(d ^ a, 16);
  c = add(c, d);
  b = rotr32(b ^ c, 12);
  a = add(add(a, b), my);
  d = rotr32(d ^ a, 8);
  c = add(c, d);
  b = rotr32(b ^ c, 7);
}

// One BLAKE3 compression; cv is updated in place with the first 8 output
// words, and m is left permuted.  The message schedule is applied as a
// register permutation after each round (fully unrolled, so it costs no
// instructions).
template <class Add = AluAdds>
__device__ __forceinline__ void compress(uint32_t cv[8], uint32_t m[16],
                                         uint64_t counter, uint32_t block_len,
                                         uint32_t flags, const Add& add = Add()) {
  uint32_t v[16] = {cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6], cv[7],
                    kIV[0], kIV[1], kIV[2], kIV[3],
                    static_cast<uint32_t>(counter),
                    static_cast<uint32_t>(counter >> 32), block_len, flags};
#pragma unroll
  for (int rnd = 0; rnd < 7; ++rnd) {
    g(v[0], v[4], v[8], v[12], m[0], m[1], add);
    g(v[1], v[5], v[9], v[13], m[2], m[3], add);
    g(v[2], v[6], v[10], v[14], m[4], m[5], add);
    g(v[3], v[7], v[11], v[15], m[6], m[7], add);
    g(v[0], v[5], v[10], v[15], m[8], m[9], add);
    g(v[1], v[6], v[11], v[12], m[10], m[11], add);
    g(v[2], v[7], v[8], v[13], m[12], m[13], add);
    g(v[3], v[4], v[9], v[14], m[14], m[15], add);
    if (rnd < 6) {
      // MSG_PERMUTATION = [2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8]
      const uint32_t t[16] = {m[2], m[6], m[3],  m[10], m[7],  m[0],  m[4],  m[13],
                              m[1], m[11], m[12], m[5], m[9], m[14], m[15], m[8]};
#pragma unroll
      for (int i = 0; i < 16; ++i) m[i] = t[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) cv[i] = v[i] ^ v[i + 8];
}

}  // namespace
