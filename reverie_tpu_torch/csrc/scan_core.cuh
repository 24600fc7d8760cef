// The wave kernels' shared code: W1 (csrc/scan_gf2.cu, pure-GF(2) circuits)
// and W2 (csrc/scan_z64.cu, circuits with z64 and B2A gates) run the one
// loop over the waves below (run_waves), W2 with its z64 half between the
// same barriers. Design and contract: csrc/scan_gf2.cu's header; the GF(2)
// slots' decode and apply are that kernel's, moved here unchanged.
//
// Segment carries (backend/scan.py): the carried-in values' rows are loaded
// into their slots before wave 0 and the carried-out slots stored to their
// rows after the last wave, from shared memory or the spill arena alike.
#pragma once

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNop = 127;
constexpr int kSlotWords = 8;   // int32 words of a packed slot
constexpr int kFailBytes = 32;  // one fail word per group of 4 reps (8 groups at most)
constexpr int kMaxThreads = 1024;

constexpr int kProver = 0, kVerifyOnl = 1, kVerifyPre = 2;
// what a decoded slot does after the barrier (backend/scan.py pack_table)
constexpr uint32_t kNone = 0, kLinear = 1, kMul = 2, kAssert = 3;

// Four reps' bytes in one word, byte i for rep 4q + i: their parities (0/1
// a byte), their negations mod 256 (0x00 / 0xFF for a bit), a byte
// broadcast, and bit 7 set in each byte that is not zero.
__device__ __forceinline__ uint32_t parity4(uint32_t x) {
  x ^= x >> 4;
  x ^= x >> 2;
  x ^= x >> 1;
  return x & 0x01010101u;
}

__device__ __forceinline__ uint32_t neg4(uint32_t c) {
  const uint32_t n = ~c;
  return ((n & 0x7F7F7F7Fu) + 0x01010101u) ^ (n & 0x80808080u);
}

__device__ __forceinline__ uint32_t bcast4(uint32_t b) { return (b & 0xFFu) * 0x01010101u; }

__device__ __forceinline__ uint32_t nonzero4(uint32_t x) {
  return (((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Launch arguments shared by the kernels' helpers (the GF(2) half).
struct Args {
  const int4* slots;     // (n_waves, Wp, 8) packed slots
  const int* fields;     // source << 30 | row, per input byte a slot reads
  const int* chunk_off;  // first field of each chunk of waves, and the count
  int n_waves, Wp, n_shared, chunk, max_fields;
  long long R;
  const uint8_t* tape;
  const uint8_t* xin;
  const uint8_t* co2;
  const uint8_t* re2;
  uint2* spill;  // (n_spill, ceil(R / 4)): masks and corrs of 4 reps
  uint8_t* onl;
  uint8_t* pre;
  uint8_t* fail;
};

// The segment carries of a launch: the slots of the carried-in values
// 1..n_cin and their (n_cin, R) mask and corr rows; the slots of the
// carried-out values and the (n_cout, R) rows they are stored to: a kernel
// parameter of their own, of the kernels that take carries only (with these
// fields in Args, W1 without carries ran 2% slower on the H100).
struct CarryArgs {
  const int* cin;
  int n_cin;
  const uint8_t* cin_mask;
  const uint8_t* cin_corr;
  const int* cout;
  int n_cout;
  uint8_t* cout_mask;
  uint8_t* cout_corr;
};


// Where a thread works: its 4 reps r .. r + 3 (r = r0 + 4q), how many of
// them are lanes (n_live), and whether R % 4 == 0 (its bytes staged and
// its events stored as words).
struct Lanes {
  int q, groups;
  long long r0, r;
  int n_live;
  bool staged;
};

// A slot decoded before its wave's barrier, for 4 reps: what it does, its
// operand and destination slots, and what does not depend on the operands,
// as words of 4 bytes. kLinear: out = (A & ma) ^ (B & mb) ^ k, masks and
// corrs apart (ADD, ADDC, SUBC, MULC, RANDOM, CONST and INPUT, whose value
// and event need no operand); kMul: km = the tape's t1, mam = t0 ^ t1 (^
// the re2 bytes), mbm = parity(t0) (PROVER, VERIFY_PRE) or the co2 bytes
// (VERIFY_ONL); kAssert: km = the re2 bytes (VERIFY_ONL).
struct Dec {
  uint32_t kind;
  int a, b, dst, onl, pre;
  uint32_t mam, mac, mbm, mbc, km, kc;
};

__device__ __forceinline__ const uint8_t* source(const Args& g, int field) {
  const int src = static_cast<uint32_t>(field) >> 30;
  return src == 0 ? g.tape : src == 1 ? g.xin : src == 2 ? g.re2 : g.co2;
}

// Copy waves w0 .. w0 + chunk - 1's packed slots, and their input fields,
// into one buffer of each pair (the fields by 4 bytes: chunk_off is any).
__device__ __forceinline__ void stage_slots(int* slots, int* fields, const Args& g, int w0,
                                            int f0, int f1, int tid, int nthreads) {
  const int n_waves = min(g.chunk, g.n_waves - w0);
  if (n_waves <= 0) return;
  const int n = n_waves * g.Wp * (kSlotWords / 4);
  const int4* src = g.slots + static_cast<long long>(w0) * g.Wp * (kSlotWords / 4);
  for (int c = tid; c < n; c += nthreads) cp_async16(reinterpret_cast<int4*>(slots) + c, src + c);
  for (int c = tid; c < f1 - f0; c += nthreads) cp_async4(fields + c, g.fields + f0 + c);
}

// Copy the bytes of a chunk's fields for the block's reps, row segments of
// 4 bytes (R % 4 == 0): field e's byte for rep x lands at e * reps + x.
__device__ __forceinline__ void stage_bytes(uint8_t* bytes, const int* fields, const Args& g,
                                            int n_fields, int reps, long long r0, int tid,
                                            int nthreads) {
  const int per = reps / 4;
  for (int c = tid; c < n_fields * per; c += nthreads) {
    const int e = c / per, q = 4 * (c % per);
    if (r0 + q >= g.R) continue;
    const int field = fields[e];
    cp_async4(bytes + e * reps + q, source(g, field) + (field & 0x3FFFFFFF) * g.R + r0 + q);
  }
}

// Input bytes i of a slot whose fields start at chunk field e, for the
// thread's 4 reps (from the staged bytes, or from their row where R % 4
// != 0, 0 past the lanes).
__device__ __forceinline__ uint32_t in_word(const uint8_t* bytes, const int* fields,
                                            const Args& g, int e, int i, int reps,
                                            const Lanes& l) {
  if (l.staged) return *reinterpret_cast<const uint32_t*>(bytes + (e + i) * reps + 4 * l.q);
  const int field = fields[e + i];
  const uint8_t* row = source(g, field) + (field & 0x3FFFFFFF) * g.R + l.r;
  uint32_t w = 0;
  for (int j = 0; j < l.n_live; ++j) w |= static_cast<uint32_t>(__ldg(row + j)) << (8 * j);
  return w;
}

// An event row's 4 bytes for the thread's reps.
__device__ __forceinline__ void store4(uint8_t* rows, int row, const Args& g, const Lanes& l,
                                       uint32_t w) {
  uint8_t* p = rows + row * g.R + l.r;
  if (l.staged) {
    *reinterpret_cast<uint32_t*>(p) = w;
  } else {
    for (int j = 0; j < l.n_live; ++j) p[j] = static_cast<uint8_t>(w >> (8 * j));
  }
}

// Decode a packed slot (lo = head, a, b, onl; hi = pre, its first field,
// ma | mb << 16, kind | sub << 2 | k << 8, as backend/scan.py pack_table
// words them) for the thread's reps. sub 1: k ^= its first bytes (RANDOM,
// VERIFY_ONL's ASSERT_ZERO); sub 2: INPUT, whose event is stored here (it
// needs no operand).
template <int kMode>
__device__ __forceinline__ void decode(Dec& d, int4 lo, int4 hi, const uint8_t* bytes,
                                       const int* fields, int f0, const Args& g, int reps,
                                       const Lanes& l) {
  const uint32_t w7 = static_cast<uint32_t>(hi.w), sub = (w7 >> 2) & 3u;
  const uint32_t masks = static_cast<uint32_t>(hi.z);
  d.kind = w7 & 3u;
  d.a = lo.y;
  d.b = lo.z;
  d.dst = static_cast<int>(static_cast<uint32_t>(lo.x) >> 8);
  d.onl = lo.w;
  d.pre = hi.x;
  d.mam = bcast4(masks);
  d.mac = bcast4(masks >> 8);
  d.mbm = bcast4(masks >> 16);
  d.mbc = bcast4(masks >> 24);
  d.km = bcast4(w7 >> 8);
  d.kc = bcast4(w7 >> 16);
  if (d.kind != kMul && sub == 0) return;
  const int e = hi.y - f0;
  auto word = [&](int i) { return in_word(bytes, fields, g, e, i, reps, l); };
  const uint32_t b0 = word(0);
  if (d.kind == kMul) {
    const uint32_t b1 = word(1);
    d.km = b1;
    d.mam = b0 ^ b1;
    if (kMode == kVerifyOnl) {
      d.mam ^= word(2);
      d.mbm = word(3);
    } else {
      d.mbm = parity4(b0);
    }
  } else if (sub == 1) {
    d.km ^= b0;
  } else {
    uint32_t in_c = 0;
    if (kMode == kProver) in_c = word(1) ^ parity4(b0);
    if (kMode == kVerifyOnl) in_c = word(1);
    d.km = b0;
    d.kc = in_c;
    if (kMode != kVerifyPre) store4(g.onl, d.onl, g, l, neg4(in_c));
  }
}

// A decoded slot for the thread's reps, after the barrier: its operands,
// its value and its events.
template <int kMode>
__device__ __forceinline__ void apply(const Dec& d, uint2* vals, const Args& g, const Lanes& l,
                                      uint32_t& failed) {
  if (d.kind == kNone) return;
  const long long row = (g.R + 3) / 4;
  auto rd = [&](int v) -> uint2 {
    return v < g.n_shared ? vals[v * l.groups + l.q] : g.spill[(v - g.n_shared) * row + l.r / 4];
  };
  const uint2 xa = rd(d.a), xb = rd(d.b);
  uint2 out;
  if (d.kind == kMul) {
    const uint32_t sh = (xb.x & neg4(xa.y)) ^ (xa.x & neg4(xb.y)) ^ d.mam;
    const uint32_t delta = kMode == kVerifyOnl ? d.mbm : (parity4(xa.x) & parity4(xb.x)) ^ d.mbm;
    const uint32_t recon = kMode != kVerifyPre ? parity4(sh) ^ delta : 0u;
    out = make_uint2(d.km, recon ^ (xa.y & xb.y));
    if (kMode != kVerifyPre) store4(g.onl, d.onl, g, l, sh);
    store4(g.pre, d.pre, g, l, neg4(delta));
  } else if (d.kind == kAssert) {
    const uint32_t sa = xa.x ^ d.km;
    failed |= nonzero4(parity4(sa) ^ xa.y);
    store4(g.onl, d.onl, g, l, sa);
    return;
  } else {
    out = make_uint2((xa.x & d.mam) ^ (xb.x & d.mbm) ^ d.km,
                     (xa.y & d.mac) ^ (xb.y & d.mbc) ^ d.kc);
  }
  if (d.dst < g.n_shared) {
    vals[d.dst * l.groups + l.q] = out;
  } else {
    g.spill[(d.dst - g.n_shared) * row + l.r / 4] = out;
  }
}

// What a block's threads share besides Args: the GF(2) slots in shared
// memory, the fail words, the thread's index among nthreads, and the
// block's reps r0 .. r0 + reps - 1 in groups of 4.
struct Ctx {
  uint2* vals;
  uint32_t* s_fail;
  int tid, nthreads, reps, groups;
  long long r0;
};

// The word of a GF(2) slot for group q of the block (4 reps' masks and
// corrs), in shared memory or spilled.
__device__ __forceinline__ uint2& gf2_slot(const Args& g, const Ctx& c, int v, int q) {
  return v < g.n_shared
             ? c.vals[v * c.groups + q]
             : g.spill[static_cast<long long>(v - g.n_shared) * ((g.R + 3) / 4) + c.r0 / 4 + q];
}

// Row i of (n, R) bytes at reps r .. r + 3 as a word: whole where R % 4 == 0
// and the rows are aligned, else byte by byte, never past R.
__device__ __forceinline__ uint32_t load_row4(const uint8_t* rows, long long i, const Args& g,
                                              long long r) {
  const uint8_t* p = rows + i * g.R + r;
  if (g.R % 4 == 0 && (reinterpret_cast<uintptr_t>(rows) & 3) == 0) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  uint32_t w = 0;
  for (int j = 0; j < min(4LL, g.R - r); ++j) w |= static_cast<uint32_t>(p[j]) << (8 * j);
  return w;
}

__device__ __forceinline__ void store_row4(uint8_t* rows, long long i, const Args& g, long long r,
                                           uint32_t w) {
  uint8_t* p = rows + i * g.R + r;
  if (g.R % 4 == 0 && (reinterpret_cast<uintptr_t>(rows) & 3) == 0) {
    *reinterpret_cast<uint32_t*>(p) = w;
    return;
  }
  for (int j = 0; j < min(4LL, g.R - r); ++j) p[j] = static_cast<uint8_t>(w >> (8 * j));
}

// The carried-in GF(2) rows into their slots, before wave 0.
__device__ __forceinline__ void load_carry(const Args& g, const CarryArgs& k, const Ctx& c) {
  for (int it = c.tid; it < k.n_cin * c.groups; it += c.nthreads) {
    const int i = it / c.groups, q = it % c.groups;
    const long long r = c.r0 + 4 * q;
    if (r >= g.R) continue;
    gf2_slot(g, c, __ldg(k.cin + i), q) =
        make_uint2(load_row4(k.cin_mask, i, g, r), load_row4(k.cin_corr, i, g, r));
  }
}

// The carried-out GF(2) slots to their rows, after the last wave.
__device__ __forceinline__ void store_carry(const Args& g, const CarryArgs& k, const Ctx& c) {
  for (int it = c.tid; it < k.n_cout * c.groups; it += c.nthreads) {
    const int i = it / c.groups, q = it % c.groups;
    const long long r = c.r0 + 4 * q;
    if (r >= g.R) continue;
    const uint2 w = gf2_slot(g, c, __ldg(k.cout + i), q);
    store_row4(k.cout_mask, i, g, r, w.x);
    store_row4(k.cout_corr, i, g, r, w.y);
  }
}

// The z64 half of a wave kernel: none (W1). Its hooks: the shared memory it
// stages in front of W1's (front_bytes), slot 0 and the first chunk's
// staging (init), a chunk's staging (stage: the next chunk's slots, this
// chunk's input words), the decode of a chunk's first wave (begin), a
// wave (wave: its z64 slots, then the next wave's decoded) and the chunk's
// end (next_chunk). Here they are empty, and W1 compiles as without them.
struct NoZ {
  __device__ static constexpr int front_bytes(int, int) { return 0; }
  __device__ __forceinline__ void init(const Ctx&) {}
  __device__ __forceinline__ void load_carry(const Ctx&) {}
  __device__ __forceinline__ void stage(const Ctx&, int, int, int) {}
  __device__ __forceinline__ void begin(const Ctx&, int) {}
  __device__ __forceinline__ void wave(const Ctx&, int, int, int) {}
  __device__ __forceinline__ void next_chunk() {}
  __device__ __forceinline__ void store_carry(const Ctx&) {}
};

// Every wave of the table for the block's reps: W1's loop, with the z64
// half `z` of each wave (W2) between the same barriers. A wave's slots of
// either domain read only values of earlier waves and write slots that no
// slot of the wave reads (backend/scan.py allocate_waves), so the halves
// need no order between them. The z64 half stages its chunks in the same
// cp.async batch and wait as the GF(2) half's, in shared memory in front
// of W1's. The carries' code is compiled only into the kernels that take
// carries (kCarry): outside the loop as it is, its mere presence made W1
// 15% slower on the H100.
template <int kMode, int kK, bool kCarry, class Z>
__device__ __forceinline__ void run_waves(const Args& g, const CarryArgs& carry, Z& z) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int y = threadIdx.y, Y = blockDim.y;
  Lanes l;
  l.q = threadIdx.x;
  l.groups = blockDim.x;
  const int reps = 4 * l.groups;
  l.r0 = static_cast<long long>(blockIdx.x) * reps;
  l.r = l.r0 + 4 * l.q;
  l.n_live = static_cast<int>(min(4LL, max(0LL, g.R - l.r)));
  l.staged = g.R % 4 == 0;  // 4-byte row segments; else byte loads and stores
  const bool live = l.n_live > 0;
  const int slot_words = g.chunk * g.Wp * kSlotWords;
  // two chunks of packed slots, after the z64 half's staged chunk (W2)
  int* slots = reinterpret_cast<int*>(smem + z.front_bytes(g.chunk, reps));
  int* fields = slots + 2 * slot_words;  // two chunks of input fields
  uint8_t* bytes = reinterpret_cast<uint8_t*>(fields + 2 * g.max_fields);
  uint32_t* s_fail = reinterpret_cast<uint32_t*>(bytes + g.max_fields * reps);
  uint2* vals = reinterpret_cast<uint2*>(s_fail + kFailBytes / 4);
  const int tid = l.q + l.groups * y, nthreads = l.groups * Y;
  const Ctx ctx{vals, s_fail, tid, nthreads, reps, l.groups, l.r0};

  // fields of chunks c, c + 1, c + 2 start at f0, f1, f2 (chunk_off, read a
  // chunk ahead of their use)
  const int n_chunks = (g.n_waves + g.chunk - 1) / g.chunk;
  int f0 = __ldg(g.chunk_off), f1 = __ldg(g.chunk_off + min(1, n_chunks));
  int f2 = __ldg(g.chunk_off + min(2, n_chunks));
  stage_slots(slots, fields, g, 0, f0, f1, tid, nthreads);
  if (y == 0) {
    s_fail[l.q] = 0;
    vals[l.q] = make_uint2(0, 0);  // slot 0 is the constant zero
  }
  z.init(ctx);
  if constexpr (kCarry) {
    if (carry.n_cin) load_carry(g, carry, ctx);
    z.load_carry(ctx);
  }
  cp_async_wait_all();
  __syncthreads();

  uint32_t failed = 0;
  Dec cur[kK], nxt[kK];
  for (int w0 = 0, c = 0; w0 < g.n_waves; w0 += g.chunk, ++c) {
    const int buf = c & 1;
    const int* cs = slots + buf * slot_words;
    const int* cf = fields + buf * g.max_fields;
    // the next chunk's slots and fields, and this chunk's bytes, in one
    // wait: no global load is in flight at a wave's barrier
    const int f3 = __ldg(g.chunk_off + min(c + 3, n_chunks));
    stage_slots(slots + (buf ^ 1) * slot_words, fields + (buf ^ 1) * g.max_fields, g,
                w0 + g.chunk, f1, f2, tid, nthreads);
    z.stage(ctx, c, buf, w0);
    if (l.staged) stage_bytes(bytes, cf, g, f1 - f0, reps, l.r0, tid, nthreads);
    cp_async_wait_all();
    __syncthreads();
    const int n = min(g.chunk, g.n_waves - w0);
    const int4* rows = reinterpret_cast<const int4*>(cs);  // two int4 a slot
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      cur[k].kind = kNone;
      const int j = y + k * Y;
      if (live && j < g.Wp) {
        decode<kMode>(cur[k], rows[2 * j], rows[2 * j + 1], bytes, cf, f0, g, reps, l);
      }
    }
    z.begin(ctx, buf);
    for (int i = 0; i < n; ++i) {
      // the next wave's slots, read before this wave's operands
      int4 lo[kK], hi[kK];
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        const int s = (i + 1) * g.Wp + y + k * Y;
        lo[k] = hi[k] = make_int4(0, 0, 0, 0);
        if (i + 1 < n && y + k * Y < g.Wp) {
          lo[k] = rows[2 * s];
          hi[k] = rows[2 * s + 1];
        }
      }
#pragma unroll
      for (int k = 0; k < kK; ++k) apply<kMode>(cur[k], vals, g, l, failed);
      z.wave(ctx, buf, i, n);
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        nxt[k].kind = kNone;
        if (live && i + 1 < n && y + k * Y < g.Wp) {
          decode<kMode>(nxt[k], lo[k], hi[k], bytes, cf, f0, g, reps, l);
        }
      }
      __syncthreads();  // wave w0 + i's values, for every thread
#pragma unroll
      for (int k = 0; k < kK; ++k) cur[k] = nxt[k];
    }
    f0 = f1;
    f1 = f2;
    f2 = f3;
    z.next_chunk();
  }
  if constexpr (kCarry) {
    if (carry.n_cout) store_carry(g, carry, ctx);
    z.store_carry(ctx);
  }
  if (failed) atomicOr(s_fail + l.q, failed);
  __syncthreads();
  if (y == 0) {
    for (int j = 0; j < l.n_live; ++j) g.fail[l.r + j] = (s_fail[l.q] >> (8 * j + 7)) & 1u;
  }
}

// Dynamic shared memory of one block's GF(2) half: two chunks of packed
// slots and of input fields, one chunk of the fields' bytes, the fail
// words and the shared GF(2) slots (backend/scan.py WaveProgram.smem_bytes,
// W2's z64 half apart: csrc/scan_z64.cu z_smem_bytes).
size_t smem_bytes(int Wp, int chunk, int max_fields, int n_shared, int reps) {
  return 2 * static_cast<size_t>(chunk) * Wp * kSlotWords * 4 +
         2 * static_cast<size_t>(max_fields) * 4 + static_cast<size_t>(max_fields) * reps +
         kFailBytes + 2 * static_cast<size_t>(n_shared) * reps;
}

// Lets `kernel` take the device's most dynamic shared memory per block
// (227 KB on the H100), once per device and kernel.
template <auto kernel>
cudaError_t allow_smem() {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> allowed[kMaxDevices];  // 0: not yet
  int dev = 0, most = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && allowed[dev].load() > 0) return cudaSuccess;
  e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  }
  if (e == cudaSuccess && dev < kMaxDevices) allowed[dev].store(most);
  return e;
}

template <class T>
T* ptr(long long w) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(w));
}

// The GF(2) half of a launch from its int64 host words (backend/scan.py
// `_args`): the packed table and its sizes, the role, the plan (reps, k,
// chunk, fields, threads_y), the inputs, the spill arena, the outputs, the
// stream and the GF(2) carries.
struct Launch {
  Args g;
  CarryArgs carry;
  int mode, reps, k, threads_y;
  cudaStream_t stream;
};

// Launches `kernel` with `params` for a Launch (its block, grid, stream and
// dynamic shared memory, the z64 half's z_bytes included), or, with
// blocks_per_sm, gives its resident blocks per SM.
template <auto kernel, class... P>
cudaError_t launch_kernel(const Launch& L, size_t z_bytes, int* blocks_per_sm, P... params) {
  cudaError_t e = allow_smem<kernel>();
  if (e != cudaSuccess) return e;
  const Args& g = L.g;
  const size_t smem = smem_bytes(g.Wp, g.chunk, g.max_fields, g.n_shared, L.reps) + z_bytes;
  if (blocks_per_sm != nullptr) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                         L.reps / 4 * L.threads_y, smem);
  }
  const unsigned int grid = static_cast<unsigned int>((g.R + L.reps - 1) / L.reps);
  kernel<<<grid, dim3(L.reps / 4, L.threads_y), smem, L.stream>>>(params...);
  return cudaGetLastError();
}

constexpr int kLaunchWords = 30;

Launch launch_args(const long long* a) {
  Launch L{};
  Args& g = L.g;
  g.slots = ptr<const int4>(a[0]);
  g.fields = ptr<const int>(a[1]);
  g.chunk_off = ptr<const int>(a[2]);
  g.n_waves = static_cast<int>(a[3]);
  g.Wp = static_cast<int>(a[4]);
  L.mode = static_cast<int>(a[5]);
  g.R = a[6];
  g.n_shared = static_cast<int>(a[7]);
  L.reps = static_cast<int>(a[8]);
  L.k = static_cast<int>(a[9]);
  g.chunk = static_cast<int>(a[10]);
  g.max_fields = static_cast<int>(a[11]);
  L.threads_y = static_cast<int>(a[12]);
  g.tape = ptr<const uint8_t>(a[13]);
  g.xin = ptr<const uint8_t>(a[14]);
  g.co2 = ptr<const uint8_t>(a[15]);
  g.re2 = ptr<const uint8_t>(a[16]);
  g.spill = ptr<uint2>(a[17]);
  g.onl = ptr<uint8_t>(a[18]);
  g.pre = ptr<uint8_t>(a[19]);
  g.fail = ptr<uint8_t>(a[20]);
  L.stream = ptr<CUstream_st>(a[21]);
  CarryArgs& k = L.carry;
  k.cin = ptr<const int>(a[22]);
  k.n_cin = static_cast<int>(a[23]);
  k.cin_mask = ptr<const uint8_t>(a[24]);
  k.cin_corr = ptr<const uint8_t>(a[25]);
  k.cout = ptr<const int>(a[26]);
  k.n_cout = static_cast<int>(a[27]);
  k.cout_mask = ptr<uint8_t>(a[28]);
  k.cout_corr = ptr<uint8_t>(a[29]);
  return L;
}

// The launch's sizes are sound: its block and grid, one of the kernels'
// k, slot 0 in shared memory.
bool launch_ok(const Launch& L) {
  const Args& g = L.g;
  const long long grid = (g.R + L.reps - 1) / L.reps;
  return (L.reps == 8 || L.reps == 16 || L.reps == 32) && g.Wp > 0 && L.threads_y > 0 &&
         static_cast<long long>(L.threads_y) * L.k >= g.Wp &&
         L.reps / 4 * L.threads_y <= kMaxThreads && (L.k == 1 || L.k == 2 || L.k == 4) &&
         g.n_shared >= 1 && g.chunk >= 1 && g.max_fields >= 1 && g.n_waves >= 0 && g.R > 0 &&
         grid <= 0x7FFFFFFFLL && L.carry.n_cin >= 0 && L.carry.n_cout >= 0;
}

}  // namespace
