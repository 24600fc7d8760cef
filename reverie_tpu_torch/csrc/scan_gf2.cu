// GF(2) wave executor: every wave of a deep circuit in one launch.
//
// Replaces reverie_tpu/backend/tpu_scan.py:247 _scan_trace_fast2, the body of
// the lax.scan that ScanExecutor runs over the waves of build_waves (XLA code,
// not a Pallas kernel); its plain version is backend/scan.py:wave_gf2_ref.
//
// Contract (mode 0 PROVER, 1 VERIFY_ONL, 2 VERIFY_PRE):
//   table  (n_waves, W, 12) int32 slots (op, dst, a, b, t0, t1, xin, rec,
//          corr, onl, pre, cbit), backend/scan.py:wave_table; op 127 = NOP
//   tape   (m2, R) u8 mask tape; xin (rows, R) u8: wit2 (PROVER), in2
//          (VERIFY_ONL); co2, re2 (rows, R) u8 (VERIFY_ONL)
//   arena  (n_vals, R) u16 scratch: row v = mask | corr << 8 of value v
//   onl, pre (rows, R) u8, zero on entry: each event's byte at its row
//   fail   (R,) u8: 1 where an ASSERT_ZERO failed (PROVER, VERIFY_ONL)
// Row offsets are 64-bit (a batch arena passes 2^31 bytes).
//
// What bounds it on the H100: the waves are a dependency chain. build_waves
// puts every operand in an earlier wave, so a wave's slots are independent
// of each other but not of the wave before. At one proof (R = 256) a few
// blocks run and the chain (n_waves x one barrier and a dependent load)
// sets the time; at a chunk of proofs (R = 16,384) the bytes do: each gate
// reads two arena rows and its tape bytes and writes its value and events,
// per rep.
//
// What the design does about it: reps never interact, so one block owns 32
// reps (threadIdx.x, consecutive, so each row access of a warp is one
// coalesced run of bytes) for the whole circuit, and its threadIdx.y run
// over the slots of a wave. A __syncthreads() between waves is the only
// synchronisation: the block's global writes are visible to the block after
// it, so there is no grid-wide sync and no launch per wave. NOP slots are
// skipped (no trash rows), MUL/ASSERT/INPUT events go straight to their onl
// row and MUL deltas to their pre row, and fail stays in a register until the
// end. The arena is read with plain loads (the non-coherent read-only path
// could serve a stale line); the table and the inputs with __ldg.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNop = 127;
constexpr int kRepsPerBlock = 32;
constexpr int kMaxSlotThreads = 32;  // threadIdx.y extent: up to 1,024 threads
constexpr int kSlotInts = 12;

constexpr int kProver = 0, kVerifyOnl = 1, kVerifyPre = 2;
// compiled gate kinds (circuit/compile.py)
constexpr int G_INPUT = 0, G_ADD = 1, G_ADDC = 2, G_SUBC = 3, G_MULC = 4, G_MUL = 5,
              G_ASSERT = 6, G_RANDOM = 7, G_CONST = 8;

__device__ __forceinline__ uint32_t parity8(uint32_t x) { return __popc(x & 0xFFu) & 1u; }

// 0/1 (any byte) -> its negation mod 256: 0x00 / 0xFF for a bit
__device__ __forceinline__ uint32_t expand8(uint32_t c) { return (0u - c) & 0xFFu; }

template <int kMode>
__global__ void __launch_bounds__(kRepsPerBlock * kMaxSlotThreads)
scan_gf2_kernel(const int4* __restrict__ table, int n_waves, int W, long long R,
                const uint8_t* __restrict__ tape, const uint8_t* __restrict__ xin,
                const uint8_t* __restrict__ co2, const uint8_t* __restrict__ re2,
                uint16_t* arena, uint8_t* __restrict__ onl, uint8_t* __restrict__ pre,
                uint8_t* __restrict__ fail) {
  __shared__ uint8_t s_fail[kRepsPerBlock];
  const long long r = static_cast<long long>(blockIdx.x) * kRepsPerBlock + threadIdx.x;
  const bool live = r < R;
  if (threadIdx.y == 0) {
    s_fail[threadIdx.x] = 0;
    if (live) arena[r] = 0;  // value 0 is the constant zero
  }
  __syncthreads();

  uint32_t failed = 0;
  for (int w = 0; w < n_waves; ++w) {
    const int4* wave = table + static_cast<long long>(w) * W * (kSlotInts / 4);
    for (int j = threadIdx.y; live && j < W; j += blockDim.y) {
      const int4 s0 = __ldg(wave + 3 * j);  // op, dst, a, b
      const int op = s0.x;
      if (op == kNop) continue;
      const int4 s1 = __ldg(wave + 3 * j + 1);  // t0, t1, xin, rec
      const int4 s2 = __ldg(wave + 3 * j + 2);  // corr, onl, pre, cbit
      const long long dst = static_cast<long long>(s0.y) * R + r;
      const uint32_t cbit = static_cast<uint32_t>(s2.w);
      switch (op) {
        case G_ADD:
          arena[dst] = arena[s0.z * R + r] ^ arena[s0.w * R + r];
          break;
        case G_ADDC:
        case G_SUBC:
          arena[dst] = arena[s0.z * R + r] ^ static_cast<uint16_t>(cbit << 8);
          break;
        case G_MULC:  // mask & 0x00/0xFF, corr & cbit: only corr's low bit stays
          arena[dst] = cbit ? static_cast<uint16_t>(arena[s0.z * R + r] & 0x01FFu)
                            : static_cast<uint16_t>(0);
          break;
        case G_RANDOM:
          arena[dst] = __ldg(tape + s1.x * R + r);
          break;
        case G_CONST:
          arena[dst] = static_cast<uint16_t>(cbit << 8);
          break;
        case G_INPUT: {
          const uint32_t t0 = __ldg(tape + s1.x * R + r);
          uint32_t in_c = 0;
          if (kMode == kProver) in_c = (__ldg(xin + s1.z * R + r) ^ parity8(t0)) & 0xFFu;
          if (kMode == kVerifyOnl) in_c = __ldg(xin + s1.z * R + r);
          arena[dst] = static_cast<uint16_t>(t0 | (in_c << 8));
          if (kMode != kVerifyPre) onl[s2.y * R + r] = static_cast<uint8_t>(expand8(in_c));
          break;
        }
        case G_MUL: {
          const uint32_t xa = arena[s0.z * R + r], xb = arena[s0.w * R + r];
          const uint32_t am = xa & 0xFFu, ac = xa >> 8, bm = xb & 0xFFu, bc = xb >> 8;
          const uint32_t t0 = __ldg(tape + s1.x * R + r), t1 = __ldg(tape + s1.y * R + r);
          uint32_t delta, s = ((bm & expand8(ac)) ^ (am & expand8(bc)) ^ t0 ^ t1) & 0xFFu;
          if (kMode == kVerifyOnl) {
            delta = __ldg(co2 + s2.x * R + r);
            s ^= __ldg(re2 + s1.w * R + r);
          } else {
            delta = (parity8(am) & parity8(bm)) ^ parity8(t0);
          }
          const uint32_t recon = kMode != kVerifyPre ? parity8(s) ^ delta : 0u;
          const uint32_t corr = (recon ^ (ac & bc)) & 0xFFu;
          arena[dst] = static_cast<uint16_t>(t1 | (corr << 8));
          if (kMode != kVerifyPre) onl[s2.y * R + r] = static_cast<uint8_t>(s);
          pre[s2.z * R + r] = static_cast<uint8_t>(expand8(delta));
          break;
        }
        case G_ASSERT: {
          if (kMode == kVerifyPre) break;
          const uint32_t xa = arena[s0.z * R + r];
          uint32_t sa = xa & 0xFFu;
          if (kMode == kVerifyOnl) sa ^= __ldg(re2 + s1.w * R + r);
          failed |= (parity8(sa) ^ (xa >> 8)) != 0u;
          onl[s2.y * R + r] = static_cast<uint8_t>(sa);
          break;
        }
        default:
          break;
      }
    }
    __syncthreads();
  }
  if (failed) s_fail[threadIdx.x] = 1;
  __syncthreads();
  if (threadIdx.y == 0 && live) fail[r] = s_fail[threadIdx.x];
}

}  // namespace

extern "C" int reverie_scan_gf2(const void* table, int n_waves, int W, int mode, long long R,
                                const void* tape, const void* xin, const void* co2,
                                const void* re2, void* arena, void* onl, void* pre, void* fail,
                                void* stream) {
  if (R <= 0 || W <= 0 || n_waves < 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kRepsPerBlock, W < kMaxSlotThreads ? W : kMaxSlotThreads);
  const long long grid = (R + kRepsPerBlock - 1) / kRepsPerBlock;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* tbl = static_cast<const int4*>(table);
  const auto* tp = static_cast<const uint8_t*>(tape);
  const auto* xi = static_cast<const uint8_t*>(xin);
  const auto* co = static_cast<const uint8_t*>(co2);
  const auto* re = static_cast<const uint8_t*>(re2);
  auto* ar = static_cast<uint16_t*>(arena);
  auto* on = static_cast<uint8_t*>(onl);
  auto* pr = static_cast<uint8_t*>(pre);
  auto* fl = static_cast<uint8_t*>(fail);
  const unsigned int g = static_cast<unsigned int>(grid);
  switch (mode) {
    case kProver:
      scan_gf2_kernel<kProver><<<g, block, 0, s>>>(tbl, n_waves, W, R, tp, xi, co, re, ar, on, pr, fl);
      break;
    case kVerifyOnl:
      scan_gf2_kernel<kVerifyOnl><<<g, block, 0, s>>>(tbl, n_waves, W, R, tp, xi, co, re, ar, on, pr, fl);
      break;
    case kVerifyPre:
      scan_gf2_kernel<kVerifyPre><<<g, block, 0, s>>>(tbl, n_waves, W, R, tp, xi, co, re, ar, on, pr, fl);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
