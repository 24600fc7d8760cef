// Z_2^64 and B2A wave executor (W2): every wave of a deep circuit with z64
// or B2A gates in one launch, both halves of each wave between the same
// barriers.
//
// Replaces the z64 and B2A half of reverie_tpu/backend/tpu_scan.py:374
// _scan_trace, the body of the lax.scan that ScanExecutor runs over the
// waves of build_waves (XLA code, not a Pallas kernel): `z64_slots`
// (:430-689), the `body` (:691-781) and the carry-out (:783-804). Its plain
// version is backend/scan.py:wave_ref.
//
// Contract (mode 0 PROVER, 1 VERIFY_ONL, 2 VERIFY_PRE): W1's (csrc/scan_gf2.cu)
// for the GF(2) slots, on W1's code (csrc/scan_core.cuh), and for the z64
// slots backend/scan.py's slot-allocated zwave_table:
//   zslots    (n_waves, Wz, 16) int32: op, dst, a, b (zr for B2A_OUT), the
//             slot's row of the bits table, t0, t1, xin, rec, corr, onl,
//             pre, the constant's lo and hi words, brec, bonl. dst, a, b
//             are z64 slots: below n_sharedz in shared memory, the others
//             rows of the z64 spill arena
//   zbits     (n_b2a, 64) int32: the GF(2) slots of each B2A's 64 bits
//   tapez     (mz, 8, R) int64; xinz (rows, R) int64: witz (PROVER), inz
//             (VERIFY_ONL); coz (rows, R), rez (rows, 8, R) int64
//             (VERIFY_ONL)
//   spillz    (n_spillz, 9, R) int64 scratch: 8 mask words, the corr
//   onlz, prez (rows, R) u8, zero on entry: a MUL or ASSERT_ZERO share
//             event is 64 rows from onl, player-major, 8 little-endian
//             bytes a player; an INPUT writes 8 rows; prez takes 8 rows of
//             a MUL's delta or a B2A_CORR's correction; a B2A_OUT writes
//             its 64 bit reconstructions into the GF(2) onl rows from bonl
//   carries   the z64 slots of the carried-in values and their (k, 8, R)
//             mask and (k, R) corr rows, loaded before wave 0; the slots of
//             the carried-out values and the rows they are stored to after
//             the last wave
// The arguments come as int64 words (backend/scan.py `wave_run`): W1's 30,
// then the z64 half's (`zargs`). Row offsets are 64-bit.
//
// The design, kept simple: the live z64 values of a block's reps sit in
// dynamic shared memory after the GF(2) slots, 72 bytes a value a rep
// (value-major, then word, then rep: one rep's word and its neighbours'
// are consecutive), spilled to a global arena past the plan's capacity.
// One thread takes one (rep, z64 slot) of a wave (more where the block is
// smaller than reps x Wz) and reads its slot's 16 words from global memory
// after the barrier; a MUL issues its 16 tape loads at once, then streams
// over the 8 players, keeping the three reconstruction sums and the share
// sum in registers, so that it writes its mask words and events as it
// goes. Blocks take at most 512 threads, so that a thread may hold 128
// registers (at 1,024 threads, 64, and the kernel spilled). The arithmetic is uint64_t, which
// wraps mod 2^64 as the port's int64 tensors do. A B2A slot reads the
// 64 GF(2) values of earlier waves from W1's slots (shared or spilled),
// byte x & 3 of the word of group x / 4; a failed z64 ASSERT_ZERO sets the
// fail bit of W1's word for its rep.

#include "scan_core.cuh"

namespace {

constexpr int kZWords = 16;
// a block's most threads (backend/scan.py MAX_THREADS_Z64): 128 registers a
// thread, so that a MUL holds its 16 tape words and its sums without spills
constexpr int kMaxThreadsZ64 = 512;
constexpr int kG_Input = 0, kG_Add = 1, kG_Addc = 2, kG_Subc = 3, kG_Mulc = 4, kG_Mul = 5,
              kG_Assert = 6, kG_Random = 7, kG_Const = 8, kZ_Sub = 9, kB2A_Corr = 10,
              kB2A_Out = 11;

struct ZArgs {
  const int* slots;  // (n_waves, Wz, 16)
  int Wz;
  const int* bits;  // (n_b2a, 64) GF(2) slots
  int n_shared;
  const uint64_t* tape;  // (mz, 8, R)
  const uint64_t* xin;   // (rows, R)
  const uint64_t* co;    // (rows, R)
  const uint64_t* re;    // (rows, 8, R)
  uint64_t* spill;       // (n_spill, 9, R)
  uint8_t* onl;
  uint8_t* pre;
  const int* cin;
  int n_cin;
  const uint64_t* cin_mask;  // (n_cin, 8, R)
  const uint64_t* cin_corr;  // (n_cin, R)
  const int* cout;
  int n_cout;
  uint64_t* cout_mask;
  uint64_t* cout_corr;
};

ZArgs zargs(const long long* a) {
  ZArgs z{};
  z.slots = ptr<const int>(a[0]);
  z.Wz = static_cast<int>(a[1]);
  z.bits = ptr<const int>(a[2]);
  z.n_shared = static_cast<int>(a[3]);
  z.tape = ptr<const uint64_t>(a[4]);
  z.xin = ptr<const uint64_t>(a[5]);
  z.co = ptr<const uint64_t>(a[6]);
  z.re = ptr<const uint64_t>(a[7]);
  z.spill = ptr<uint64_t>(a[8]);
  z.onl = ptr<uint8_t>(a[9]);
  z.pre = ptr<uint8_t>(a[10]);
  z.cin = ptr<const int>(a[11]);
  z.n_cin = static_cast<int>(a[12]);
  z.cin_mask = ptr<const uint64_t>(a[13]);
  z.cin_corr = ptr<const uint64_t>(a[14]);
  z.cout = ptr<const int>(a[15]);
  z.n_cout = static_cast<int>(a[16]);
  z.cout_mask = ptr<uint64_t>(a[17]);
  z.cout_corr = ptr<uint64_t>(a[18]);
  return z;
}

// The z64 half of W2 for role kMode: slot 0's zero, the carries and each
// wave's z64 slots, for the block's reps.
template <int kMode>
struct Z64 {
  const Args& g;
  const ZArgs& z;

  __device__ __forceinline__ uint64_t* vz(const Ctx& c) const {
    return reinterpret_cast<uint64_t*>(c.vals + g.n_shared * c.groups);
  }

  // Word w (0..7 the players' masks, 8 the corr) of z64 slot s for rep x.
  __device__ __forceinline__ uint64_t& at(const Ctx& c, int s, int w, int x) const {
    return s < z.n_shared
               ? vz(c)[(s * 9 + w) * c.reps + x]
               : z.spill[(static_cast<long long>(s - z.n_shared) * 9 + w) * g.R + c.r0 + x];
  }

  __device__ __forceinline__ void init(const Ctx& c) const {
    for (int i = c.tid; i < 9 * c.reps; i += c.nthreads) vz(c)[i] = 0;
  }

  __device__ __forceinline__ void load_carry(const Ctx& c) const {
    for (int it = c.tid; it < z.n_cin * c.reps; it += c.nthreads) {
      const int i = it / c.reps, x = it % c.reps;
      const long long r = c.r0 + x;
      if (r >= g.R) continue;
      const int s = __ldg(z.cin + i);
      for (int p = 0; p < 8; ++p) at(c, s, p, x) = __ldg(z.cin_mask + (i * 8LL + p) * g.R + r);
      at(c, s, 8, x) = __ldg(z.cin_corr + i * g.R + r);
    }
  }

  __device__ __forceinline__ void store_carry(const Ctx& c) const {
    for (int it = c.tid; it < z.n_cout * c.reps; it += c.nthreads) {
      const int i = it / c.reps, x = it % c.reps;
      const long long r = c.r0 + x;
      if (r >= g.R) continue;
      const int s = __ldg(z.cout + i);
      for (int p = 0; p < 8; ++p) z.cout_mask[(i * 8LL + p) * g.R + r] = at(c, s, p, x);
      z.cout_corr[i * g.R + r] = at(c, s, 8, x);
    }
  }

  // 8 little-endian bytes of v into rows row .. row + 7 at rep r.
  __device__ __forceinline__ void store8(uint8_t* rows, long long row, long long r,
                                         uint64_t v) const {
#pragma unroll
    for (int j = 0; j < 8; ++j) rows[(row + j) * g.R + r] = static_cast<uint8_t>(v >> (8 * j));
  }

  __device__ __forceinline__ void wave(const Ctx& c, int w) const {
    const long long R = g.R;
    for (int it = c.tid; it < c.reps * z.Wz; it += c.nthreads) {
      const int x = it % c.reps, j = it / c.reps;
      const long long r = c.r0 + x;
      if (r >= R) continue;
      const int4* sp = reinterpret_cast<const int4*>(
          z.slots + (static_cast<long long>(w) * z.Wz + j) * kZWords);
      const int4 w0 = __ldg(sp), w1 = __ldg(sp + 1), w2 = __ldg(sp + 2), w3 = __ldg(sp + 3);
      const int op = w0.x;
      if (op == kNop) continue;
      const int dst = w0.y, a = w0.z, b = w0.w, bits = w1.x, t0 = w1.y, t1 = w1.z, xin = w1.w;
      const int rec = w2.x, corr = w2.y, onl = w2.z, pre = w2.w;
      const uint64_t k = (static_cast<uint64_t>(static_cast<uint32_t>(w3.y)) << 32) |
                         static_cast<uint32_t>(w3.x);
      const int brec = w3.z, bonl = w3.w;
      auto tape = [&](int row, int p) { return __ldg(z.tape + (row * 8LL + p) * R + r); };
      switch (op) {
        case kG_Mul: {
          // the 16 tape words first, all in flight at once
          uint64_t m0[8], m1[8];
#pragma unroll
          for (int p = 0; p < 8; ++p) {
            m0[p] = tape(t0, p);
            m1[p] = tape(t1, p);
          }
          const uint64_t ac = at(c, a, 8, x), bc = at(c, b, 8, x);
          uint64_t ra = 0, rb = 0, rc = 0, ss = 0;
#pragma unroll
          for (int p = 0; p < 8; ++p) {
            const uint64_t am = at(c, a, p, x), bm = at(c, b, p, x);
            ra += am;
            rb += bm;
            rc += m0[p];
            uint64_t s = bm * ac + am * bc + m0[p] - m1[p];
            if (kMode == kVerifyOnl) s += __ldg(z.re + (rec * 8LL + p) * R + r);
            ss += s;
            if (kMode != kVerifyPre) store8(z.onl, onl + 8LL * p, r, s);
            at(c, dst, p, x) = m1[p];
          }
          const uint64_t d = kMode == kVerifyOnl ? __ldg(z.co + corr * R + r) : ra * rb - rc;
          const uint64_t re = kMode != kVerifyPre ? ss + d : 0;
          at(c, dst, 8, x) = re + ac * bc;
          store8(z.pre, pre, r, d);
          break;
        }
        case kG_Assert: {
          if (kMode == kVerifyPre) break;
          uint64_t sum = at(c, a, 8, x);
#pragma unroll
          for (int p = 0; p < 8; ++p) {
            uint64_t s = at(c, a, p, x);
            if (kMode == kVerifyOnl) s += __ldg(z.re + (rec * 8LL + p) * R + r);
            sum += s;
            store8(z.onl, onl + 8LL * p, r, s);
          }
          if (sum != 0) atomicOr(c.s_fail + x / 4, 0x80u << (8 * (x & 3)));
          break;
        }
        case kG_Input:
        case kG_Random:
        case kB2A_Corr: {
          uint64_t rs = 0;
#pragma unroll
          for (int p = 0; p < 8; ++p) {
            const uint64_t m = tape(t0, p);
            rs += m;
            at(c, dst, p, x) = m;
          }
          uint64_t cv = 0;
          if (op == kG_Input) {
            if (kMode == kProver) cv = __ldg(z.xin + xin * R + r) - rs;
            if (kMode == kVerifyOnl) cv = __ldg(z.xin + xin * R + r);
            if (kMode != kVerifyPre) store8(z.onl, onl, r, cv);
          } else if (op == kB2A_Corr) {
            if (kMode == kVerifyOnl) {
              cv = __ldg(z.co + corr * R + r);
            } else {
              uint64_t v = 0;
              for (int i = 0; i < 64; ++i) {
                const uint2 wd = gf2_slot(g, c, __ldg(z.bits + bits * 64LL + i), x / 4);
                v += static_cast<uint64_t>(__popc((wd.x >> (8 * (x & 3))) & 0xFFu) & 1) << i;
              }
              cv = v - rs;
            }
            store8(z.pre, pre, r, cv);
          }
          at(c, dst, 8, x) = cv;
          break;
        }
        case kB2A_Out: {
          uint64_t v = 0;
          for (int i = 0; i < 64; ++i) {
            const uint2 wd = gf2_slot(g, c, __ldg(z.bits + bits * 64LL + i), x / 4);
            uint32_t sb = (wd.x >> (8 * (x & 3))) & 0xFFu;
            const uint32_t bc = (wd.y >> (8 * (x & 3))) & 0xFFu;
            if (kMode == kVerifyOnl) sb ^= __ldg(g.re2 + (brec + static_cast<long long>(i)) * R + r);
            const uint32_t ob = kMode != kVerifyPre ? ((__popc(sb) & 1) ^ bc) : bc;
            v += static_cast<uint64_t>(ob) << i;
            if (kMode != kVerifyPre) g.onl[(bonl + static_cast<long long>(i)) * R + r] = sb;
          }
#pragma unroll
          for (int p = 0; p < 8; ++p) at(c, dst, p, x) = 0 - at(c, b, p, x);
          at(c, dst, 8, x) = v - at(c, b, 8, x);
          break;
        }
        default: {  // the linear kinds: ADD, SUB, ADDC, SUBC, MULC, CONST
          const uint64_t ac = at(c, a, 8, x), bc = at(c, b, 8, x);
#pragma unroll
          for (int p = 0; p < 8; ++p) {
            const uint64_t am = at(c, a, p, x), bm = at(c, b, p, x);
            at(c, dst, p, x) = op == kG_Add ? am + bm : op == kZ_Sub ? am - bm
                               : op == kG_Mulc ? am * k : op == kG_Const ? 0 : am;
          }
          at(c, dst, 8, x) = op == kG_Add ? ac + bc : op == kZ_Sub ? ac - bc
                             : op == kG_Addc ? ac + k : op == kG_Subc ? ac - k
                             : op == kG_Mulc ? ac * k : k;
          break;
        }
      }
    }
  }
};

template <int kMode, int kK>
__global__ void __launch_bounds__(kMaxThreadsZ64) scan_z64_kernel(Args g, ZArgs za) {
  Z64<kMode> z{g, za};
  run_waves<kMode, kK, false>(g, CarryArgs{}, z);
}

template <int kMode, int kK>
__global__ void __launch_bounds__(kMaxThreadsZ64)
scan_z64_carry_kernel(Args g, CarryArgs carry, ZArgs za) {
  Z64<kMode> z{g, za};
  run_waves<kMode, kK, true>(g, carry, z);
}

template <int kMode, int kK>
cudaError_t launch_carry(const Launch& L, const ZArgs& z, int* blocks_per_sm) {
  if (L.carry.n_cin || L.carry.n_cout || z.n_cin || z.n_cout) {
    return launch_kernel<scan_z64_carry_kernel<kMode, kK>>(L, z.n_shared, blocks_per_sm, L.g,
                                                           L.carry, z);
  }
  return launch_kernel<scan_z64_kernel<kMode, kK>>(L, z.n_shared, blocks_per_sm, L.g, z);
}

cudaError_t dispatch(const long long* words, int* blocks_per_sm) {
  const Launch L = launch_args(words);
  const ZArgs z = zargs(words + kLaunchWords);
  if (!launch_ok(L) || L.reps / 4 * L.threads_y > kMaxThreadsZ64 || z.Wz <= 0 ||
      z.n_shared < 1 || z.n_cin < 0 || z.n_cout < 0) {
    return cudaErrorInvalidValue;
  }
#define REVERIE_SCAN_K(M)                                        \
  switch (L.k) {                                                 \
    case 1: return launch_carry<M, 1>(L, z, blocks_per_sm);      \
    case 2: return launch_carry<M, 2>(L, z, blocks_per_sm);      \
    case 4: return launch_carry<M, 4>(L, z, blocks_per_sm);      \
    default: return cudaErrorInvalidValue;                       \
  }
  switch (L.mode) {
    case kProver: REVERIE_SCAN_K(kProver)
    case kVerifyOnl: REVERIE_SCAN_K(kVerifyOnl)
    case kVerifyPre: REVERIE_SCAN_K(kVerifyPre)
    default: return cudaErrorInvalidValue;
  }
#undef REVERIE_SCAN_K
}

}  // namespace

// One launch of W2 from its kLaunchWords + 19 int64 words
// (backend/scan.py `wave_run`).
extern "C" int reverie_scan_z64(const long long* words) {
  return static_cast<int>(dispatch(words, nullptr));
}

// Resident blocks per SM of the launch reverie_scan_z64 would make with
// these words (pointers may be 0), into *blocks.
extern "C" int reverie_scan_z64_plan(const long long* words, int* blocks) {
  return static_cast<int>(dispatch(words, blocks));
}
