// GF(2) wave executor: every wave of a deep circuit in one launch.
//
// Replaces reverie_tpu/backend/tpu_scan.py:247 _scan_trace_fast2, the body of
// the lax.scan that ScanExecutor runs over the waves of build_waves (XLA code,
// not a Pallas kernel); its plain version is backend/scan.py:wave_gf2_ref.
//
// Contract (mode 0 PROVER, 1 VERIFY_ONL, 2 VERIFY_PRE), backend/scan.py
// pack_table's program of a slot-allocated wave table (allocate_slots):
//   slots     (n_waves, Wp, 8) int32: head = op | cbit << 7 | dst << 8, a,
//             b, onl, pre, first field, ma | mb << 16, kind | sub << 2 |
//             k << 8. dst, a, b are slots: below n_shared in shared
//             memory, the others rows of the spill arena
//   fields    int32 source << 30 | row per input byte a slot reads (tape,
//             xin, re2, co2), chunk_off: the first field of each chunk
//   tape (m2, R) u8; xin (rows, R) u8: wit2 (PROVER), in2 (VERIFY_ONL);
//   co2, re2 (rows, R) u8 (VERIFY_ONL)
//   spill     (n_spill, ceil(R / 4)) uint2 scratch: 4 reps' masks, corrs
//   onl, pre  (rows, R) u8, zero on entry: each event's byte at its row
//   fail      (R,) u8: 1 where an ASSERT_ZERO failed (PROVER, VERIFY_ONL)
//   carries   the slots of the carried-in values and their (k, R) u8 mask
//             and corr rows, loaded before wave 0; the slots of the
//             carried-out values and the rows they are stored to after the
//             last wave (streaming's segment carries)
// Row offsets are 64-bit (a batch's rows pass 2^31 bytes). The arguments
// come as int64 words (backend/scan.py `_args`, csrc/scan_core.cuh
// `launch_args`).
//
// What bounds it on the H100: the waves are a dependency chain (SHA-256:
// 5,874 waves); a wave's slots are independent of each other, not of the
// wave before, and reps never interact. The chain sets the time: per wave,
// a barrier and the work that must follow it. Two things made that work
// slow (measured on the H100): every global load in flight at a barrier,
// a cp.async one included, costs its whole latency (the first version of
// this kernel read its table and both operands from device memory after
// the barrier, ~900 cycles a wave), and once those are gone the block's
// instructions per wave are what is left.
//
// What the design does about it. The host renumbers the SSA values into
// slots by linear scan over their live intervals (SHA-256: 2,410 slots for
// 135,203 values), so the live values of a block's reps sit in dynamic
// shared memory; a slot freed in wave l is written again from wave l + 1
// on, so no wave reads and writes one slot. Slots past the block's share
// spill to a global arena (the longest-lived values), read and written by
// this kernel. No global load crosses a wave's barrier: the waves come in
// chunks, and at a chunk's start one cp.async batch stages the next
// chunk's packed slots and fields and this chunk's input bytes (4-byte row
// segments, R % 4 == 0; otherwise decode loads them), and one wait covers
// it. Each slot is decoded a wave ahead, before the barrier: its operand
// and destination slots, its input bytes and, for the linear gates (ADD,
// ADDC, SUBC, MULC, RANDOM, CONST, INPUT), the masks and constant of out =
// (A & ma) ^ (B & mb) ^ k; an INPUT's event is stored there. After the
// barrier a wave is two shared loads, a short ALU chain and a shared store
// (and a MUL's events). A thread carries 4 consecutive reps as one word of
// masks and one of corrections (mask and correction bytes apart: XOR and
// AND as words, parities and negations byte-wise), 4x fewer threads and
// instructions than one rep a thread. A block owns `reps` (32, 16 or 8)
// consecutive lanes for the whole circuit (threadIdx.x: a group of 4), its
// threadIdx.y run over the slots of a wave, k of them each; the launch plan
// (scan.py launch_plan) picks reps and the chunk. The loop and the slot
// code live in csrc/scan_core.cuh, which W2 (csrc/scan_z64.cu) shares.

#include "scan_core.cuh"

namespace {

template <int kMode, int kK>
__global__ void __launch_bounds__(kMaxThreads) scan_gf2_kernel(Args g) {
  NoZ z;
  run_waves<kMode, kK, false>(g, CarryArgs{}, z);
}

template <int kMode, int kK>
__global__ void __launch_bounds__(kMaxThreads) scan_gf2_carry_kernel(Args g, CarryArgs carry) {
  NoZ z;
  run_waves<kMode, kK, true>(g, carry, z);
}

template <int kMode, int kK>
cudaError_t launch_carry(const Launch& L, int* blocks_per_sm) {
  if (L.carry.n_cin || L.carry.n_cout) {
    return launch_kernel<scan_gf2_carry_kernel<kMode, kK>>(L, 0, blocks_per_sm, L.g, L.carry);
  }
  return launch_kernel<scan_gf2_kernel<kMode, kK>>(L, 0, blocks_per_sm, L.g);
}

// The launch (blocks_per_sm null) or its resident blocks per SM.
cudaError_t dispatch(const Launch& L, int* blocks_per_sm) {
  if (!launch_ok(L)) return cudaErrorInvalidValue;
#define REVERIE_SCAN_K(M)                                      \
  switch (L.k) {                                               \
    case 1: return launch_carry<M, 1>(L, blocks_per_sm);       \
    case 2: return launch_carry<M, 2>(L, blocks_per_sm);       \
    case 4: return launch_carry<M, 4>(L, blocks_per_sm);       \
    default: return cudaErrorInvalidValue;                     \
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

// One launch of W1 from its kLaunchWords int64 words (backend/scan.py
// `_args`).
extern "C" int reverie_scan_gf2(const long long* words) {
  return static_cast<int>(dispatch(launch_args(words), nullptr));
}

// Resident blocks per SM of the launch reverie_scan_gf2 would make with
// these words (pointers may be 0; the smem attribute set as for a launch),
// into *blocks.
extern "C" int reverie_scan_gf2_plan(const long long* words, int* blocks) {
  return static_cast<int>(dispatch(launch_args(words), blocks));
}
