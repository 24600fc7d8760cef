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
// slots backend/scan.py pack_ztable's program of the slot-allocated
// zwave_table:
//   zslots    (n_waves, Wz, 8) int32: op | dst << 8, a, b (zr for B2A_OUT),
//             its first staged word | its bits row << 16 (both counted from
//             its chunk's first), onl (bonl for B2A_OUT), pre, the
//             constant's lo and hi words. dst, a, b are z64 slots: below
//             n_sharedz in shared memory, the others rows of the z64 spill
//             arena
//   zfields   int32 source << 29 | row per staged word (sources: 0 tapez
//             row t * 8 + p, 1 xinz, 2 coz, 3 rez row rec * 8 + p, 4 the
//             eight re2 rows from row: a B2A_OUT's bit records), a slot's
//             words in backend/scan.py _ZFIELDS order; zchunk_off (n_chunks
//             + 1) int2: the first field and the first bits row of each
//             chunk of waves
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
// What bounds it on the H100: as W1, the chain of waves (the 5,000-MUL z64
// chain: 5,004 waves, one MUL each), so the latency of the work that must
// follow each barrier, and at a batch's width the card's issue rate. Two
// things make that work slow (measured on the H100): a slot's words and
// its tape words read from device memory after the barrier, two dependent
// global round trips a wave (2.5 us a wave; 4.7 with the online
// verifier's recon words), and one thread running a MUL's 8 players, some
// 700 dependent instructions (1.9 us a wave once the loads were staged).
//
// What the design does about it. Nothing a wave reads comes from device
// memory but the spill arenas: the z64 half stages its chunks in the same
// cp.async batch and the same wait as W1's (csrc/scan_core.cuh run_waves),
// in shared memory in front of W1's: the next chunk's packed slots, their
// B2A bits rows and the list of the input words they read, and this
// chunk's input words for the block's reps (field e's word for rep x at
// e * reps + x; 16-byte copies where the row segment is aligned, 8-byte
// ones elsewhere, none past R; the re2 bytes of a B2A_OUT as eight rows of
// reps bytes). A second buffer of words, staged a chunk ahead, was no
// faster on the H100. Each thread decodes its lane of the next wave
// before the barrier: where its operands and destination live (a
// shared-memory or spill-arena word and its stride, settled once) and
// where its input words are. A (rep, z64 slot) takes kL threads of one
// warp: 8, one a player, their sums by shuffles, where the blocks fit the
// card at once (the chain's wave then takes ~0.9 us on the H100); 1, all 8
// players, past that, where the card's issue rate and its resident blocks
// bound the time (backend/scan.py launch_plan chooses, and the staged
// chunk's size). A thread takes one GF(2) slot (with more, the kernels
// spilled) and blocks at most 512 threads (128 registers a thread); lanes
// past the block's threads are decoded after the barrier. The live z64 values of a block's
// reps sit in dynamic shared memory after the GF(2) slots, 72 bytes a
// value a rep (value-major, then word, then rep), spilled to a global
// arena past the plan's capacity. The arithmetic is uint64_t, which wraps
// mod 2^64 as the port's int64 tensors do. A B2A slot reads the 64 GF(2)
// values of earlier waves from W1's slots (shared or spilled), byte x & 3
// of the word of group x / 4; a failed z64 ASSERT_ZERO sets the fail bit of
// W1's word for its rep. The event stores (a MUL's 64 + 8 bytes a rep, one
// byte each) are left as they are.

#include "scan_core.cuh"

namespace {

constexpr int kZBytes = 72;     // a live z64 value a rep: 8 mask words, a corr
constexpr int kZSlotWords = 8;  // int32 words of a packed z64 slot
// a block's most threads (backend/scan.py MAX_THREADS_Z64): 128 registers a
// thread
constexpr int kMaxThreadsZ64 = 512;
constexpr int kG_Input = 0, kG_Add = 1, kG_Addc = 2, kG_Subc = 3, kG_Mulc = 4, kG_Mul = 5,
              kG_Assert = 6, kG_Random = 7, kG_Const = 8, kZ_Sub = 9, kB2A_Corr = 10,
              kB2A_Out = 11;
// sources of a staged word (backend/scan.py _ZSOURCES)
constexpr int kSrcTape = 0, kSrcXin = 1, kSrcCo = 2, kSrcRe = 3, kSrcRe2 = 4;

struct ZArgs {
  const int4* slots;      // (n_waves, Wz, 8) packed
  int Wz;
  const int* fields;      // source << 29 | row per staged word
  const int2* chunk_off;  // (n_chunks + 1): first field, first bits row
  const int* bits;        // (n_b2a, 64) GF(2) slots
  int n_shared, max_fields, max_bits;
  int lanes;             // threads a (rep, slot): 1 or 8
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
  z.slots = ptr<const int4>(a[0]);
  z.Wz = static_cast<int>(a[1]);
  z.fields = ptr<const int>(a[2]);
  z.chunk_off = ptr<const int2>(a[3]);
  z.bits = ptr<const int>(a[4]);
  z.n_shared = static_cast<int>(a[5]);
  z.max_fields = static_cast<int>(a[6]);
  z.max_bits = static_cast<int>(a[7]);
  z.lanes = static_cast<int>(a[8]);
  z.tape = ptr<const uint64_t>(a[9]);
  z.xin = ptr<const uint64_t>(a[10]);
  z.co = ptr<const uint64_t>(a[11]);
  z.re = ptr<const uint64_t>(a[12]);
  z.spill = ptr<uint64_t>(a[13]);
  z.onl = ptr<uint8_t>(a[14]);
  z.pre = ptr<uint8_t>(a[15]);
  z.cin = ptr<const int>(a[16]);
  z.n_cin = static_cast<int>(a[17]);
  z.cin_mask = ptr<const uint64_t>(a[18]);
  z.cin_corr = ptr<const uint64_t>(a[19]);
  z.cout = ptr<const int>(a[20]);
  z.n_cout = static_cast<int>(a[21]);
  z.cout_mask = ptr<uint64_t>(a[22]);
  z.cout_corr = ptr<uint64_t>(a[23]);
  return z;
}

// Shared memory the z64 half stages in front of W1's: two chunks of packed
// slots, one chunk of staged words (reps of each), two chunks of bits rows
// and two of fields (a multiple of 4, so that W1's slots stay 16-byte
// aligned) (backend/scan.py staged_bytes).
__host__ __device__ __forceinline__ size_t zstage_bytes(int chunk, int Wz, int max_fields,
                                                        int max_bits, int reps) {
  return 2 * static_cast<size_t>(chunk) * Wz * kZSlotWords * 4 +
         static_cast<size_t>(max_fields) * reps * 8 + 2 * static_cast<size_t>(max_bits) * 64 * 4 +
         2 * static_cast<size_t>((max_fields + 3) & ~3) * 4;
}

// Dynamic shared memory of the z64 half of a block: its staged chunk and
// its shared slots (backend/scan.py WaveProgram.smem_bytes).
size_t z_smem_bytes(const ZArgs& z, int chunk, int reps) {
  return zstage_bytes(chunk, z.Wz, z.max_fields, z.max_bits, reps) +
         kZBytes * static_cast<size_t>(z.n_shared) * reps;
}

// A z64 slot decoded before its wave's barrier for one of its `lanes`
// lanes (consecutive threads of one warp): rep x, players p0, p0 + lanes,
// ... Its kind, word 0 of its operands and its destination with the
// stride between their 9 words (shared memory: reps; the spill arena: R;
// settled here), its staged input words (word k at in[k * reps]), its bits
// row, its event rows and its constant.
struct ZDec {
  int op, x, p0;
  const uint64_t *a, *b;
  uint64_t* d;
  int sa, sb, sd;
  const uint64_t* in;
  const int* bits;
  int onl, pre;
  uint64_t k;
};

// v summed over a slot's kL lanes (`mask`: theirs), in each of them.
template <int kL>
__device__ __forceinline__ uint64_t lanes_sum(uint64_t v, unsigned mask) {
#pragma unroll
  for (int o = 1; o < kL; o <<= 1) v += __shfl_xor_sync(mask, v, o);
  return v;
}

// The z64 half of W2 for role kMode: slot 0's zero, the carries, the
// staging of each chunk and each wave's z64 slots, `lanes` threads a (rep,
// slot), for the block's reps.
template <int kMode, int kL>
struct Z64 {
  const Args& g;
  const ZArgs& z;
  int4* slots;      // two chunks of packed slots (two int4 a slot)
  uint64_t* words;  // the chunk's staged words
  int* bits;        // two chunks of bits rows
  int* fields;      // two chunks of fields
  int2 o0, o1, o2, o3;  // the first field and bits row of chunks c .. c + 3
  int n_chunks;
  ZDec cur;  // the thread's first lane of the wave, decoded

  __device__ __forceinline__ int front_bytes(int chunk, int reps) const {
    return static_cast<int>(zstage_bytes(chunk, z.Wz, z.max_fields, z.max_bits, reps));
  }

  __device__ __forceinline__ uint64_t* vz(const Ctx& c) const {
    return reinterpret_cast<uint64_t*>(c.vals + g.n_shared * c.groups);
  }

  // Word 0 of z64 slot s for rep x, and the stride between its 9 words.
  __device__ __forceinline__ uint64_t* ref(const Ctx& c, int s, int x, int& stride) const {
    if (s < z.n_shared) {
      stride = c.reps;
      return vz(c) + s * 9 * c.reps + x;
    }
    stride = static_cast<int>(g.R);
    return z.spill + static_cast<long long>(s - z.n_shared) * 9 * g.R + c.r0 + x;
  }

  // Chunk ci's packed slots (its first wave w), fields and bits rows into
  // buffer b (oa, ob: the first field and bits row of chunks ci, ci + 1).
  __device__ __forceinline__ void stage_chunk(const Ctx& c, int w, int b, int2 oa,
                                              int2 ob) const {
    const int nw = min(g.chunk, g.n_waves - w);
    if (nw <= 0) return;
    const int n = nw * z.Wz * 2;
    const int4* src = z.slots + static_cast<long long>(w) * z.Wz * 2;
    int4* dst = slots + b * g.chunk * z.Wz * 2;
    for (int i = c.tid; i < n; i += c.nthreads) cp_async16(dst + i, src + i);
    int* fd = fields + b * ((z.max_fields + 3) & ~3);
    for (int i = c.tid; i < ob.x - oa.x; i += c.nthreads) cp_async4(fd + i, z.fields + oa.x + i);
    int4* bd = reinterpret_cast<int4*>(bits + b * z.max_bits * 64);
    const int4* bs = reinterpret_cast<const int4*>(z.bits + static_cast<long long>(oa.y) * 64);
    for (int i = c.tid; i < (ob.y - oa.y) * 16; i += c.nthreads) cp_async16(bd + i, bs + i);
  }

  // 4 re2 bytes of row `row` from rep r on into dst, never past R.
  __device__ __forceinline__ void stage4(uint8_t* dst, long long row, long long r) const {
    const uint8_t* src = g.re2 + row * g.R + r;
    if (r + 4 <= g.R && (reinterpret_cast<uintptr_t>(src) & 3) == 0) {
      cp_async4(dst, src);
    } else {
      for (int j = 0; j < 4 && r + j < g.R; ++j) dst[j] = __ldg(src + j);
    }
  }

  // The n staged words of the chunk in buffer b for the block's reps, 16
  // bytes (two reps' words, or four re2 rows' segments of 4) a step.
  __device__ __forceinline__ void stage_words(const Ctx& c, int b, int n) const {
    const int* fd = fields + b * ((z.max_fields + 3) & ~3);
    const int units = c.reps / 2;
    for (int it = c.tid; it < n * units; it += c.nthreads) {
      const int e = it / units, u = it % units;
      const uint32_t f = static_cast<uint32_t>(fd[e]);
      const int src = f >> 29;
      const long long row = f & 0x1FFFFFFFu;
      uint8_t* dst = reinterpret_cast<uint8_t*>(words + e * c.reps) + 16 * u;
      if (src == kSrcRe2) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int o = 16 * u + 4 * k;
          stage4(dst + 4 * k, row + o / c.reps, c.r0 + o % c.reps);
        }
        continue;
      }
      const uint64_t* base = src == kSrcTape ? z.tape : src == kSrcXin ? z.xin
                             : src == kSrcCo ? z.co : z.re;
      const long long r = c.r0 + 2 * u;
      const uint64_t* s = base + row * g.R + r;
      if (r + 1 < g.R && (reinterpret_cast<uintptr_t>(s) & 15) == 0) {
        cp_async16(dst, s);
      } else {
        if (r < g.R) cp_async8(dst, s);
        if (r + 1 < g.R) cp_async8(dst + 8, s + 1);
      }
    }
  }

  __device__ __forceinline__ void init(const Ctx& c) {
    extern __shared__ __align__(16) unsigned char smem[];
    slots = reinterpret_cast<int4*>(smem);
    words = reinterpret_cast<uint64_t*>(smem + 2 * g.chunk * z.Wz * kZSlotWords * 4);
    bits = reinterpret_cast<int*>(words + z.max_fields * c.reps);
    fields = bits + 2 * z.max_bits * 64;
    for (int i = c.tid; i < 9 * c.reps; i += c.nthreads) vz(c)[i] = 0;
    n_chunks = (g.n_waves + g.chunk - 1) / g.chunk;
    o0 = __ldg(z.chunk_off);
    o1 = __ldg(z.chunk_off + min(1, n_chunks));
    o2 = __ldg(z.chunk_off + min(2, n_chunks));
    stage_chunk(c, 0, 0, o0, o1);
  }

  // At chunk ci's start (its first wave w0, its buffer b): the next chunk's
  // slots, fields and bits, and this chunk's words.
  __device__ __forceinline__ void stage(const Ctx& c, int ci, int b, int w0) {
    o3 = __ldg(z.chunk_off + min(ci + 3, n_chunks));
    stage_chunk(c, w0 + g.chunk, b ^ 1, o1, o2);
    stage_words(c, b, o1.x - o0.x);
  }

  __device__ __forceinline__ void next_chunk() {
    o0 = o1;
    o1 = o2;
    o2 = o3;
  }

  // Lane `it` (it % lanes of rep it / lanes % reps of slot it / lanes /
  // reps) of wave i of the chunk in buffer b.
  __device__ __forceinline__ void decode(ZDec& d, const Ctx& c, int b, int i, int it) const {
    d.op = kNop;
    const int item = it / kL, x = item % c.reps, j = item / c.reps;
    if (j >= z.Wz || c.r0 + x >= g.R) return;
    const int4* s = slots + ((b * g.chunk + i) * z.Wz + j) * 2;
    const int4 lo = s[0], hi = s[1];
    d.op = lo.x & 0xFF;
    if (d.op == kNop) return;
    d.x = x;
    d.p0 = it % kL;
    d.a = ref(c, lo.y, x, d.sa);
    d.b = ref(c, lo.z, x, d.sb);
    d.d = ref(c, static_cast<int>(static_cast<uint32_t>(lo.x) >> 8), x, d.sd);
    d.in = words + (lo.w & 0xFFFF) * c.reps + x;
    d.bits = bits + (b * z.max_bits + (static_cast<uint32_t>(lo.w) >> 16)) * 64;
    d.onl = hi.x;
    d.pre = hi.y;
    d.k = (static_cast<uint64_t>(static_cast<uint32_t>(hi.w)) << 32) |
          static_cast<uint32_t>(hi.z);
  }

  __device__ __forceinline__ void begin(const Ctx& c, int b) { decode(cur, c, b, 0, c.tid); }

  // 8 little-endian bytes of v into rows row .. row + 7 at rep r.
  __device__ __forceinline__ void store8(uint8_t* rows, long long row, long long r,
                                         uint64_t v) const {
#pragma unroll
    for (int j = 0; j < 8; ++j) rows[(row + j) * g.R + r] = static_cast<uint8_t>(v >> (8 * j));
  }

  // A decoded lane of kL a slot after the barrier: its players' words (p0,
  // p0 + kL, ...), the slot's sums over its lanes, and lane 0 the corr
  // word; the 8 event bytes of a word are stored by the lanes in turn.
  __device__ __forceinline__ void exec(const ZDec& d, const Ctx& c) const {
    if (d.op == kNop) return;
    constexpr int L = kL, kN = 8 / kL;  // a lane's players
    const long long R = g.R, r = c.r0 + d.x;
    const int reps = c.reps, p0 = d.p0;
    const unsigned mask = (0xFFu >> (8 - L)) << (c.tid & 31 & -L);
    auto in = [&](int k) { return d.in[k * reps]; };
    auto A = [&](int p) -> const uint64_t& { return d.a[p * d.sa]; };
    auto B = [&](int p) -> const uint64_t& { return d.b[p * d.sb]; };
    auto D = [&](int p) -> uint64_t& { return d.d[p * d.sd]; };
    auto bytes = [&](uint8_t* rows, long long row, uint64_t v) {
#pragma unroll
      for (int q = 0; q < kN; ++q) {
        const int j = p0 + q * L;
        rows[(row + j) * R + r] = static_cast<uint8_t>(v >> (8 * j));
      }
    };
    switch (d.op) {
      case kG_Mul: {
        const uint64_t ac = A(8), bc = B(8);
        uint64_t ra = 0, rb = 0, rc = 0, ss = 0;
#pragma unroll
        for (int q = 0; q < kN; ++q) {
          const int p = p0 + q * L;
          const uint64_t am = A(p), bm = B(p), m0 = in(p), m1 = in(8 + p);
          ra += am;
          rb += bm;
          rc += m0;
          uint64_t s = bm * ac + am * bc + m0 - m1;
          if (kMode == kVerifyOnl) s += in(16 + p);
          ss += s;
          if (kMode != kVerifyPre) store8(z.onl, d.onl + 8LL * p, r, s);
          D(p) = m1;
        }
        const uint64_t dl = kMode == kVerifyOnl
                                ? in(24)
                                : lanes_sum<L>(ra, mask) * lanes_sum<L>(rb, mask) -
                                      lanes_sum<L>(rc, mask);
        const uint64_t re = kMode != kVerifyPre ? lanes_sum<L>(ss, mask) + dl : 0;
        if (p0 == 0) D(8) = re + ac * bc;
        bytes(z.pre, d.pre, dl);
        break;
      }
      case kG_Assert: {
        if (kMode == kVerifyPre) break;
        uint64_t sum = 0;
#pragma unroll
        for (int q = 0; q < kN; ++q) {
          const int p = p0 + q * L;
          uint64_t s = A(p);
          if (kMode == kVerifyOnl) s += in(p);
          sum += s;
          store8(z.onl, d.onl + 8LL * p, r, s);
        }
        sum = lanes_sum<L>(sum, mask) + A(8);
        if (p0 == 0 && sum != 0) atomicOr(c.s_fail + d.x / 4, 0x80u << (8 * (d.x & 3)));
        break;
      }
      case kG_Input:
      case kG_Random:
      case kB2A_Corr: {
        uint64_t rs = 0;
#pragma unroll
        for (int q = 0; q < kN; ++q) {
          const int p = p0 + q * L;
          const uint64_t m = in(p);
          rs += m;
          D(p) = m;
        }
        uint64_t cv = 0;
        if (d.op == kG_Input) {
          if (kMode == kProver) cv = in(8) - lanes_sum<L>(rs, mask);
          if (kMode == kVerifyOnl) cv = in(8);
          if (kMode != kVerifyPre) bytes(z.onl, d.onl, cv);
        } else if (d.op == kB2A_Corr) {
          if (kMode == kVerifyOnl) {
            cv = in(8);
          } else {
            // the lane's bits: 8p .. 8p + 7 for each of its players p
            uint64_t v = 0;
#pragma unroll 1  // unrolled, the one-lane kernels spilled
            for (int q = 0; q < kN; ++q) {
              const int p = p0 + q * L;
              for (int t = 0; t < 8; ++t) {
                const uint2 wd = gf2_slot(g, c, d.bits[8 * p + t], d.x / 4);
                v |= static_cast<uint64_t>(__popc((wd.x >> (8 * (d.x & 3))) & 0xFFu) & 1)
                     << (8 * p + t);
              }
            }
            cv = lanes_sum<L>(v, mask) - lanes_sum<L>(rs, mask);
          }
          bytes(z.pre, d.pre, cv);
        }
        if (p0 == 0) D(8) = cv;
        break;
      }
      case kB2A_Out: {
        // the staged re2 bytes: bit i's for rep x at i * reps + x
        const uint8_t* rb2 = reinterpret_cast<const uint8_t*>(d.in - d.x) + d.x;
        uint64_t v = 0;
#pragma unroll 1  // unrolled, the one-lane kernels spilled
        for (int q = 0; q < kN; ++q) {
          const int p = p0 + q * L;
          for (int t = 0; t < 8; ++t) {
            const int i = 8 * p + t;
            const uint2 wd = gf2_slot(g, c, d.bits[i], d.x / 4);
            uint32_t sb = (wd.x >> (8 * (d.x & 3))) & 0xFFu;
            const uint32_t bc = (wd.y >> (8 * (d.x & 3))) & 0xFFu;
            if (kMode == kVerifyOnl) sb ^= rb2[i * reps];
            const uint32_t ob = kMode != kVerifyPre ? ((__popc(sb) & 1) ^ bc) : bc;
            v |= static_cast<uint64_t>(ob) << i;
            if (kMode != kVerifyPre) g.onl[(d.onl + static_cast<long long>(i)) * R + r] = sb;
          }
          D(p) = 0 - B(p);
        }
        v = lanes_sum<L>(v, mask);
        if (p0 == 0) D(8) = v - B(8);
        break;
      }
      default: {  // the linear kinds: ADD, SUB, ADDC, SUBC, MULC, CONST
        const int op = d.op;
        const uint64_t k = d.k;
#pragma unroll
        for (int q = 0; q < kN; ++q) {
          const int p = p0 + q * L;
          const uint64_t am = A(p), bm = B(p);
          D(p) = op == kG_Add ? am + bm : op == kZ_Sub ? am - bm
                 : op == kG_Mulc ? am * k : op == kG_Const ? 0 : am;
        }
        if (p0 == 0) {
          const uint64_t ac = A(8), bc = B(8);
          D(8) = op == kG_Add ? ac + bc : op == kZ_Sub ? ac - bc
                 : op == kG_Addc ? ac + k : op == kG_Subc ? ac - k
                 : op == kG_Mulc ? ac * k : k;
        }
        break;
      }
    }
  }

  // Wave i of the chunk in buffer b (of n waves): the thread's decoded
  // lane, any further ones decoded here, then its lane of wave i + 1.
  __device__ __forceinline__ void wave(const Ctx& c, int b, int i, int n) {
    exec(cur, c);
    for (int it = c.tid + c.nthreads; it < kL * c.reps * z.Wz; it += c.nthreads) {
      ZDec d;
      decode(d, c, b, i, it);
      exec(d, c);
    }
    if (i + 1 < n) decode(cur, c, b, i + 1, c.tid);
  }

  __device__ __forceinline__ void load_carry(const Ctx& c) const {
    for (int it = c.tid; it < z.n_cin * c.reps; it += c.nthreads) {
      const int i = it / c.reps, x = it % c.reps;
      const long long r = c.r0 + x;
      if (r >= g.R) continue;
      int st;
      uint64_t* v = ref(c, __ldg(z.cin + i), x, st);
      for (int p = 0; p < 8; ++p) v[p * st] = __ldg(z.cin_mask + (i * 8LL + p) * g.R + r);
      v[8 * st] = __ldg(z.cin_corr + i * g.R + r);
    }
  }

  __device__ __forceinline__ void store_carry(const Ctx& c) const {
    for (int it = c.tid; it < z.n_cout * c.reps; it += c.nthreads) {
      const int i = it / c.reps, x = it % c.reps;
      const long long r = c.r0 + x;
      if (r >= g.R) continue;
      int st;
      const uint64_t* v = ref(c, __ldg(z.cout + i), x, st);
      for (int p = 0; p < 8; ++p) z.cout_mask[(i * 8LL + p) * g.R + r] = v[p * st];
      z.cout_corr[i * g.R + r] = v[8 * st];
    }
  }
};

// W2 for role kMode with kL threads a (rep, z64 slot), one GF(2) slot a
// thread (k = 1: with more, the kernels spilled).
template <int kMode, int kL>
__global__ void __launch_bounds__(kMaxThreadsZ64) scan_z64_kernel(Args g, ZArgs za) {
  Z64<kMode, kL> z{g, za};
  run_waves<kMode, 1, false>(g, CarryArgs{}, z);
}

template <int kMode, int kL>
__global__ void __launch_bounds__(kMaxThreadsZ64)
scan_z64_carry_kernel(Args g, CarryArgs carry, ZArgs za) {
  Z64<kMode, kL> z{g, za};
  run_waves<kMode, 1, true>(g, carry, z);
}

template <int kMode, int kL>
cudaError_t launch_carry(const Launch& L, const ZArgs& z, int* blocks_per_sm) {
  const size_t zb = z_smem_bytes(z, L.g.chunk, L.reps);
  if (L.carry.n_cin || L.carry.n_cout || z.n_cin || z.n_cout) {
    return launch_kernel<scan_z64_carry_kernel<kMode, kL>>(L, zb, blocks_per_sm, L.g, L.carry,
                                                           z);
  }
  return launch_kernel<scan_z64_kernel<kMode, kL>>(L, zb, blocks_per_sm, L.g, z);
}

template <int kMode>
cudaError_t launch_lanes(const Launch& L, const ZArgs& z, int* blocks_per_sm) {
  return z.lanes == 8 ? launch_carry<kMode, 8>(L, z, blocks_per_sm)
                      : launch_carry<kMode, 1>(L, z, blocks_per_sm);
}

cudaError_t dispatch(const long long* words, int* blocks_per_sm) {
  const Launch L = launch_args(words);
  const ZArgs z = zargs(words + kLaunchWords);
  if (!launch_ok(L) || L.k != 1 || L.reps / 4 * L.threads_y > kMaxThreadsZ64 ||
      L.reps / 4 * L.threads_y % 32 != 0 || z.Wz <= 0 ||
      z.n_shared < 1 || z.max_fields < 0 || z.max_bits < 0 || z.n_cin < 0 || z.n_cout < 0 ||
      (z.lanes != 1 && z.lanes != 8) ||
      L.g.R >= (1LL << 28)) {
    return cudaErrorInvalidValue;
  }
  switch (L.mode) {
    case kProver: return launch_lanes<kProver>(L, z, blocks_per_sm);
    case kVerifyOnl: return launch_lanes<kVerifyOnl>(L, z, blocks_per_sm);
    case kVerifyPre: return launch_lanes<kVerifyPre>(L, z, blocks_per_sm);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// One launch of W2 from its kLaunchWords + 24 int64 words
// (backend/scan.py `wave_run`).
extern "C" int reverie_scan_z64(const long long* words) {
  return static_cast<int>(dispatch(words, nullptr));
}

// Resident blocks per SM of the launch reverie_scan_z64 would make with
// these words (pointers may be 0), into *blocks.
extern "C" int reverie_scan_z64_plan(const long long* words, int* blocks) {
  return static_cast<int>(dispatch(words, blocks));
}

// Dynamic shared memory of a block of the launch reverie_scan_z64 would
// make with these words (pointers may be 0), into *bytes: backend/scan.py
// WaveProgram.smem_bytes must equal it.
extern "C" int reverie_scan_z64_smem(const long long* words, long long* bytes) {
  const Launch L = launch_args(words);
  const ZArgs z = zargs(words + kLaunchWords);
  const Args& g = L.g;
  *bytes = static_cast<long long>(smem_bytes(g.Wp, g.chunk, g.max_fields, g.n_shared, L.reps) +
                                  z_smem_bytes(z, g.chunk, L.reps));
  return 0;
}
