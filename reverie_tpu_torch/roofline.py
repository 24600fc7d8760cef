"""The least time an H100 could take for a kernel's work (its bound).

bound = max(bytes / memory rate, integer operations / issue rate), where
  * bytes are what the function must move: each input read once, each
    output written once;
  * the memory rate is the H100 SXM's 3.35 TB/s of HBM3 (NVIDIA data
    sheet);
  * the issue rate is 132 SMs x 128 lanes x the SM clock, which the caller
    reads from `nvidia-smi --query-gpu=clocks.max.sm`: an SM's four
    schedulers issue one warp instruction each a clock.  The ALU pipe has
    only 64 INT32 lanes an SM, but adds, moves, shifts and multiplies also
    issue as IMAD on the FMA pipe (the BLAKE3 tail's adds do:
    tools/tail_probe.py measures more compressions a second than 64 lanes
    allow), so only the issue rate bounds every mix of instructions.

Operation counts are the fewest 32-bit integer instructions that the
function needs per unit of work, in Hopper's instruction forms: a 3-input
XOR is one LOP3, `a + b + c` one IADD3, a rotation one funnel shift or byte
permute (PRMT), a byte extract one shift or PRMT.  Work done once per key
rather than once per block (the round keys' byte order), address
arithmetic, loads, stores and shared-memory table lookups are not counted,
so a kernel issues at least these and the bound stays a lower bound.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12
SMS = 132
ISSUE_LANES_PER_SM = 128

#: integer instructions of one AES-128 CTR block in the T-table form
#: (csrc/aes_core.cuh): the counter into the state (2 XORs); 9 rounds x 4
#: column words x (4 byte extracts + 2 LOP3 for the 5-way XOR of 4 table
#: words and the round key) = 216; the last round the same with S-box
#: tables whose bytes sit in place (4 x 6 = 24).  The 160 table lookups are
#: shared-memory loads.
AES_BLOCK_INT_OPS = 2 + 9 * 4 * (4 + 2) + 4 * (4 + 2)

#: integer instructions of one BLAKE3 compression of message words in
#: registers (a parent node, a pair hash, a staged block): 7 rounds x 8 G x
#: 12 (2 IADD3, 2 adds, 4 XORs, 4 rotations) = 672 and the 8 output XORs.
BLAKE3_NODE_INT_OPS = 7 * 8 * 12 + 8
#: those of one compression of a chunk's block read from its rows:
#: BLAKE3_NODE_INT_OPS and 16 message words x 2 PRMT, the fewest that make
#: a word of four rows' bytes (a 4 x 4 byte transpose of 4 rows' words;
#: csrc/blake3_chunks.cu reads a byte a row from shared memory and merges
#: four, which issues more).
BLAKE3_COMPRESSION_INT_OPS = BLAKE3_NODE_INT_OPS + 16 * 2


def blake3_tail_work(n_chunks: int, tail_len: int, R: int) -> Tuple[int, int]:
    """(bytes, integer instructions) of the tail of R columns' BLAKE3
    (csrc/blake3_tail.cu) on a stream of n_chunks chunks whose last holds
    tail_len bytes: the n_chunks - 1 chunk CVs read once (32 bytes each),
    the last chunk's bytes read once and the 32-byte hash written, a
    column; its compressions are the tree's n_chunks - 1 parents and the
    last chunk's blocks (one for an empty chunk)."""
    blocks = max(1, -(-tail_len // 64))
    n_bytes = ((n_chunks - 1) * 32 + tail_len + 32) * R
    return n_bytes, (n_chunks - 1 + blocks) * R * BLAKE3_NODE_INT_OPS


def blake3_pairs_work(R: int, pairs: int = 3) -> Tuple[int, int]:
    """(bytes, integer instructions) of `pairs` pair hashes a column
    (csrc/blake3_tail.cu's pairs kernel; 3: H(H(a || b) || H(c || d))): the
    pairs + 1 inputs of 32 bytes read once and the 32-byte output written,
    one compression a pair."""
    return (pairs + 2) * 32 * R, pairs * R * BLAKE3_NODE_INT_OPS


#: integer instructions per rep of one slot of the wave kernel
#: (csrc/scan_gf2.cu), by compiled gate kind (circuit/compile.py G_*), on
#: the arena word mask | corr << 8: ADD, ADDC, SUBC and MULC one LOP3 or
#: select each; RANDOM and CONST none (a move); INPUT 4 (the tape byte's
#: parity as POPC and LOP3, the word, the event's 0x00/0xFF); ASSERT_ZERO 3
#: (the mask byte's POPC, its parity against corr, the OR into fail); MUL 16
#: (the three parities 2 + 2 + 1, delta 1, the share s 4, its parity and
#: recon 2, corr 1, the word 1, delta's 0x00/0xFF 1, byte masks 2).  NOP
#: slots count nothing, nor does ASSERT_ZERO in VERIFY_PRE.
WAVE_GF2_INT_OPS = {0: 4, 1: 1, 2: 1, 3: 1, 4: 1, 5: 16, 6: 3, 7: 0, 8: 0}


def wave_gf2_work(ops: np.ndarray, mode: int, R: int, input_rows: int,
                  n_onl: int, n_pre: int) -> Tuple[int, int]:
    """(bytes, integer instructions) of one wave-kernel call over R lanes:
    the packed table once (12 int32 a slot, `ops` its opcode column) and,
    per lane, the input rows (tape, wit2 or in2, co2, re2) read once, the
    onl (not in VERIFY_PRE, mode 2) and pre rows written once, and fail.
    The arena of values is the kernel's scratch, neither input nor output,
    so its traffic is not counted."""
    kinds, counts = np.unique(np.asarray(ops), return_counts=True)
    per_lane = sum(WAVE_GF2_INT_OPS.get(int(k), 0) * int(c) for k, c in zip(kinds, counts)
                   if not (mode == 2 and k == 6))
    lane_bytes = input_rows + (n_onl if mode != 2 else 0) + n_pre + 1
    return np.asarray(ops).size * 12 * 4 + lane_bytes * R, per_lane * R


#: integer instructions per rep of one z64 slot of W2 (csrc/scan_z64.cu), by
#: role (0 PROVER, 1 VERIFY_ONL, 2 VERIFY_PRE) and compiled gate kind
#: (circuit/compile.py), in Hopper's forms: a 64-bit add or subtract 2
#: (IADD3, IADD3.X), a 64-bit product's low word 3 (IMAD.WIDE.U32 and two
#: IMAD), a negation 2, a test against zero 2, a byte extract 1.
#:   INPUT: the 8 tape words' sum 14, the witness less it 2 (PROVER), the
#:     event's 8 bytes (not VERIFY_PRE);
#:   ADD, SUB 18 (9 words); ADDC, SUBC 2; MULC 27; CONST, RANDOM 0;
#:   MUL: the three sums 42 and delta 5 (not VERIFY_ONL), the 8 shares 96
#:     (+ rez 16 in VERIFY_ONL), their sum and delta 16 (not VERIFY_PRE),
#:     the corr 5, delta's 8 bytes and the shares' 64 (not VERIFY_PRE);
#:   ASSERT_ZERO (not VERIFY_PRE): the sum 16 (+ rez 16), the test 2, the
#:     shares' 64 bytes;
#:   B2A_CORR: 64 bits x (a byte extract, its parity's POPC, placing and
#:     merging the bit 2) = 256, the tape's sum 14, the correction 2, its 8
#:     bytes (the correction is read in VERIFY_ONL: its 8 bytes);
#:   B2A_OUT: 64 bits x (mask and corr byte 2, POPC, XOR, placing and
#:     merging 2 = 6; + re2's XOR in VERIFY_ONL; the corr byte and its
#:     placing 3 in VERIFY_PRE), the mask's negation 16, the corr 2.
#: NOP slots count nothing.
WAVE_Z64_INT_OPS = {
    0: {0: 24, 1: 18, 9: 18, 2: 2, 3: 2, 4: 27, 8: 0, 7: 0, 5: 236, 6: 82, 10: 280, 11: 402},
    1: {0: 8, 1: 18, 9: 18, 2: 2, 3: 2, 4: 27, 8: 0, 7: 0, 5: 205, 6: 98, 10: 8, 11: 466},
    2: {0: 0, 1: 18, 9: 18, 2: 2, 3: 2, 4: 27, 8: 0, 7: 0, 5: 156, 6: 0, 10: 280, 11: 210},
}


def wave_z64_work(zops: np.ndarray, n_b2a: int, mode: int, R: int, input_bytes: int,
                  n_onlz: int, n_prez: int) -> Tuple[int, int]:
    """(bytes, integer instructions) of the z64 half of one W2 call over R
    lanes (the GF(2) half is wave_gf2_work's): the z64 table once (16 int32
    a slot, `zops` its opcode column) and the bits table (64 int32 a B2A),
    and per lane the z64 inputs read once (`input_bytes`: tapez's 64 B a
    row, witz, inz and coz 8 B, rez 64 B) and the onlz (not VERIFY_PRE) and
    prez rows written once.  The z64 arena is scratch, not counted."""
    kinds, counts = np.unique(np.asarray(zops), return_counts=True)
    per_lane = sum(WAVE_Z64_INT_OPS[mode].get(int(k), 0) * int(c) for k, c in zip(kinds, counts))
    lane_bytes = input_bytes + (n_onlz if mode != 2 else 0) + n_prez
    return np.asarray(zops).size * 16 * 4 + n_b2a * 64 * 4 + lane_bytes * R, per_lane * R


def int32_ops_per_s(sm_clock_mhz: float) -> float:
    return SMS * ISSUE_LANES_PER_SM * sm_clock_mhz * 1e6


def bound_ms(n_bytes: float, int_ops: float, sm_clock_mhz: float) -> Tuple[float, str]:
    """(least time in ms, "bytes" or "operations", whichever sets it)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = int_ops / int32_ops_per_s(sm_clock_mhz) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
