"""The least time an H100 could take for a kernel's work (its bound).

bound = max(bytes / memory rate, integer operations / INT32 rate), where
  * bytes are what the function must move: each input read once, each
    output written once;
  * the memory rate is the H100 SXM's 3.35 TB/s of HBM3 (NVIDIA data
    sheet);
  * the INT32 rate is 132 SMs x 64 INT32 lanes x the SM clock, which the
    caller reads from `nvidia-smi --query-gpu=clocks.max.sm`.

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
INT32_LANES_PER_SM = 64

#: integer instructions of one AES-128 CTR block in the T-table form
#: (csrc/aes_core.cuh): the counter into the state (2 XORs); 9 rounds x 4
#: column words x (4 byte extracts + 2 LOP3 for the 5-way XOR of 4 table
#: words and the round key) = 216; the last round the same with S-box
#: tables whose bytes sit in place (4 x 6 = 24).  The 160 table lookups are
#: shared-memory loads.
AES_BLOCK_INT_OPS = 2 + 9 * 4 * (4 + 2) + 4 * (4 + 2)

#: integer instructions of one BLAKE3 compression of a chunk read as in
#: csrc/blake3_chunks.cu: 7 rounds x 8 G x 12 (2 IADD3, 2 adds, 4 XORs, 4
#: rotations) = 672, the 8 output XORs, and 16 message words x 2 PRMT (a
#: 4 x 4 byte transpose of 4 rows' words).
BLAKE3_COMPRESSION_INT_OPS = 7 * 8 * 12 + 8 + 16 * 2


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


def int32_ops_per_s(sm_clock_mhz: float) -> float:
    return SMS * INT32_LANES_PER_SM * sm_clock_mhz * 1e6


def bound_ms(n_bytes: float, int_ops: float, sm_clock_mhz: float) -> Tuple[float, str]:
    """(least time in ms, "bytes" or "operations", whichever sets it)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = int_ops / int32_ops_per_s(sm_clock_mhz) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
