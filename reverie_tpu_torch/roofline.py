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


def int32_ops_per_s(sm_clock_mhz: float) -> float:
    return SMS * INT32_LANES_PER_SM * sm_clock_mhz * 1e6


def bound_ms(n_bytes: float, int_ops: float, sm_clock_mhz: float) -> Tuple[float, str]:
    """(least time in ms, "bytes" or "operations", whichever sets it)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = int_ops / int32_ops_per_s(sm_clock_mhz) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
