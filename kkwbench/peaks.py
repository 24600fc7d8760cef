"""The yardstick of the device metrics: one H100 SXM's peaks (NVIDIA's data
sheet) and the fewest operations and bytes of the port's kernels' work.

A bound is the least time the card could take for some work: the larger of
its bytes over the HBM rate and its 32-bit integer instructions over the
SMs' issue rate (132 SMs x 128 lanes x the SM clock, `clocks.max.sm`).
Frozen copies of reverie_tpu_torch.roofline's counts, with the same
reasons: operations are the fewest integer instructions in Hopper's forms
(a 3-input XOR one LOP3, `a + b + c` one IADD3, a rotation one funnel shift
or PRMT); table lookups, loads, stores and address arithmetic are not
counted, so a kernel issues at least these."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
SMS = 132
ISSUE_LANES_PER_SM = 128

#: one AES-128 block in the T-table form: the counter into the state (2), 9
#: rounds x 4 column words x (4 byte extracts + 2 LOP3), the last round's 4 x 6
AES_BLOCK_INT_OPS = 2 + 9 * 4 * (4 + 2) + 4 * (4 + 2)
#: one BLAKE3 compression of words in registers: 7 rounds x 8 G x 12, and 8 XORs
BLAKE3_NODE_INT_OPS = 7 * 8 * 12 + 8
#: one compression of a chunk's block read from its rows: the node's and 16
#: words x 2 PRMT (a 4 x 4 byte transpose of four rows' words)
BLAKE3_COMPRESSION_INT_OPS = BLAKE3_NODE_INT_OPS + 16 * 2


def bound_s(n_bytes: float, int_ops: float, sm_clock_mhz: float) -> float:
    """The least seconds the card could take for the work."""
    return max(n_bytes / HBM_BYTES_PER_S,
               int_ops / (SMS * ISSUE_LANES_PER_SM * sm_clock_mhz * 1e6))
