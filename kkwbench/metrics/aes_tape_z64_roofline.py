"""aes_tape_z64_roofline.prove / .verify: K4, the Z_2^64 mask tape kernel
(aes_tape_z64_kernel, csrc/aes_tape_z64.cu), against its bound: one launch
a leg of mz words a player at the leg's lanes R (mz from the tape rows'
counter z64_tape_shares), reading each player's round keys and the omits
and writing the (mz, 8, R) int64 tape once, one AES block a 2 words of
each live key (the online verifier's omitted player needs none).  The
PhaseTimer rows of a program without the counter read nothing."""

from kkwbench.driver import VERIFY_ONL
from kkwbench.metrics._counters import counter
from kkwbench.metrics._roofline import legs, share
from kkwbench.peaks import AES_BLOCK_INT_OPS

KERNEL = "aes_tape_z64_kernel"
ROUND_KEY_BYTES = 176  # AES-128: 11 round keys a player key
PHASES = ("tape_z64", "onl_tape", "pre_tape")


def work(mz: int, R: int, live_keys: int):
    """(bytes, integer instructions) of one launch."""
    return mz * 64 * R + R * 8 * ROUND_KEY_BYTES + R, -(-mz // 2) * live_keys * AES_BLOCK_INT_OPS


def read(window, part):
    mz = counter(window, PHASES, "z64_tape_shares")
    if not mz:
        return None
    return share(window, KERNEL, [work(mz, R, (7 if role == VERIFY_ONL else 8) * R)
                                  for role, R in legs(window, part)])
