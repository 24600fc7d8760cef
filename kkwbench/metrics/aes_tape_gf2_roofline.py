"""aes_tape_gf2_roofline.prove / .verify: K1, the GF(2) mask tape kernel
(aes_tape_gf2_kernel, csrc/aes_tape.cu), against its bound: one launch a
leg of m2 shares a player at the leg's lanes R, reading each player's
round keys and the omits and writing the (m2, R) tape once, one AES block
a 128 shares of each live key (the online verifier's omitted player needs
none).  As chip_smoke.py's check_tape counts it."""

from kkwbench.driver import VERIFY_ONL
from kkwbench.metrics._roofline import legs, share
from kkwbench.peaks import AES_BLOCK_INT_OPS

KERNEL = "aes_tape_gf2_kernel"
ROUND_KEY_BYTES = 176  # AES-128: 11 round keys a player key


def work(m2: int, R: int, live_keys: int):
    """(bytes, integer instructions) of one launch."""
    return m2 * R + R * 8 * ROUND_KEY_BYTES + R, -(-m2 // 128) * live_keys * AES_BLOCK_INT_OPS


def read(window, part):
    m2 = window.shape.m2
    return share(window, KERNEL, [work(m2, R, (7 if role == VERIFY_ONL else 8) * R)
                                  for role, R in legs(window, part)])
