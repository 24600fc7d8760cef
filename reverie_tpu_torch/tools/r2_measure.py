"""The AES keystream rate apart from any tape packing, on the card.

    python -m reverie_tpu_torch.tools.r2_measure

Port of part A of reverie_tpu's tools/r2_measure.py: the raw keystream
planes kernel (`crypto/kernels/aes_planes.py`, CUDA `csrc/aes_planes.cu`,
the counterpart of the Pallas `aes_ctr_planes_pallas`) for the 2,048 player
keys of 256 repetitions (seeds from a fixed RandomState, expanded on the
host), at the tool's block counts B = 4,096 / 4,128 / 8,192 / 15,626.  Each
run's planes go through the tool's post-processing (`planes_to_tape`, its
`numpy_post` in torch) and must equal the port's GF(2) tape kernel
(`aes_tape.aes_ctr_tape_gf2`, no omit) at m2 = B * 128.  On a CUDA device
it also times the planes kernel and the tape kernel with CUDA events.

Part B of the tool (warm prove and verify phase timings of the 1M-AND
circuit) is `python -m reverie_tpu_torch.trace` in the port, and is not
repeated here.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..crypto import expand_seeds
from ..crypto.kernels import aes_planes, aes_tape
from ..device import default_device
from ._timing import cuda_ms, print_results

REPS = 256
BLOCKS = (4096, 4128, 8192, 15626)  # tools/r2_measure.py:76
SEED = 42  # the rep seeds' RandomState (tools/r2_measure.py:53)


def planes_to_tape(planes: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """The tool's post-processing (tools/r2_measure.py:37-47) in torch:
    (16, 8, Bp, Kw) int32 planes -> (B * 128, Kw * 4) uint8 tape, slot
    b*128 + by*8 + j holding bit (7 - j) of byte `by` with player p of a rep
    at bit (7 - p).  int32 `>>` is arithmetic, so each right shift is
    masked."""
    Kw = planes.shape[-1]
    p = planes.flip(1)[:, :, :n_blocks]  # bit 7 - j first
    words = p.permute(2, 0, 1, 3).reshape(n_blocks * 128, Kw)
    for mask, s in ((0x55555555, 1), (0x33333333, 2), (0x0F0F0F0F, 4)):
        words = ((words & mask) << s) | ((words >> s) & mask)
    return words.contiguous().view(torch.uint8).reshape(n_blocks * 128, Kw * 4)


def round_keys(device: torch.device, reps: int = REPS) -> torch.Tensor:
    """(reps * 8, 11, 16) round keys of the player keys expanded from
    `RandomState(SEED)` rep seeds (tools/r2_measure.py:53-56)."""
    seeds = np.random.RandomState(SEED).randint(0, 256, size=(reps, 16), dtype=np.uint8)
    return aes_tape.round_keys(expand_seeds(seeds), device)


def run(device: torch.device, blocks: Sequence[int] = BLOCKS, reps: int = REPS) -> List[Dict]:
    """For each B: planes -> tape equal to the GF(2) tape kernel's, and the
    two kernels' times (CUDA only)."""
    rk = round_keys(device, reps)
    rows = []
    for B in blocks:
        m2 = B * 128
        tape = planes_to_tape(aes_planes.aes_ctr_planes(rk, B), B)
        equal = bool(torch.equal(tape, aes_tape.aes_ctr_tape_gf2(rk, m2)))
        del tape
        rows.append({
            "probe": "r2_measure", "blocks": B, "keys": rk.shape[0],
            "aes_blocks": B * rk.shape[0], "planes_equal_gf2_tape": equal,
            "planes_ms": cuda_ms(lambda: aes_planes.aes_ctr_planes(rk, B), device),
            "tape_gf2_ms": cuda_ms(lambda: aes_tape.aes_ctr_tape_gf2(rk, m2), device),
        })
        if not equal:
            raise AssertionError(f"r2_measure B={B}: planes + post-processing differ "
                                 "from the GF(2) tape")
    return rows


def main() -> int:
    print_results(run(default_device()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
