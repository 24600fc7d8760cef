"""Protocol parameters for the KKW MPC-in-the-head proof system.

The port's copy of reverie_tpu/params.py.  The reference hard-codes these
as compile-time constants (reference src/lib.rs:17-38); they are exposed as
a frozen config (`ProtocolParams`) whose defaults are the reference values,
so that proofs are format- and byte-compatible.

Security target: 128-bit classical (reference README.md:10).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ProtocolParams:
    """KKW protocol parameters.

    Attributes mirror the reference constants:
      players      -- MPC players per repetition          (lib.rs:17, PLAYERS = 8)
      packed       -- repetitions packed per share word   (lib.rs:20, PACKED = 8)
      batch_size   -- shares produced per PRG batch refill(lib.rs:25, BATCH_SIZE = 128)
      online_reps  -- repetitions with opened online phase(lib.rs:29, ONLINE_REPS = 40)
      total_reps   -- total repetitions                   (lib.rs:33, TOTAL_REPS = 256)
    """

    players: int = 8
    packed: int = 8
    batch_size: int = 128
    online_reps: int = 40
    total_reps: int = 256

    def __post_init__(self) -> None:
        if self.total_reps % self.packed != 0:
            raise ValueError("total_reps must be divisible by packed")
        if self.players != 8 or self.packed != 8:
            # The packed bit layouts (8 reps x 8 players per u64) assume 8/8.
            raise ValueError("only players=8, packed=8 supported (bit-packed layouts)")
        if self.online_reps > self.total_reps:
            raise ValueError("online_reps must be <= total_reps")

    @property
    def preprocessing_reps(self) -> int:
        # lib.rs:36
        return self.total_reps - self.online_reps

    @property
    def packed_reps(self) -> int:
        # lib.rs:38 -- number of packed execution groups
        return self.total_reps // self.packed


#: Default parameters -- byte-compatible with the reference build.
DEFAULT_PARAMS = ProtocolParams()

# Convenience module-level constants (mirroring reference naming).
PLAYERS = DEFAULT_PARAMS.players
PACKED = DEFAULT_PARAMS.packed
BATCH_SIZE = DEFAULT_PARAMS.batch_size
ONLINE_REPS = DEFAULT_PARAMS.online_reps
TOTAL_REPS = DEFAULT_PARAMS.total_reps
PREPROCESSING_REPS = DEFAULT_PARAMS.preprocessing_reps
PACKED_REPS = DEFAULT_PARAMS.packed_reps

KEY_SIZE = 16  # AES-128 key bytes (crypto/prg.rs:9)
HASH_SIZE = 32  # blake3 output bytes (crypto/hash.rs:8)
