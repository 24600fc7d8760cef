"""Fiat-Shamir challenge derivation (reference src/proof/mod.rs:68-100).

The port's copy of reverie_tpu/proof/challenge.py (`challenge_to_opening`).
Replicates the reference exactly, including its quirks: `u128 LE % bound`
sampling (negligible modulo bias) and HashMap overwrite-on-duplicate
semantics during drawing.
"""

from __future__ import annotations

from typing import Dict

from ..crypto import RandomOracle
from ..params import ProtocolParams

CTX_CHALLENGE = "random-oracle challenge"


def _random_int(ro: RandomOracle, bound: int) -> int:
    return int.from_bytes(ro.fill(16), "little") % bound


def challenge_to_opening(comm: bytes, params: ProtocolParams) -> Dict[int, int]:
    """comm -> {rep_index: omitted_player}; re-drawing an existing rep
    overwrites its omit player (proof/mod.rs:74-83)."""
    ro = RandomOracle(CTX_CHALLENGE, comm)
    online: Dict[int, int] = {}
    while len(online) < params.online_reps:
        rep = _random_int(ro, params.total_reps)
        omit = _random_int(ro, params.players)
        online[rep] = omit
    return online
