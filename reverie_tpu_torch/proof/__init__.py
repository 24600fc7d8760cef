from .challenge import challenge_to_opening
from .container import OpenOnline, OpenPreprocessing, Proof, ProofSingle

__all__ = [
    "challenge_to_opening",
    "OpenOnline",
    "OpenPreprocessing",
    "Proof",
    "ProofSingle",
]
