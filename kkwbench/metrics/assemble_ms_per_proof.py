"""assemble_ms_per_proof.prove: host milliseconds a proof of turning the
pulled opened records into Proof objects: extract_pull's "gather" (the
buffer split, gathered in lane order and made bytes) and "assemble" (the
per-proof assemble_proof loop) children, over the window's calls."""

from kkwbench.metrics._spans import per_proof


def assembly_ms(phase, row) -> float:
    if phase != "extract_pull":
        return 0.0
    return sum(e - s for child, s, e in row["spans"] if child in ("gather", "assemble")) / 1e6


def read(window, part):
    return per_proof(window, part, assembly_ms)
