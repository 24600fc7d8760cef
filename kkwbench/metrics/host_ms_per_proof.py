"""host_ms_per_proof.prove / .verify: host milliseconds a proof of the
port's per-proof host phases (PhaseTimer host_ms): seed expansion, the
Fiat-Shamir challenge and the opened reps' pull and proof assembly in a
prove; the online injection and the commitment's check in a verify.  A
phase's host time includes its blocking waits on pulls."""

from kkwbench.metrics._phases import total

PHASES = {"prove": ("expand_seeds", "challenge", "extract_pull"),
          "verify": ("onl_inject", "finish")}


def read(window, part):
    if part != window.kind or not window.done:
        return None
    ms = total(window, PHASES[part], "host_ms")
    return None if ms is None else ms / window.done
