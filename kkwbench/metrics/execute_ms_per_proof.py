"""execute_ms_per_proof.prove / .verify: the executor's stream time a proof
(PhaseTimer device_ms of `execute`; a verify's `onl_exec` and `pre_exec`):
the CUDA events around the phase, so it holds any wait of the stream on the
host inside it, which the host enqueueing ahead keeps small."""

from kkwbench.metrics._phases import total

PHASES = {"prove": ("execute",), "verify": ("onl_exec", "pre_exec")}


def read(window, part):
    if part != window.kind or not window.done:
        return None
    ms = total(window, PHASES[part], "device_ms")
    return None if ms is None else ms / window.done
