"""host_wait_ms_per_proof.prove / .verify: host milliseconds a proof spent
blocked on the device's pulls: the sum of every PhaseTimer row's wait_ms
(its "wait" children, each blocking wait on a device -> host pull) over
the window's calls.  Where it is large, the device sets the pace."""

from kkwbench.metrics._spans import per_proof


def read(window, part):
    return per_proof(window, part, lambda phase, row: row["wait_ms"])
