"""host_busy_ms_per_proof.prove / .verify: host milliseconds a proof of
the port's own work around the device: the sum of every PhaseTimer row's
host_ms less its wait_ms over the window's calls (launches, host C and
numpy, the Python around them, and host -> device copies from pageable
memory, which block).  Where it is near the time a proof takes, the host
sets the pace."""

from kkwbench.metrics._spans import per_proof


def read(window, part):
    return per_proof(window, part, lambda phase, row: row["host_ms"] - row["wait_ms"])
