"""device_idle_share.prove / .verify: the share of the traced window, from
the first timed call's start to the last one's end, in which nothing ran on
the card: 100 x (1 - busy / window), busy the union of the kernel, copy and
set intervals of the profiler's trace."""


def read(window, part):
    tr = window.trace
    if part != window.kind or tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
