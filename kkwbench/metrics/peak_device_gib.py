"""peak_device_gib.prove / .verify: torch.cuda.max_memory_allocated over the
window, in GiB: the memory that sets the largest batch or chunk that fits."""


def read(window, part):
    if part != window.kind or window.peak_bytes is None:
        return None
    return window.peak_bytes / (1 << 30)
