"""Peak device memory of the window, GiB (max_memory_allocated, reset at the
window's start; the largest rank's)."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
