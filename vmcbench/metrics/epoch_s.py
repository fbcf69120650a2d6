"""Seconds an epoch: the window's wall time over the whole epochs it ran."""


def read(run):
    return run.window_s / run.epochs if run.epochs and not run.trace else None
