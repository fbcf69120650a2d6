"""Seconds from process start to the first timed epoch."""


def read(run):
    return run.setup_s
