"""Milliseconds of an epoch's apply (the optimizer step or the SR solve)."""


def read(run):
    t = run.mean_span("apply")
    return None if t is None else 1e3 * t
