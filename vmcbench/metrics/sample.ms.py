"""Milliseconds of one sample step (VAN draw and Metropolis sweeps), with
the synchronize that ends it."""


def read(run):
    t = run.mean_span("sample")
    return None if t is None else 1e3 * t
