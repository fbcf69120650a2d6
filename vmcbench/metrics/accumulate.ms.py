"""Milliseconds of one accumulate (observables, gradients, scores), with the
synchronize that ends it."""


def read(run):
    t = run.mean_span("accumulate")
    return None if t is None else 1e3 * t
