"""Milliseconds of an epoch's reduction of the accumulators over the ranks
(rank 0's span); nothing to read with one rank."""


def read(run):
    t = run.mean_span("reduce")
    return None if t is None or run.world == 1 else 1e3 * t
