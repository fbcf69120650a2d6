"""Milliseconds an epoch that the driver's own loop takes: the epoch's wall
time less the spans of its sample steps, accumulates, reduction and apply
(the tripwire's snapshot and check, the accumulators' set-up, the host's
reads of the observables)."""

import statistics


def read(run):
    own = [e["wall"] - sum(sum(e[p]) for p in ("sample", "accumulate", "reduce", "apply"))
           for e in run.spans if "wall" in e]
    return 1e3 * statistics.fmean(own) if own else None
