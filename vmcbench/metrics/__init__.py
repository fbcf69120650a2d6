"""The metrics' readers, one file each, found by the metric's name:
``metrics/<name>.py`` defines ``read(run)``, which returns the metric's
value from what the run measured, or None where it finds nothing to read
(the metric is then left out of the result's line)."""

from __future__ import annotations

import importlib.util
import os
import statistics
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass
class Run:
    """What one run measured, as the readers see it."""

    cell: object          # harness.Cell
    trace: bool           # a --trace 1 run
    window_s: float       # the timed window's seconds
    epochs: int           # epochs completed in it (and the traced one)
    setup_s: float        # process start to the first timed epoch
    peak_bytes: float     # max_memory_allocated over the window, largest rank
    spans: list           # per epoch of the window: {"wall": s, phase: [s, ...]}
    profile: object       # devtrace.Trace of the traced epoch, or None
    world: int            # ranks

    def mean_span(self, phase: str):
        """Mean seconds of one call of ``phase`` over the window's epochs."""
        calls = [t for e in self.spans for t in e.get(phase, [])]
        return statistics.fmean(calls) if calls else None

    def epoch_s(self):
        """Mean wall seconds of the window's epochs."""
        walls = [e["wall"] for e in self.spans if "wall" in e]
        return statistics.fmean(walls) if walls else None


def reader(name: str):
    path = os.path.join(HERE, name + ".py")
    spec = importlib.util.spec_from_file_location("vmcbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_all(metrics: list, run: Run) -> dict:
    """{name: {"value", "unit"}} of every metric whose reader finds a value."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
