"""Profiling and step timing on the GPU.

Counterpart of ``coulombgas_tpu/utils/profiling.py``:

  * ``trace(logdir)`` — context manager around ``torch.profiler`` over the
    CPU and (where there is one) the CUDA device, writing a Chrome trace
    into ``logdir`` (none with ``logdir=None``); the profile object is
    yielded, so ``key_averages()`` gives the time by kernel name;
  * ``annotate(name)`` — a named region (``torch.profiler.record_function``)
    so that sample / accumulate / apply are told apart in the trace;
  * ``StepTimer`` — wall-clock step timing that synchronizes the device it
    times, with warmup discard and summary statistics.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch

__all__ = ["trace", "annotate", "StepTimer"]


@contextlib.contextmanager
def trace(logdir: str | None, device=None):
    """Profile the enclosed block; the trace lands in ``logdir/trace.json``.

    ``device`` (default: CUDA if available) decides whether device activity
    is recorded besides the host's; the block's device work is waited for
    before the profile closes."""
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named region that shows up in profiler traces."""
    return torch.profiler.record_function(name)


@dataclass
class StepTimer:
    """Synchronized per-step timing: ``with timer.step(): ...``.

    The step ends with a synchronize of ``device`` (when it is a CUDA
    device), so that asynchronous launches do not hide device time.
    ``summary()`` reports mean/min/max over post-warmup steps.
    """

    device: torch.device | str | None = None
    warmup: int = 2
    times: list = field(default_factory=list)
    _count: int = 0

    def _sync(self):
        dev = torch.device(self.device) if self.device is not None else None
        if dev is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)

    @contextlib.contextmanager
    def step(self):
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        dt = time.perf_counter() - t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)

    def summary(self):
        if not self.times:
            return {"steps": 0}
        ts = self.times
        return {
            "steps": len(ts),
            "mean_s": sum(ts) / len(ts),
            "min_s": min(ts),
            "max_s": max(ts),
        }
