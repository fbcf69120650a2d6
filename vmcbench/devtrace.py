"""The device trace of one epoch: ``torch.profiler`` over the epoch body,
reduced to the kernels' intervals, the phases' ranges and the epoch's range,
all on the profiler's clock.

``busy_s`` is the union of the device's operation intervals inside the
epoch, ``window_s`` the epoch's length; the idle share is one minus their
ratio.  The breakdown names the device operations with the most time and
the longest idle gaps by what the host was doing: the phase and the host
operation that ended the gap by launching the next device operation.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch


class Trace:
    def __init__(self, kernels, phases, window, host_ops):
        self.kernels = kernels        # [(name, start_ns, end_ns)], device operations
        self.phases = phases          # {phase: [(start_ns, end_ns)]}
        self.window = window          # (start_ns, end_ns) of the epoch
        self.host_ops = host_ops      # [(start_ns, name)], sorted
        self.busy_s, self.gaps = self._union()
        self.window_s = (window[1] - window[0]) / 1e9

    def _union(self):
        w0, w1 = self.window
        spans = sorted((max(s, w0), min(e, w1)) for _, s, e in self.kernels if e > w0 and s < w1)
        busy, gaps, cur = 0, [], w0
        for s, e in spans:
            if s > cur:
                gaps.append((cur, s))
            if e > cur:
                busy += e - max(s, cur)
                cur = e
        if cur < w1:
            gaps.append((cur, w1))
        return busy / 1e9, gaps

    def launches(self, phase: str) -> int:
        """Device kernels (not copies or fills) started inside ``phase``."""
        ranges = self.phases.get(phase, [])
        return sum(1 for name, s, _ in self.kernels if not _is_copy(name)
                   and any(a <= s <= b for a, b in ranges))

    def kernel_times(self, fragment: str) -> list:
        """Seconds of each launch of the kernels whose name holds ``fragment``."""
        return [(e - s) / 1e9 for name, s, e in self.kernels if fragment in name]

    def _phase_at(self, t):
        for p, ranges in self.phases.items():
            if any(a <= t <= b for a, b in ranges):
                return p
        return "driver"

    def breakdown(self, top: int = 10) -> dict:
        by_name = defaultdict(float)
        for name, s, e in self.kernels:
            by_name[name[:120]] += (e - s) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        starts = [t for t, _ in self.host_ops]
        by_host = defaultdict(float)
        for a, b in self.gaps:
            i = bisect.bisect_right(starts, b) - 1
            op = self.host_ops[i][1] if i >= 0 else "none"
            by_host["%s: %s" % (self._phase_at(a), op[:100])] += (b - a) / 1e9
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in idle]}


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def profile_epoch(drv, annotate: bool):
    """Run one epoch of ``drv`` under the profiler (only where ``annotate``;
    other ranks run it plainly) and reduce its trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    if not annotate:
        drv.run_epoch()
        return None
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    drv.tr.sync()
    with profile(activities=acts) as prof:
        with record_function("vmcbench.epoch"):
            drv.run_epoch(annotate=record_function)
        drv.tr.sync()
    kernels, phases, window, host = [], defaultdict(list), None, []
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.name().startswith("vmcbench."):
                kernels.append((e.name(), s, s + d))
            continue
        name = e.name()
        if name == "vmcbench.epoch":
            window = (s, s + d)
        elif name.startswith("vmcbench."):
            phases[name[len("vmcbench."):]].append((s, s + d))
        elif not e.is_user_annotation():
            host.append((s, name))
    host.sort()
    if window is None:
        return None
    return Trace(kernels, dict(phases), window, host)
