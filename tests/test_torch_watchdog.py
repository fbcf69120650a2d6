"""The port's utilities: the StepWatchdog on the cases of
tests/test_watchdog.py with sub-second intervals — it fires on silence,
stays quiet under a live heartbeat, honours the first-interval grace, and is
inert at timeout 0 — and the profiling helpers.
"""

import time

import pytest

from _watchdog_clock import install
from coulombgas_tpu_torch.utils import watchdog
from coulombgas_tpu_torch.utils.watchdog import HANG_EXIT_CODE, StepWatchdog


@pytest.fixture
def clock(monkeypatch):
    """The watchdog reads a clock that only the test moves."""
    return install(monkeypatch, watchdog)


def _make(timeout, **kw):
    fired = []
    wd = StepWatchdog(timeout, exit_fn=fired.append, poll_s=0.02, **kw)
    return wd, fired


def test_fires_on_silence(clock):
    wd, fired = _make(0.15, first_grace=1.0)
    wd.start()
    clock.advance(0.5, wd)
    wd.stop()
    assert fired == [HANG_EXIT_CODE] and HANG_EXIT_CODE == 42


def test_quiet_under_heartbeat_then_fires(clock):
    wd, fired = _make(0.2, first_grace=1.0)
    wd.start()
    for _ in range(10):
        clock.advance(0.05, wd)
        wd.beat()
    assert fired == []
    clock.advance(0.6, wd)
    wd.stop()
    assert fired == [HANG_EXIT_CODE]


def test_first_interval_grace_covers_the_kernel_builds(clock):
    wd, fired = _make(0.1, first_grace=10.0)
    wd.start()
    clock.advance(0.35, wd)      # > timeout, < timeout * grace
    assert fired == []
    wd.beat()                    # the grace collapses to 1x after the first beat
    clock.advance(0.4, wd)
    wd.stop()
    assert fired == [HANG_EXIT_CODE]


def test_disabled_at_zero_timeout():
    wd, fired = _make(0.0)
    wd.start()
    assert wd._thread is None
    time.sleep(0.1)
    assert fired == []


def test_stop_prevents_firing(clock):
    wd, fired = _make(0.15, first_grace=1.0)
    wd.start()
    wd.stop()
    wd._thread.join(10)
    clock.advance(0.4, wd)
    assert fired == []


def test_profiling_trace_annotate_and_step_timer(tmp_path):
    """The profiling helpers on the CPU: a named region shows in the trace's
    averages and in the Chrome trace; the step timer drops its warmup."""
    import os

    import torch

    from coulombgas_tpu_torch.utils.profiling import StepTimer, annotate, trace

    with trace(str(tmp_path), "cpu") as prof:
        with annotate("cg_region"):
            torch.ones(64).cumsum(0)
    assert any(e.key == "cg_region" for e in prof.key_averages())
    assert "cg_region" in open(os.path.join(tmp_path, "trace.json")).read()
    timer = StepTimer("cpu", warmup=1)
    for _ in range(3):
        with timer.step():
            time.sleep(0.01)
    s = timer.summary()
    assert s["steps"] == 2 and 0.01 <= s["min_s"] <= s["mean_s"] <= s["max_s"]
    assert StepTimer().summary() == {"steps": 0}
