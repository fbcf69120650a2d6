"""Whole runs of the harness on the CPU at a size a test can hold (n 13,
16 walkers a round, float64): the look for a chip is skipped, the rest of a
run is driven, and the reference's check passes; then, with the timed path
broken underneath, ``correct`` comes out false for each fault a cell can
have on one rank."""

import argparse
import time

import pytest
import torch

import harness
import runner
from _cpu_cell import cpu_cell

ONE_CARD = [w["name"] for w in harness.benchmark()["workloads"] if w["chips"] == 1]


def _run(cell, seed=2**31 + 7, trace=0):
    torch.set_num_threads(2)
    args = argparse.Namespace(workload=cell.name, seed=seed, seconds=0.01, trace=trace)
    result, lines = runner.run(args, 0, 1, 0, time.time(), cell=cell)
    return result, lines


@pytest.mark.parametrize("name", ONE_CARD)
def test_sound_run_is_correct(name):
    result, lines = _run(cpu_cell(name))
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    for k, v in result["checks"].items():
        assert v["value"] < 1e-8, (k, v)
    assert {"epoch_s", "setup_s"} <= set(result["metrics"])


def test_traced_run_reads_spans():
    result, _ = _run(cpu_cell("n29.sr_hutchinson"), trace=1)
    assert result["correct"]
    assert {"sample.ms", "accumulate.ms", "apply.ms", "driver.self_ms", "step.mfu"} <= set(
        result["metrics"])
    assert "epoch_s" not in result["metrics"]


def _patched(monkeypatch, fault):
    """Plant ``fault`` in the program under every Driver built from now on."""
    init = harness.Driver.__init__

    def broken(self, *a, **kw):
        init(self, *a, **kw)
        tr, main = self.tr, self.main
        if fault == "state_unchanged":
            apply = main.apply_step

            def apply_step(tr, acc, *rest):
                keep = main.snapshot_state(tr)
                out = apply(tr, acc, *rest)
                tr.van.load_state_dict(keep[0])
                tr.flow.load_state_dict(keep[1])
                return out

            monkeypatch.setattr(main, "apply_step", apply_step)
        elif fault == "half_batch":
            accumulate = tr.accumulate

            def half(van, flow, states, x, gen, acc, v=None):
                h = x.shape[0] // 2
                states = torch.cat([states[:h], states[:h]])
                x = torch.cat([x[:h], x[:h]])
                v = None if v is None else torch.cat([v[:h], v[:h]])
                return accumulate(van, flow, states, x, gen, acc, v)

            tr.accumulate = half
        elif fault == "answer_altered":
            accumulate = tr.accumulate

            def altered(*a, **kw):
                acc = accumulate(*a, **kw)
                acc["data"]["E_mean"] += 1e-3 * acc["data"]["E_mean"].abs()
                return acc

            tr.accumulate = altered

    monkeypatch.setattr(harness.Driver, "__init__", broken)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("name", ["n29.exact", "n29.sr_hutchinson"])
def test_fault_is_not_correct(monkeypatch, name, fault):
    _patched(monkeypatch, fault)
    result, lines = _run(cpu_cell(name))
    assert not result["correct"], lines
