"""The n 57 cell's configuration and its two readers: ``fisher.roofline``
on a hand-made device trace, ``apply.solve_ms`` on a hand-made registry,
each reading the expected value, and nothing where the float64 GEMMs or
the span are absent."""

import json
import os

import pytest

import devtrace
import harness
import metrics
from coulombgas_tpu_torch.ops import counters

CELL = "n57.production_b512"
F64 = "sm90_xmma_gemm_f64f64_f64f64_f64_nt_n_tilesize64x64x16_stage4"
F32 = "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x32x8_stage3"


def _run(kernels, rounds=16):
    """A traced run of the cell whose accumulate phase holds ``rounds``
    ranges of 10 ms and whose kernels are ``kernels`` (name, start ns,
    end ns)."""
    phases = {"accumulate": [(i * 10**7, (i + 1) * 10**7) for i in range(rounds)]}
    trace = devtrace.Trace(kernels, phases, (0, rounds * 10**7), [])
    return metrics.Run(cell=harness.Cell(CELL), trace=True, window_s=30.0, epochs=10,
                       setup_s=60.0, peak_bytes=1.0, spans=[], profile=trace, world=1)


def test_n57_config_entry_keeps_the_contract():
    bench = harness.benchmark()
    entry = next(c for c in bench["configs"] if c["name"] == "n57")
    assert entry["reduced"] == ["num_devices"]
    cfg = harness.load_json(os.path.join(harness.ROOT, entry["file"]))
    assert cfg["name"] == "n57" and cfg["source"] == entry["source"]
    assert cfg["published_layout"]["num_devices"] == 8
    # every width as published; only the layout is cut
    assert (cfg["nlayers"], cfg["modelsize"], cfg["nheads"], cfg["nhidden"]) == (2, 16, 4, 32)
    assert (cfg["depth"], cfg["spsize"], cfg["tpsize"]) == (2, 16, 16)
    cell = harness.Cell(CELL)
    assert cell.chips == 1 and cell.mix["batch"] * cell.mix["acc_steps"] == 8192
    assert (cell.mix["batch"], cell.mix["acc_steps"]) == (
        cfg["published_layout"]["batch"], cfg["published_layout"]["acc_steps"])
    assert {m["name"] for m in cell.per_layer} >= {"fisher.roofline", "apply.solve_ms"}
    others = [harness.Cell(w["name"]) for w in bench["workloads"] if w["name"] != CELL]
    assert all({"fisher.roofline", "apply.solve_ms"}.isdisjoint(m["name"] for m in c.per_layer)
               for c in others)


def test_fisher_roofline_reads_the_f64_gemms_of_the_accumulate():
    read = metrics.reader("fisher.roofline")
    # two f64 GEMMs a round, 0.5 ms and 0.25 ms; an f32 GEMM and an f64 GEMM
    # outside the accumulate that do not count
    kernels = []
    for i in range(16):
        t = i * 10**7 + 10**6
        kernels += [(F64, t, t + 500_000), (F64, t + 600_000, t + 850_000),
                    (F32, t + 900_000, t + 9_000_000)]
    kernels.append((F64, 16 * 10**7 + 10, 16 * 10**7 + 10**7))
    module = _reader_module("fisher.roofline")
    bound = module.gram_bound_s(512, 7050, 1074)
    flops = 512 * 7050 * 7051 + 2 * 512 * 1074 * 1075
    assert bound == pytest.approx(flops / 67e12)
    assert read(_run(kernels)) == pytest.approx(100 * bound / 0.75e-3)


def test_fisher_roofline_reads_nothing_without_f64_gemms():
    read = metrics.reader("fisher.roofline")
    assert read(_run([(F32, 10, 20)])) is None
    assert read(_run([(F64, 10, 20)], rounds=0)) is None
    run = _run([(F64, 10, 20)])
    run.profile = None
    assert read(run) is None


def test_apply_solve_ms_reads_the_registry(monkeypatch):
    read = metrics.reader("apply.solve_ms")
    monkeypatch.setattr(counters, "spans", {"sr.solve": {"seconds": 0.25, "calls": 10}},
                        raising=False)
    assert read(_run([])) == pytest.approx(25.0)
    monkeypatch.setattr(counters, "spans", {}, raising=False)
    assert read(_run([])) is None
    monkeypatch.delattr(counters, "spans", raising=False)  # a program that keeps no spans
    assert read(_run([])) is None


def _reader_module(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "vmcbench_test_" + name.replace(".", "_"), os.path.join(metrics.HERE, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_limits_name_compared_numbers():
    limits = json.load(open(os.path.join(harness.HERE, "limits", CELL + ".json")))
    assert {"logp", "grad", "fisher"} <= set(limits) and limits.keys() & {"obs", "obs1"}
