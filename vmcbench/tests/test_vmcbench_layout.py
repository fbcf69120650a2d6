"""The benchmark's files: every cell, configuration, traffic mix, metric
reader and limit found by its name; the contract's shape of BENCHMARK.json;
no JAX anywhere; and a run without a card prints no result."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

import harness
import metrics

BENCH = harness.HERE
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "coulombgas_tpu"}
PROGRAM = {"coulombgas_tpu_torch", "main_torch"}


def bench():
    return harness.benchmark()


@pytest.mark.parametrize("name", [w["name"] for w in harness.benchmark()["workloads"]])
def test_cell_found_by_name(name):
    cell = harness.Cell(name)
    assert cell.cfg["name"] == cell.entry["config"]
    assert os.path.isfile(os.path.join(harness.ROOT, cell.cfg["van_file"]))
    assert {"logp", "grad"} <= set(cell.limits) and cell.limits.keys() & {"obs", "obs1"}
    for m in cell.end_to_end + cell.per_layer:
        assert callable(metrics.reader(m["name"]))
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "epoch_s"}
    argv = cell.argv()
    assert argv[argv.index("--batch") + 1] == str(cell.mix["batch"])


def test_benchmark_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["vmcbench"] and b["command"][1].startswith("vmcbench/")
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]]
    assert len(set(names)) == len(names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("vmcbench/") and os.path.isfile(
            os.path.join(harness.ROOT, c["file"]))
    cells = b["workloads"]
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names and len(w["why"]) <= 200
        assert os.path.isfile(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in (
            "lower", "higher")
    layers = {}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        layers.setdefault(m["layer"], m["layer"])
    assert len(json.dumps(b)) < 64 * 1024


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_imported_anywhere():
    found = {(p, m) for p in _sources() for m in _imports(p) if m in FORBIDDEN}
    assert not found


def test_reference_imports_nothing_of_the_program():
    found = {(p, m) for p in _sources("reference") for m in _imports(p)
             if m in PROGRAM | FORBIDDEN}
    assert not found


def test_forbidden_names_are_compared_whole():
    import coulombgas_tpu_torch.train.train  # noqa: F401  (the port's name begins with the JAX package's)

    assert "coulombgas_tpu_torch" in sys.modules
    assert harness.forbidden_modules() == []


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                        "n29.exact", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=harness.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert not any(line.startswith("{") for line in r.stdout.splitlines())
