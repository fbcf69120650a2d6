"""The port's host-side periphery against the JAX package, on the CPU, f64.

Each module the port copied (``physics/orbitals.py``'s ``manybody_orbitals``
and ``closed_shells``, ``ops/native``, ``physics/specialpoints.py``,
``physics/ewald.py:ewald_sum_pairs``, ``analytic/tabc.py``,
``analytic/tabc_specialpoints.py``, ``io/import_reference.py``,
``analysis/{ewm,utils,plot}.py``, ``cluster/submit.py``) gets the same
inputs as its JAX counterpart and gives the same outputs, printed lines and
files.  Sizes are the JAX package's own tests' (``manybody_orbitals(5, 2,
4)``, n 3 with mpmath ``dps`` 60).  Last, no module of the port, nor
``main_torch.py`` or ``chip_smoke.py``, imports JAX or the JAX package.
"""

import ast
import os
import pickle
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import coulombgas_tpu as cg
from coulombgas_tpu.analysis import ewm as jax_ewm
from coulombgas_tpu.analysis import plot as jax_plot
from coulombgas_tpu.analysis import utils as jax_utils
from coulombgas_tpu.analytic import tabc as jax_tabc
from coulombgas_tpu.analytic import tabc_specialpoints as jax_tabc_sp
from coulombgas_tpu.cluster import submit as jax_submit
from coulombgas_tpu.io import import_reference as jax_import
from coulombgas_tpu.physics import ewald as jax_ewald
from coulombgas_tpu.physics import orbitals as jax_orbitals
from coulombgas_tpu.physics import specialpoints as jax_sp
from coulombgas_tpu_torch.analysis import ewm, plot, utils
from coulombgas_tpu_torch.analytic import tabc, tabc_specialpoints
from coulombgas_tpu_torch.cluster import submit
from coulombgas_tpu_torch.io import import_reference
from coulombgas_tpu_torch.models.transformer import Transformer, TransformerConfig
from coulombgas_tpu_torch.ops import _build
from coulombgas_tpu_torch.ops import native
from coulombgas_tpu_torch.physics import ewald, orbitals, specialpoints

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
RUN_NAME = ("n_5_dim_2_rs_2.0_Theta_0.15_Emax_4_twist_0.250_0.250_nlayers_2_modelsize_16_"
            "nheads_4_nhidden_32_depth_2_spsize_16_tpsize_16_Gmax_15_kappa_10_mctherm_1_"
            "mcsteps_3_mcstddev_0.10_hutchinson_damping_0.00100_maxnorm_0.00100_batch_16_"
            "ndevices_2_accsteps_2")


def _python_dfs(monkeypatch, tmp_path):
    """Make the port's loader find no library and no ``g++`` on PATH."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_no_compiler", False)
    monkeypatch.setattr(native, "_SO", str(tmp_path / "lib_manybody.so"))
    monkeypatch.setattr(native.shutil, "which", lambda name: None)


# ---- physics/orbitals.py, ops/native -----------------------------------

@pytest.mark.parametrize("n,dim,Ecut", [(5, 2, 4), (3, 2, 4), (4, 3, 3)])
def test_manybody_orbitals_match_the_jax_package(n, dim, Ecut):
    mb_i, mb_E = orbitals.manybody_orbitals(n, dim, Ecut)
    want_i, want_E = jax_orbitals.manybody_orbitals(n, dim, Ecut)
    np.testing.assert_array_equal(mb_E, want_E)
    np.testing.assert_array_equal(mb_i, want_i)


def test_manybody_orbitals_against_brute_force():
    import itertools

    n, dim, Ecut = 3, 2, 4
    _, Es = orbitals.sp_orbitals(dim)
    K = np.searchsorted(Es, Es[:n].sum() + Ecut, side="right")
    expected = sorted(Es[list(c)].sum() for c in itertools.combinations(range(K), n)
                      if Es[list(c)].sum() <= Es[:n].sum() + Ecut)
    mb_i, mb_E = orbitals.manybody_orbitals(n, dim, Ecut)
    assert mb_i.shape == (len(expected), n, dim)
    np.testing.assert_array_equal(mb_E, expected)


def test_native_builds_into_the_build_directory():
    assert native.native_available()
    assert os.path.dirname(native._SO) == _build.BUILD_DIR
    assert os.path.isfile(native._SO)
    here = os.path.dirname(native.__file__)
    assert not [f for f in os.listdir(here) if f.endswith(".so")]


def test_without_gxx_the_python_dfs_runs_and_says_so(monkeypatch, tmp_path, capsys):
    """No ``g++`` on PATH: one printed line, and the DFS gives the native
    enumeration's states (the same energies, the same set of states)."""
    mb_i, mb_E = orbitals.manybody_orbitals(5, 2, 4)
    _python_dfs(monkeypatch, tmp_path)
    capsys.readouterr()
    dfs_i, dfs_E = orbitals.manybody_orbitals(5, 2, 4)
    said = capsys.readouterr().out.splitlines()
    assert len(said) == 1 and "no g++ on PATH" in said[0]
    np.testing.assert_array_equal(dfs_E, mb_E)
    assert {tuple(map(tuple, s)) for s in dfs_i} == {tuple(map(tuple, s)) for s in mb_i}
    # the JAX package's DFS gives the same states
    _, jax_E = jax_orbitals.manybody_orbitals(5, 2, 4)
    np.testing.assert_array_equal(dfs_E, jax_E)
    assert not (tmp_path / "lib_manybody.so").exists()


def test_a_compiler_that_fails_raises(monkeypatch, tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_no_compiler", False)
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "_SO", str(tmp_path / "lib_manybody.so"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.enumerate_subsets(np.arange(5), 2, 3)


@pytest.mark.parametrize("dim,Emax", [(2, 25), (3, 9), (2, 60)])
def test_closed_shells_match_the_jax_package(dim, Emax):
    assert orbitals.closed_shells(dim, Emax) == jax_orbitals.closed_shells(dim, Emax)


# ---- physics/specialpoints.py ------------------------------------------

@pytest.mark.parametrize("dim,Nk", [(2, 1), (2, 2), (2, 3), (2, 4), (2, 5), (3, 2), (3, 3)])
def test_monkhorst_pack_matches_the_jax_package(dim, Nk):
    for name in ("Monkhorst_Pack", "monkhorst_pack_full"):
        twists, weights = getattr(specialpoints, name)(dim, Nk)
        want_t, want_w = getattr(jax_sp, name)(dim, Nk)
        assert weights == want_w
        np.testing.assert_array_equal(np.array(twists), np.array(want_t))


# ---- physics/ewald.py:ewald_sum_pairs ----------------------------------

@pytest.mark.parametrize("dim", [2, 3])
def test_ewald_pairs_match_the_structure_factor_and_the_jax_package(dim):
    x = np.random.default_rng(dim).uniform(size=(4, 9, dim))
    G = ewald.kpoints(dim, 12)
    pairs = ewald.ewald_sum_pairs(torch.from_numpy(x), 10.0, G)
    assert pairs.shape == (4,)
    np.testing.assert_allclose(pairs, ewald.ewald_sum(torch.from_numpy(x), 10.0, G), rtol=1e-12)
    want = jax.jit(jax.vmap(lambda xi: jax_ewald.ewald_sum_pairs(xi, 10.0, G)))(jnp.asarray(x))
    np.testing.assert_allclose(pairs, np.asarray(want), rtol=1e-12)


# ---- analytic/tabc.py, analytic/tabc_specialpoints.py ------------------

def test_tabc_writes_the_jax_packages_twists_file(tmp_path):
    """mpmath draws the twists from Python's ``random``: seeded alike, the
    two packages write the same ``twists.txt``, line for line, and resume
    it alike."""
    out = {}
    for name, fn in (("port", tabc.tabc), ("jax", jax_tabc.tabc)):
        folder = str(tmp_path / name)
        random.seed(11)
        first = fn(3, 2, 0.5, 4, Ntwists=3, folder=folder, dps=60)
        random.seed(12)
        resumed = fn(3, 2, 0.5, 4, Ntwists=5, Ntwists_finished=3, folder=folder, dps=60)
        path = os.path.join(folder, "n_3_dim_2_Theta_0.500000_Emax_4", "twists.txt")
        with open(path) as f:
            out[name] = (first, resumed, f.read().splitlines())
    assert len(out["port"][2]) == 6
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("Nk", [2, 3])
def test_tabc_specialpoints_writes_the_jax_packages_file(tmp_path, Nk):
    out = {}
    for name, fn in (("port", tabc_specialpoints.tabc_specialpoints),
                     ("jax", jax_tabc_sp.tabc_specialpoints)):
        folder = str(tmp_path / name)
        means = fn(3, 2, 0.5, 4, Nk=Nk, folder=folder, dps=60)
        path = os.path.join(folder, "n_3_dim_2_Theta_0.500000_Emax_4", "twists_Nk_%d.txt" % Nk)
        with open(path) as f:
            out[name] = (means, f.read().splitlines())
    assert out["port"] == out["jax"]


# ---- io/import_reference.py --------------------------------------------

def _synth_haiku(num_layers, D, H, M, dim, depth, sp, tp):
    rng = np.random.default_rng(0)
    lin = lambda i, o: {"w": rng.normal(0, 0.3, (i, o)), "b": rng.normal(0, 0.1, (o,))}  # noqa: E731
    van = {"transformer/embedding_mlp": lin(dim, D), "transformer/output_mlp": lin(D, M),
           "transformer": {"x1hat": rng.normal(0, 0.1, (M,))}}
    for i in range(num_layers):
        for part, shape in (("attn/query", (D, D)), ("attn/key", (D, D)),
                            ("attn/value", (D, D)), ("attn/linear", (D, D)),
                            ("mlp/linear", (D, H)), ("mlp/linear_1", (H, D))):
            kind, leaf = part.split("/")
            van["transformer/layer%d_%s/%s" % (i, kind, leaf)] = lin(*shape)
    flow = {"fermi_net/linear": lin(sp, dim)}
    seq = lambda i: "fermi_net/~/linear" + ("" if i == 0 else "_%d" % i)  # noqa: E731
    for i in range(depth):
        flow[seq(i)] = lin(2 * sp + tp if i else 2 * dim, sp)
    for j in range(depth - 1):
        flow[seq(depth + j)] = lin(tp if j else dim + 1, tp)
    return van, flow


def test_import_reference_gives_the_jax_packages_trees_and_van(tmp_path):
    num_layers, D, H, M, dim, n, depth = 2, 16, 32, 10, 2, 5, 2
    hk_van, hk_flow = _synth_haiku(num_layers, D, H, M, dim, depth, 6, 5)
    # a reference checkpoint: haiku dicts whose leaves are pickled jax.Arrays
    ckpt = {"params_van": jax.tree.map(jnp.asarray, hk_van),
            "params_flow": jax.tree.map(jnp.asarray, hk_flow),
            "x": jnp.zeros((2, 3, n, dim)), "keys": jnp.zeros((2, 2), jnp.uint32)}
    path = str(tmp_path / "epoch_000010.pkl")
    with open(path, "wb") as f:
        pickle.dump(ckpt, f)
    got = import_reference.load_reference_checkpoint(path, num_layers, depth, np.float64)
    want = jax_import.load_reference_checkpoint(path, num_layers, depth, np.float64)
    flat = lambda tree: jax.tree_util.tree_flatten_with_path(tree)[0]  # noqa: E731
    assert sorted(got) == sorted(want) == ["key", "params_flow", "params_van", "x"]
    for (pa, a), (pb, b) in zip(flat(got), flat(want)):
        assert pa == pb and type(a) is np.ndarray
        np.testing.assert_array_equal(a, b)
    assert got["x"].shape == (6, n, dim)
    # into the port's VAN: the JAX package's transformer_apply, in f64
    van = Transformer(TransformerConfig(M, num_layers, D, 4, H), dim, torch.float64)
    import_reference.load_reference_into(path, van, num_layers=num_layers, depth=depth,
                                         dtype=np.float64)
    x = np.linspace(-1.0, 1.0, n * dim).reshape(n, dim)
    with torch.no_grad():
        out = van(torch.from_numpy(x)[None])[0].numpy()  # batched (B, n, dim)
    cfg = cg.TransformerConfig(M, num_layers, D, 4, H)
    want_out = jax.jit(lambda p, q: cg.transformer_apply(p, cfg, q))(
        jax.tree.map(jnp.asarray, want["params_van"]), jnp.asarray(x))
    np.testing.assert_allclose(out, np.asarray(want_out), rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(out[0], hk_van["transformer"]["x1hat"])


def test_a_bare_pretrained_van_pickle(tmp_path):
    hk_van, _ = _synth_haiku(1, 8, 12, 6, 2, 2, 6, 5)
    path = str(tmp_path / "params_van.pkl")
    with open(path, "wb") as f:
        pickle.dump(jax.tree.map(jnp.asarray, hk_van), f)
    got = import_reference.load_reference_checkpoint(path, 1, dtype=np.float64)
    want = jax_import.load_reference_checkpoint(path, 1, dtype=np.float64)
    assert list(got) == list(want) == ["params_van"]
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


# ---- analysis/ --------------------------------------------------------

def test_running_average_matches_the_jax_package():
    data = np.random.default_rng(0).normal(size=50)
    for alpha in (0.01, 0.3):
        for a, b in zip(ewm.running_average(data, alpha), jax_ewm.running_average(data, alpha)):
            np.testing.assert_array_equal(a, b)


def test_parse_filename_and_natural_sort_match_the_jax_package():
    assert utils.parse_filename(RUN_NAME) == jax_utils.parse_filename(RUN_NAME)
    items = ["x10", "x2", "X1", "run_3_b", "run_21_a"]
    assert utils.natural_sort(items) == jax_utils.natural_sort(items)


def _runs_folder(tmp_path):
    rng = np.random.default_rng(1)
    for name in (RUN_NAME, RUN_NAME.replace("rs_2.0", "rs_10.0")):
        run = tmp_path / name
        run.mkdir()
        rows = np.column_stack([np.arange(1, 31), rng.normal(size=(30, 10)),
                                rng.uniform(0.4, 0.6, 30)])
        np.savetxt(run / "data.txt", rows)
    return tmp_path


def test_sweep_summary_and_the_cli_match_the_jax_package(tmp_path, capsys, monkeypatch):
    folder = str(_runs_folder(tmp_path))
    got, want = plot.sweep_summary(folder, 0.05), jax_plot.sweep_summary(folder, 0.05)
    assert got == want and len(got) == 2
    assert plot.collect_runs(folder) == jax_plot.collect_runs(folder)
    plot.main([folder, "--alpha", "0.05"])
    printed = capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["plot", folder, "--alpha", "0.05"])
    jax_plot.main()
    assert printed == capsys.readouterr().out and "rs" in printed


# ---- cluster/submit.py -------------------------------------------------

def test_slurm_script_runs_main_torch_with_the_production_arguments(tmp_path, monkeypatch,
                                                                   capsys):
    args = dict(n=29, Emax=25, batch=2048, acc_steps=4, epoch=3000, folder="./runs/")
    assert submit.production_args(**args) == jax_submit.production_args(**args)
    prog = "main_torch.py " + submit.production_args(**args)
    script = submit.slurm_script(prog, "h100", 8, "n29")
    assert script == jax_submit.slurm_script(prog, "h100", 8, "n29")
    assert "#SBATCH --gres=gpu:8" in script and "python main_torch.py --folder" in script
    assert not hasattr(submit, "tpu_pod_script")
    jobfile = tmp_path / "job.sh"
    jobfile.write_text(script)

    def refuse(*a, **k):
        raise AssertionError("dry_run called sbatch")

    monkeypatch.setattr(submit.subprocess, "run", refuse)
    assert submit.submitjob(str(jobfile), dry_run=True) is None
    assert capsys.readouterr().out == script + "\n"


def test_the_submit_cli_writes_a_main_torch_jobfile(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    submit.main(["--jobname", "n57", "--partition", "h100", "--ngpus", "4"])
    script = (tmp_path / "jobfile_n57.sh").read_text()
    assert "python main_torch.py --folder ./data/ --n 57" in script
    assert "#SBATCH --gres=gpu:4" in script and script in capsys.readouterr().out


# ---- no JAX in the port ------------------------------------------------

def _port_sources():
    pkg = os.path.join(REPO, "coulombgas_tpu_torch")
    files = [os.path.join(REPO, "main_torch.py"), os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(pkg):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    return files


def test_the_port_imports_neither_jax_nor_the_jax_package():
    def foreign(module):
        root = module.split(".")[0]
        return root in ("jax", "jaxlib", "optax", "haiku") or root == "coulombgas_tpu"

    found = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            found += ["%s:%d %s" % (os.path.relpath(path, REPO), node.lineno, m)
                      for m in names if foreign(m)]
    assert len(_port_sources()) > 40 and found == []
