"""``main_torch.py --sr`` on the CPU at a tiny size, with a VAN written by the
test where the pretraining would have put it: the run directory is named by
``main.py``'s rule (``_damping_..._maxnorm_...`` in the place of ``_lr_...``),
``data.txt`` and ``sr_diag.txt`` get their rows, a checkpoint resumes, and the
flags of the depth-2 closure kernels fail with one line where they cannot be
met.
"""

import os

import numpy as np
import pytest
import torch

import main_torch
from coulombgas_tpu_torch.io.checkpoint import load_data, pretrained_model_filename, save_data
from coulombgas_tpu_torch.io.convert import van_to_numpy
from coulombgas_tpu_torch.models.transformer import TransformerConfig, init_transformer_params
from coulombgas_tpu_torch.physics.orbitals import sp_orbitals

N, EMAX = 5, 4
TINY = ["--cpu", "--hutchinson", "--n", str(N), "--Emax", str(EMAX), "--nlayers", "1",
        "--modelsize", "4", "--nheads", "2", "--nhidden", "6", "--spsize", "4", "--tpsize", "4",
        "--Gmax", "4", "--kappa", "5", "--batch", "6", "--mc_therm", "1", "--mc_steps", "2",
        "--acc_steps", "2", "--ckpt_every", "2"]


def _args(tmp_path, *extra):
    """Parsed arguments, with a seeded tiny VAN saved where main_torch looks for it."""
    args = main_torch.parse_args(TINY + ["--folder", str(tmp_path) + os.sep] + list(extra))
    pre = main_torch.freefermion_path(args, np.array(args.twist))
    os.makedirs(pre, exist_ok=True)
    num_states = sp_orbitals(args.dim, args.Emax)[1].size
    van = init_transformer_params(TransformerConfig(num_states, 1, 4, 2, 6), args.dim,
                                  torch.Generator().manual_seed(3), torch.float64, "cpu")
    save_data(van_to_numpy(van), pretrained_model_filename(pre))
    return args


@pytest.mark.parametrize("solver,extra", [
    ("plain", []), ("refined", ["--flow_jac", "d2"]), ("chol", ["--mc_d2_kernel"]),
    ("host64", ["--mc_d2_kernel", "--acc_d2_kernel", "--flow_jac", "d2"]),
], ids=["plain", "refined+flow_jac_d2", "chol+mc_d2", "host64+d2_kernels"])
def test_cli_sr_trains_names_its_run_directory_and_resumes(tmp_path, capsys, solver, extra):
    args = _args(tmp_path, "--sr", "--sr_solver", solver, "--epoch", "2", *extra)
    run = main_torch.train(args)
    assert run["params_changed"] and [r["epoch"] for r in run["epochs"]] == [1, 2]
    for row in run["epochs"]:
        assert all(np.isfinite(row[k]) for k in ("F", "E", "K", "V", "S", "accept_rate"))
        assert 0 < row["scale_van"] <= 1 and 0 < row["scale_flow"] <= 1
        assert row["gnorm_van"] > 0 and row["gnorm_flow"] > 0
    out = capsys.readouterr().out
    assert ("Optimizer hybrid_fisher_sr: damping = 0.00100, max_norm = 0.00100, solver = %s"
            % solver) in out
    assert "#parameters in the flow model:" in out
    path = run["trainer"].path
    assert os.path.dirname(path) == str(tmp_path)
    assert os.path.basename(path) == (
        "n_5_dim_2_rs_10.0_Theta_0.15_Emax_4_twist_0.250_0.250_nlayers_1_modelsize_4_"
        "nheads_2_nhidden_6_depth_2_spsize_4_tpsize_4_Gmax_4_kappa_5_mctherm_1_"
        "mcsteps_2_mcstddev_0.10_hutchinson_damping_0.00100_maxnorm_0.00100_"
        "batch_6_ndevices_1_accsteps_2")
    rows = open(os.path.join(path, "data.txt")).read().splitlines()
    assert len(rows) == 2 and len(rows[0].split()) == 12
    diag = open(os.path.join(path, "sr_diag.txt")).read().splitlines()
    assert len(diag) == 2 and len(diag[0].split()) == 5
    ckpt = load_data(os.path.join(path, "epoch_000002.pkl"))
    assert set(ckpt["torch_opt_state"]) == {"gnorm_van", "scale_van", "gnorm_flow", "scale_flow"}
    assert ckpt["torch_opt_state"]["scale_van"] == run["epochs"][-1]["scale_van"]
    args.epoch_finished, args.epoch = 2, 3
    run2 = main_torch.train(args)
    assert [r["epoch"] for r in run2["epochs"]] == [3]
    assert len(open(os.path.join(path, "data.txt")).read().splitlines()) == 3
    assert len(open(os.path.join(path, "sr_diag.txt")).read().splitlines()) == 3


def test_cli_host64_refreshes_the_classical_factor_every_k_epochs(tmp_path):
    args = _args(tmp_path, "--sr", "--sr_solver", "host64", "--fisher_refresh", "2",
                 "--epoch", "3", "--damping", "0.01", "--max_norm", "0.002", "--timing")
    run = main_torch.train(args)
    cache = run["trainer"].fisher_cache
    assert cache is not None and cache.ready and cache.age == 0  # epochs 1 and 3 refresh
    assert "_damping_0.01000_maxnorm_0.00200_" in os.path.basename(run["trainer"].path)
    assert all(0 < r["scale_van"] <= 1 for r in run["epochs"])


@pytest.mark.parametrize("flags,message", [
    (["--mc_d2_kernel"], "--mc_d2_kernel requires --depth 2"),
    (["--acc_d2_kernel"], "--acc_d2_kernel requires --depth 2"),
    (["--flow_jac", "d2"], "--flow_jac d2 requires --depth 2"),
    # accepted as main.py accepts them (it reads --fisher_refresh under host64
    # only), with one line saying so; two ranks of SR under gloo
    (["--sr", "--fisher_refresh", "4"], None),
    (["--fisher_refresh", "0"], None),
    (["--sr", "--num_devices", "2"], None),
    (["--sr", "--sr_solver", "host64", "--fisher_refresh", "0"],
     "--fisher_refresh must be at least 1 under --sr --sr_solver host64"),
])
def test_cli_exits_with_one_line_where_a_flag_cannot_be_met(flags, message, tmp_path, capsys):
    args = main_torch.parse_args(["--cpu", "--hutchinson", "--depth", "3"] + flags)
    if message is None:
        main_torch.reject_unmet(args)
        if "--fisher_refresh" not in flags:
            assert main_torch.plan_launch(args).world_size == 2
            return
        # the run builds and says, in one line, that the flag changes nothing
        capsys.readouterr()
        main_torch.build_trainer(_args(tmp_path, *flags))
        k = flags[flags.index("--fisher_refresh") + 1]
        said = [ln for ln in capsys.readouterr().out.splitlines() if "--fisher_refresh" in ln]
        assert said == ["--fisher_refresh %s has no effect without --sr --sr_solver host64" % k]
        return
    with pytest.raises(SystemExit) as err:
        main_torch.reject_unmet(args)
    assert message in str(err.value) and "\n" not in str(err.value)


def test_cli_sr_runs_on_cuda_unless_cpu_is_asked_for(tmp_path):
    """CUDA is the default and is never replaced silently."""
    args = _args(tmp_path, "--sr", "--mc_d2_kernel", "--acc_d2_kernel")
    args.cpu = False
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            main_torch.build_trainer(args)
