"""main_torch.py on main.py's default command line and the other Laplacian
and log-density flags (f64 on the CPU, n 7, batch 8, mc_steps 5).

  * one accumulate's observables of the trainer that ``main_torch.py`` builds
    — the default line (exact Laplacian, analytic Slater part), ``--laplacian
    ad`` and ``--slow_logp`` — equal to the JAX ``make_loss`` wired as
    ``main.py`` wires it, on the same walkers, occupations and parameters;
  * a two-epoch run for each newly accepted flag set, with ``data.txt``
    finite and the run directory named as ``main.py`` names it.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import coulombgas_tpu as cg
from coulombgas_tpu.models.ferminet_jac import select_flow_jac as jax_select_flow_jac
from coulombgas_tpu.train.loss import make_loss as jax_make_loss
from coulombgas_tpu.wavefunction.fast_laplacian import (
    make_logpsi_grad_laplacian_analytic as jax_make_gl,
)
from coulombgas_tpu_torch.io.convert import flow_to_numpy, van_to_numpy
from coulombgas_tpu_torch.train.train import init_accumulators

# main.py's flow and Ewald defaults; a small VAN and Emax keep the JAX
# references' compile short
SMALL = ["--cpu", "--n", "7", "--batch", "8", "--mc_steps", "5", "--mc_therm", "1",
         "--acc_steps", "1", "--epoch", "2", "--ckpt_every", "1000", "--Emax", "9",
         "--nlayers", "1", "--modelsize", "8", "--nheads", "2", "--nhidden", "12",
         "--pre_batch", "16", "--pre_epoch", "2"]
RUN_NAME = ("n_7_dim_2_rs_10.0_Theta_0.15_Emax_9_twist_0.250_0.250_nlayers_1_modelsize_8_"
            "nheads_2_nhidden_12_depth_2_spsize_16_tpsize_16_Gmax_15_kappa_10_mctherm_1_"
            "mcsteps_5_mcstddev_0.10%s_batch_8_ndevices_1_accsteps_1")


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """A --folder holding a (briefly) pretrained n = 7 VAN."""
    import main_torch

    path = str(tmp_path_factory.mktemp("pretrained")) + os.sep
    main_torch.build_trainer(main_torch.parse_args(SMALL + ["--folder", path]),
                             out_folder=str(tmp_path_factory.mktemp("unused")))
    return path


def _args(folder, flags):
    import main_torch

    return main_torch.parse_args(SMALL + ["--folder", folder] + flags)


def _jax_engine(line, flow_cfg, sp, L):
    """(logpsi, logpsi_grad_laplacian) as main.py:277-297 and :383-421 build
    them for this line."""
    flow_apply = lambda p, q: cg.ferminet_apply(p, flow_cfg, q)
    flow_jac, flow_jac_lap = jax_select_flow_jac(flow_cfg, "auto")
    logphi, logjacdet = cg.make_logphi_logjacdet(flow_apply, sp, L)
    slow = line == "--slow_logp"
    logpsi_novmap = (cg.make_logpsi(flow_apply, sp, L) if slow
                     else cg.make_logpsi_fast(flow_jac, sp, L))
    if line == "--laplacian ad":
        return cg.make_logpsi_grad_laplacian(logpsi_novmap, logphi=logphi, logjacdet=logjacdet)
    logpsi, _ = cg.make_logpsi_grad_laplacian(logpsi_novmap)
    return logpsi, jax_make_gl(flow_apply, sp, L, hutchinson=False,
                               flow_jac_lap=None if slow else flow_jac_lap)


@pytest.mark.parametrize("line", ["", "--laplacian ad", "--slow_logp"])
def test_accumulate_observables_match_jax(folder, tmp_path, line):
    import main_torch

    args = _args(folder, line.split())
    tr = main_torch.build_trainer(args, out_folder=str(tmp_path))
    with torch.no_grad():  # a flow that is not near the identity
        for p in tr.flow.parameters():
            p.mul_(20.0)
    si, x, _ = tr.sample_step(tr.van, tr.flow, tr.x, tr.generator)
    acc = tr.accumulate(tr.van, tr.flow, si, x, tr.generator, init_accumulators(tr.van, tr.flow))

    n, dim, L = args.n, args.dim, tr.L
    sp = tr.sp_indices
    M = sp.shape[0]
    cfg_v = cg.TransformerConfig(M, args.nlayers, args.modelsize, args.nheads, args.nhidden)
    _, log_prob_1 = cg.make_autoregressive_sampler(cfg_v, sp, n, M)
    flow_cfg = cg.FermiNetConfig(args.depth, args.spsize, args.tpsize, L)
    logpsi, engine = _jax_engine(line, flow_cfg, sp, L)
    G = np.asarray(cg.kpoints(dim, args.Gmax), np.float64)
    Vconst = float(n * args.rs / L * cg.madelung(dim, args.kappa, G))
    loss = jax_make_loss(jax.vmap(log_prob_1, (None, 0), 0), logpsi, engine, args.kappa, G, L,
                         args.rs, Vconst, 1 / (4 * args.Theta))
    tree = lambda d: jax.tree.map(jnp.asarray, d)  # noqa: E731
    obs = jax.jit(lambda pv, pf, s, q: loss(pv, pf, s, q, jax.random.PRNGKey(0))[0])(
        tree(van_to_numpy(tr.van)), tree(flow_to_numpy(tr.flow)),
        jnp.asarray(si.numpy()), jnp.asarray(x.numpy()))
    for key in ("F", "E", "K", "V", "S"):
        for k in (key + "_mean", key + "2_mean"):
            np.testing.assert_allclose(float(acc["data"][k]), float(obs[k]), rtol=1e-10,
                                       atol=1e-10, err_msg=k)
    assert abs(float(obs["K_mean"])) > 1e-3


FLAG_SETS = {
    "default": [],
    "forloop_laplacian": ["--forloop_laplacian"],
    "laplacian_ad": ["--laplacian", "ad"],
    "slow_logp": ["--slow_logp"],
    "sr_slow_logp": ["--sr", "--slow_logp"],
}


@pytest.mark.parametrize("name", list(FLAG_SETS))
def test_cli_runs_newly_accepted_flags(folder, tmp_path, capsys, name):
    import main_torch

    flags = FLAG_SETS[name]
    args = _args(folder, flags)
    main_torch.reject_unmet(args)  # nothing of these is refused any more
    run = main_torch.train(args, out_folder=str(tmp_path))
    assert len(run["epochs"]) == 2 and run["params_changed"]
    path = run["trainer"].path
    tail = "_damping_0.00100_maxnorm_0.00100" if "--sr" in flags else "_lr_0.001"
    assert os.path.basename(path) == RUN_NAME % tail
    rows = np.loadtxt(os.path.join(path, "data.txt"), ndmin=2)
    assert rows.shape == (2, 12) and np.isfinite(rows).all()
    out = capsys.readouterr().out
    if "--slow_logp" in flags:
        assert "logp route: make_logp(make_logpsi)" in out


@pytest.mark.parametrize("flags,said", [
    (["--slow_logp", "--mc_d2_kernel"], "(--mc_d2_kernel has no effect)"),
    (["--laplacian", "ad", "--acc_d2_kernel"], "(--acc_d2_kernel has no effect)"),
    (["--slow_logp", "--acc_d2_kernel"], None),
])
def test_cli_kernel_flags_beside_the_generic_paths(folder, tmp_path, capsys, flags, said):
    """As main.py: a kernel flag where no kernel runs is ignored, and said so;
    --acc_d2_kernel under --slow_logp ends the run (main.py raises there)."""
    import main_torch

    args = _args(folder, flags)
    main_torch.reject_unmet(args)
    if said is None:
        with pytest.raises(SystemExit, match="not --slow_logp"):
            main_torch.build_trainer(args, out_folder=str(tmp_path))
        return
    main_torch.build_trainer(args, out_folder=str(tmp_path))
    assert said in capsys.readouterr().out
