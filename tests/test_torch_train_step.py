"""The slice as a whole: with fixed (state_indices, x, v) the port's
``accumulate`` gives the JAX package's observables and both REINFORCE
gradients, and one Adam step gives ``optax.adam``'s parameters (f64, 1e-8
through the log-dets and second derivatives).  Then main_torch.py itself on the
checked-in n = 13 pretraining."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import coulombgas_tpu as cg
from coulombgas_tpu.train.loss import make_loss as jax_make_loss
from coulombgas_tpu.train.train import (
    init_accumulators as jax_init_accumulators,
    make_accumulate_and_apply as jax_make_accumulate_and_apply,
)
from coulombgas_tpu.wavefunction.fast_laplacian import (
    make_logpsi_grad_laplacian_analytic as jax_make_gl,
)
from coulombgas_tpu_torch.io.convert import flatten_tree
from coulombgas_tpu_torch.models.ferminet_jac import (
    ferminet_apply_and_jac, ferminet_apply_jac_lap,
)
from coulombgas_tpu_torch.parallel import mesh
from coulombgas_tpu_torch.physics import ewald
from coulombgas_tpu_torch.sampling.autoregressive import make_autoregressive_sampler
from coulombgas_tpu_torch.train.loss import make_loss
from coulombgas_tpu_torch.train.train import (
    DATA_KEYS, chunk_layout, init_accumulators, make_accumulate_and_apply, make_sample_step,
)
from coulombgas_tpu_torch.wavefunction.fast_laplacian import (
    make_logpsi_grad_laplacian_analytic,
)
from coulombgas_tpu_torch.wavefunction.fast_logp import make_logp_fast
from coulombgas_tpu_torch.wavefunction.logpsi import make_logpsi_fast

from _torch_helpers import flow_pair, orbitals, t, van_pair, walkers

N, DIM, BATCH = 4, 2, 6
RS, KAPPA, GMAX, BETA, LR = 5.0, 6, 5, 1 / (4 * 0.15), 1e-2


@pytest.fixture(scope="module")
def both():
    """One accumulate + apply in each framework on the same inputs."""
    sp = orbitals(DIM, 4)
    M = sp.shape[0]
    cfg_f, params_flow, flow = flow_pair(2, 6, 6, N, DIM, stddev=0.1)
    cfg_v, params_van, van = van_pair(M, 1, 8, 2, 12, DIM, seed=1)
    L = cfg_f.L
    x, si = walkers(np.random.default_rng(0), BATCH, N, DIM, M)
    G = ewald.kpoints(DIM, GMAX)
    Vconst = N * RS / L * ewald.madelung(DIM, KAPPA, G)
    key = jax.random.PRNGKey(11)
    v = np.asarray(jax.random.normal(key, x.shape, jnp.float64))

    # ---- JAX ----------------------------------------------------------------
    _, log_prob_1 = cg.make_autoregressive_sampler(cfg_v, sp, N, M)
    log_prob_j = jax.vmap(log_prob_1, (None, 0), 0)
    jac = lambda p, q: cg.ferminet_apply_and_jac(p, cfg_f, q)
    jac_lap = lambda p, q: cg.ferminet_apply_jac_lap(p, cfg_f, q)
    logpsi_j, _ = cg.make_logpsi_grad_laplacian(cg.make_logpsi_fast(jac, sp, L))
    gl_j = jax_make_gl(lambda p, q: cg.ferminet_apply(p, cfg_f, q), sp, L,
                       hutchinson=True, flow_jac_lap=jac_lap)
    loss_j = jax_make_loss(log_prob_j, logpsi_j, gl_j, KAPPA, np.asarray(G, np.float64),
                           L, RS, Vconst, BETA)
    opt = optax.adam(LR)
    acc_fn, apply_fn = jax_make_accumulate_and_apply(loss_j, opt, 1)
    acc_j = jax_init_accumulators(params_van, params_flow, False, jnp.float64)
    acc_j = jax.jit(acc_fn)(params_van, params_flow, jnp.asarray(si), jnp.asarray(x), key, acc_j)
    new_van, new_flow, _, data_j = jax.jit(apply_fn)(
        params_van, params_flow, opt.init((params_van, params_flow)), acc_j)

    # ---- port ---------------------------------------------------------------
    _, log_prob = make_autoregressive_sampler(sp, N, M)
    logpsi = make_logpsi_fast(ferminet_apply_and_jac, sp, L)
    gl = make_logpsi_grad_laplacian_analytic(sp, L, ferminet_apply_jac_lap,
                                             flow_jac=ferminet_apply_and_jac)  # as main_torch.py does
    loss = make_loss(log_prob, logpsi, gl, KAPPA, G, L, RS, Vconst, BETA)
    accumulate, apply_update = make_accumulate_and_apply(loss, 1)
    acc = accumulate(van, flow, t(si), t(x), None, init_accumulators(van, flow), v=t(v))
    acc_copy = {
        "data": {k: float(val) for k, val in acc["data"].items()},
        "grads": ([g.clone() for g in acc["grads"][0]], [g.clone() for g in acc["grads"][1]]),
        "classical_score": [g.clone() for g in acc["classical_score"]],
        "quantum_score": [g.clone() for g in acc["quantum_score"]],
    }
    optimizer = torch.optim.Adam([*van.parameters(), *flow.parameters()], lr=LR, eps=1e-8)
    data = apply_update(van, flow, optimizer, acc)
    return dict(acc_j=acc_j, data_j=data_j, new_van=new_van, new_flow=new_flow,
                acc=acc_copy, data=data, van=van, flow=flow, loss=loss, sp=sp, L=L,
                x=x, si=si, v=v, log_prob=log_prob)


def _assert_tree(named_tensors, tree, rtol=1e-8, atol=1e-10):
    flat = flatten_tree(jax.tree.map(np.asarray, tree))
    names = [k for k, _ in named_tensors]
    assert sorted(names) == sorted(flat)
    for k, val in named_tensors:
        np.testing.assert_allclose(val.detach().numpy(), flat[k], rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("key", DATA_KEYS)
def test_accumulate_observables_match_jax(both, key):
    np.testing.assert_allclose(both["acc"]["data"][key], float(both["acc_j"]["data"][key]),
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(float(both["data"][key]), float(both["data_j"][key]),
                               rtol=1e-8, atol=1e-8)


def test_accumulate_classical_gradient_matches_jax(both):
    names = [k for k, _ in both["van"].named_parameters()]
    _assert_tree(list(zip(names, both["acc"]["grads"][0])), both["acc_j"]["grads"][0])
    _assert_tree(list(zip(names, both["acc"]["classical_score"])), both["acc_j"]["classical_score"])


def test_accumulate_quantum_gradient_matches_jax(both):
    names = [k for k, _ in both["flow"].named_parameters()]
    _assert_tree(list(zip(names, both["acc"]["grads"][1])), both["acc_j"]["grads"][1])
    _assert_tree(list(zip(names, both["acc"]["quantum_score"])), both["acc_j"]["quantum_score"])


def test_adam_step_matches_optax(both):
    # atol 1e-9: a parameter whose exact gradient is zero (the attention's key
    # bias: softmax ignores a shift of all keys) has a roundoff-sized g, and
    # Adam turns it into a step of lr * g / (|g| + eps)
    _assert_tree(list(both["van"].named_parameters()), both["new_van"], rtol=1e-8, atol=1e-9)
    _assert_tree(list(both["flow"].named_parameters()), both["new_flow"], rtol=1e-8, atol=1e-9)


def test_microbatched_accumulate_averages_the_chunks(both):
    """Chunks of 3 walkers: the observables' means are the batch means (the
    clipping window, and so the gradients, are per chunk by design)."""
    van, flow, loss = both["van"], both["flow"], both["loss"]
    x, si, v = t(both["x"]), t(both["si"]), t(both["v"])
    whole, _ = make_accumulate_and_apply(loss, 1)
    chunked, _ = make_accumulate_and_apply(
        loss, 1, pieces=mesh.window_groups(chunk_layout(x.shape[0], 3, 1)))
    a = whole(van, flow, si, x, None, init_accumulators(van, flow), v=v)
    b = chunked(van, flow, si, x, None, init_accumulators(van, flow), v=v)
    for k in ("F_mean", "E_mean", "K_mean", "V_mean", "S_mean", "E2_mean"):
        np.testing.assert_allclose(float(b["data"][k]), float(a["data"][k]), rtol=1e-10)
    assert all(torch.isfinite(g).all() for g in b["grads"][1])
    with pytest.raises(ValueError):  # 4 does not divide the batch
        chunk_layout(x.shape[0], 4, 1)
    with pytest.raises(ValueError):  # pieces of another batch
        chunked(van, flow, si[:-3], x[:-3], None, init_accumulators(van, flow), v=v[:-3])


def test_accumulators_start_at_zero_and_sr_waits(both):
    acc = init_accumulators(both["van"], both["flow"])
    assert set(acc["data"]) == set(DATA_KEYS)
    assert all(float(val) == 0 for val in acc["data"].values())
    assert all(float(g.abs().sum()) == 0 for g in acc["grads"][0] + acc["grads"][1])
    assert "classical_fisher" not in acc
    # with SR the Fisher payload waits beside them, in the reference's layout
    acc = init_accumulators(both["van"], both["flow"], sr=True)
    p_van = sum(p.numel() for p in both["van"].parameters())
    p_flow = sum(p.numel() for p in both["flow"].parameters())
    assert acc["classical_fisher"].shape == (p_van, p_van)
    assert acc["quantum_fisher"].shape == (p_flow, p_flow)
    assert acc["quantum_score_mean"].shape == (2, p_flow)
    assert all(float(acc[k].abs().sum()) == 0 for k in
               ("classical_fisher", "quantum_fisher", "quantum_score_mean"))


def test_sample_step_returns_wrapped_walkers(both):
    sp, L, van, flow = both["sp"], both["L"], both["van"], both["flow"]
    sampler, _ = make_autoregressive_sampler(sp, N, sp.shape[0])
    logp = make_logp_fast(sp, L)
    step = make_sample_step(sampler, logp, 4, 0.1, L, BATCH)
    g = torch.Generator().manual_seed(0)
    si, x, acc = step(van, flow, t(both["x"]) + 3 * L, g)
    assert si.shape == (BATCH, N) and torch.all(si[:, 1:] > si[:, :-1])
    assert x.shape == (BATCH, N, DIM) and float(x.min()) >= 0 and float(x.max()) < L
    assert 0 <= float(acc) <= 1


# ---- main_torch.py ---------------------------------------------------------------

SMALL = ["--cpu", "--hutchinson", "--n", "13", "--folder", "data/interacting/", "--batch", "4",
         "--mc_therm", "1", "--mc_steps", "3", "--acc_steps", "1", "--epoch", "2",
         "--ckpt_every", "2"]


def test_cli_trains_and_resumes_on_the_checked_in_pretraining(tmp_path):
    import main_torch

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    argv = list(SMALL)
    argv[argv.index("--folder") + 1] = os.path.join(root, "data", "interacting") + os.sep
    args = main_torch.parse_args(argv)
    run = main_torch.train(args, out_folder=str(tmp_path))
    assert run["params_changed"] and len(run["epochs"]) == 2
    for row in run["epochs"]:
        assert all(np.isfinite(row[k]) for k in ("F", "E", "K", "V", "S", "accept_rate"))
    path = run["trainer"].path
    assert os.path.basename(path) == (
        "n_13_dim_2_rs_10.0_Theta_0.15_Emax_25_twist_0.250_0.250_nlayers_2_modelsize_16_"
        "nheads_4_nhidden_32_depth_2_spsize_16_tpsize_16_Gmax_15_kappa_10_mctherm_1_"
        "mcsteps_3_mcstddev_0.10_hutchinson_lr_0.001_batch_4_ndevices_1_accsteps_1")
    rows = open(os.path.join(path, "data.txt")).read().splitlines()
    assert len(rows) == 2 and len(rows[0].split()) == 12
    assert os.path.isfile(os.path.join(path, "epoch_000002.pkl"))
    args.epoch_finished, args.epoch = 2, 3
    run2 = main_torch.train(args, out_folder=str(tmp_path))
    assert [r["epoch"] for r in run2["epochs"]] == [3]
    assert len(open(os.path.join(path, "data.txt")).read().splitlines()) == 3


@pytest.mark.parametrize("flags,word", [
    (["--forloop_laplacian"], None), (["--num_devices", "2"], "multi-GPU"),
    (["--coordinator", "localhost:1234"], "multi-GPU"), (["--num_processes", "2"], "multi-GPU"),
    (["--process_id", "0"], "multi-GPU"), (["--slow_logp"], None),
    (["--laplacian", "ad"], None), (["--multihost"], "multi-GPU"),
    (["--multihost", "--process_id", "1"], "multi-GPU"), (["--num_devices", "4"], "multi-GPU"),
])
def test_cli_refuses_flags_of_later_slices(flags, word):
    """No flag waits for a later slice any more: the generic-AD engines'
    flags (``word`` None) are accepted, with or without --hutchinson, and so
    are the multi-GPU flags, which lay out processes as main.py reads them:
    ``--num_devices K`` spawns K ranks (gloo under --cpu), ``--multihost``
    makes this process a rank (here from torchrun's environment), and
    ``--coordinator`` / ``--num_processes`` / ``--process_id`` without
    ``--multihost`` change nothing."""
    import main_torch

    torchrun = {"RANK": "1", "WORLD_SIZE": "4", "LOCAL_RANK": "1",
                "MASTER_ADDR": "localhost", "MASTER_PORT": "29500"}
    for base in (["--cpu", "--hutchinson"], ["--cpu"]):
        args = main_torch.parse_args(base + flags)
        main_torch.reject_unmet(args)
        if word is None:
            continue
        plan = main_torch.plan_launch(args, environ=torchrun)
        if "--multihost" in flags:
            assert (plan.world_size, plan.rank, plan.init_method, plan.spawn) == (
                4, 1, "env://", False)
        elif "--num_devices" in flags:
            k = int(flags[flags.index("--num_devices") + 1])
            assert (plan.world_size, plan.spawn) == (k, True)
        else:
            assert (plan.world_size, plan.spawn) == (1, False)


def test_cli_needs_hutchinson_a_pretrained_van_and_a_device(tmp_path, capsys):
    """main.py's default line (no --hutchinson) builds; without a pretrained
    VAN the pretraining runs first; CUDA is the default device."""
    import main_torch

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tr = main_torch.build_trainer(
        main_torch.parse_args(["--cpu", "--folder", os.path.join(root, "data", "interacting") + os.sep]),
        out_folder=str(tmp_path / "default"))
    assert "_hutchinson" not in os.path.basename(tr.path) and tr.x.shape == (2048, 29, 2)
    # without a pretrained VAN under --folder the pretraining runs and writes one
    args = main_torch.parse_args(
        ["--cpu", "--hutchinson", "--folder", str(tmp_path) + os.sep, "--n", "5", "--Emax", "4",
         "--nlayers", "1", "--modelsize", "4", "--nheads", "2", "--nhidden", "6",
         "--pre_batch", "16", "--pre_epoch", "2"])
    main_torch.build_trainer(args)
    pre = main_torch.freefermion_path(args, np.array(args.twist))
    assert os.path.isfile(os.path.join(pre, "params_van.pkl"))
    assert len(open(os.path.join(pre, "data.txt")).read().splitlines()) == 2
    assert "No pretrained model found; running free-fermion pretraining" in capsys.readouterr().out
    if not torch.cuda.is_available():  # CUDA is the default and is never replaced silently
        with pytest.raises(RuntimeError, match="CUDA"):
            main_torch.build_trainer(main_torch.parse_args(["--hutchinson"]))
