"""The free-fermion pretraining in the port against the JAX package (f64):
the mpmath oracle, the REINFORCE loss and its gradient on fixed states, one
SR update on fixed draws (1e-10 for plain algebra, 1e-7 where a damped solve
of a Fisher with condition ~1e3/1e-3 sits in between); then short CPU runs
of ``pretrain`` that write the 6-column ``data.txt``, and ``main_torch.py``
pretraining where no VAN exists.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import coulombgas_tpu as cg
from coulombgas_tpu.analytic.canonical import Z_E as jax_Z_E
from coulombgas_tpu.analytic.thermo import thermo_quantities as jax_thermo
from coulombgas_tpu.optim.sr import fisher_sr as jax_fisher_sr
from coulombgas_tpu.sampling.autoregressive import make_classical_score as jax_classical_score
from coulombgas_tpu.train.pretrain import make_freefermion_loss as jax_make_loss
from coulombgas_tpu_torch.analytic.canonical import Z_E
from coulombgas_tpu_torch.analytic.thermo import thermo_quantities
from coulombgas_tpu_torch.io.convert import ravel_params
from coulombgas_tpu_torch.models.transformer import TransformerConfig, init_transformer_params
from coulombgas_tpu_torch.sampling.autoregressive import make_autoregressive_sampler
from coulombgas_tpu_torch.train.pretrain import (
    make_freefermion_loss, make_pretrain_step, pretrain,
)

from _torch_helpers import box, orbitals, t, van_pair, walkers

N, DIM, EMAX, BETA = 5, 2, 4, 1 / (4 * 0.15)


def test_oracle_matches_jax_at_n13():
    from mpmath import mpf

    args = (13, 2, mpf("0.15"), [mpf("0.25"), mpf("0.25")], 25)
    got, ref = Z_E(*args, dps=200), jax_Z_E(*args, dps=200)
    assert all(abs(g - r) <= 1e-150 * abs(r) for g, r in zip(got, ref))
    assert abs(float(got[0]) - 24.81105) < 1e-5
    assert [float(v) for v in thermo_quantities(2, 0.15)] == [float(v) for v in jax_thermo(2, 0.15)]


def _case():
    sp = orbitals(DIM, EMAX)
    M = sp.shape[0]
    Es = (2 * np.pi / box(N, DIM)) ** 2 * (sp**2).sum(-1)
    cfg_j, params_j, van = van_pair(M, 2, 8, 2, 12, DIM, seed=1)
    _, si = walkers(np.random.default_rng(4), 24, N, DIM, M)
    _, log_prob_j1 = cg.make_autoregressive_sampler(cfg_j, sp, N, M)
    log_prob_j = jax.vmap(log_prob_j1, (None, 0), 0)
    _, log_prob = make_autoregressive_sampler(sp, N, M)
    return sp, Es, params_j, van, si, log_prob_j1, log_prob_j, log_prob


@pytest.mark.parametrize("clip", [None, 1.5])
def test_loss_and_gradient_match_jax(clip):
    sp, Es, params_j, van, si, _, log_prob_j, log_prob = _case()
    (loss_j, aux_j), grads_j = jax.jit(jax.value_and_grad(
        jax_make_loss(log_prob_j, Es, BETA, clip), has_aux=True))(params_j, jnp.asarray(si))
    loss, aux = make_freefermion_loss(log_prob, Es, BETA, clip)(van, t(si))
    grads = torch.autograd.grad(loss, list(van.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-10, atol=1e-12)
    assert set(aux) == set(aux_j)
    for k in aux:
        assert not aux[k].requires_grad
        np.testing.assert_allclose(float(aux[k]), float(aux_j[k]), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ravel_params(van, list(grads)).numpy(),
                               np.asarray(ravel_pytree(grads_j)[0]), rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("solver", ["plain", "host64"])
def test_sr_update_on_fixed_draws_matches_jax(solver):
    sp, Es, params_j, van, si, log_prob_j1, log_prob_j, log_prob = _case()
    damping, max_norm, scale = 1e-3, 1e-3, 0.5
    opt = jax_fisher_sr(jax_classical_score(log_prob_j1), damping, max_norm)

    @jax.jit
    def jax_step(params, si):
        grads, _ = jax.grad(jax_make_loss(log_prob_j, Es, BETA), has_aux=True)(params, si)
        upd, diag = opt.update(grads, opt.init(params), params, si, max_norm_scale=scale)
        return jax.tree.map(lambda p, u: p + u, params, upd), diag

    new_j, diag_j = jax_step(params_j, jnp.asarray(si))
    step, optimizer = make_pretrain_step(van, log_prob, make_freefermion_loss(log_prob, Es, BETA),
                                         1e-3, True, damping, max_norm, solver)
    assert optimizer is None
    before = ravel_params(van).clone()
    aux = step(t(si), trust_scale=scale)
    assert set(aux) == {"E_mean", "E_std", "F_mean", "F_std", "S_mean", "S_std"}
    moved = ravel_params(van) - before
    ref = np.asarray(ravel_pytree(new_j)[0]) - before.numpy()
    assert 0 < float(diag_j["scale"]) < 1  # the trust radius binds
    np.testing.assert_allclose(moved.numpy(), ref, rtol=1e-7, atol=1e-12)


@pytest.mark.parametrize("sr,solver", [(True, "plain"), (True, "host64"), (False, "plain")],
                         ids=["sr_plain", "sr_host64", "adam"])
def test_pretrain_writes_its_log_and_learns(tmp_path, capsys, sr, solver):
    M = orbitals(DIM, EMAX).shape[0]
    van = init_transformer_params(TransformerConfig(M, 1, 8, 2, 12), DIM,
                                  torch.Generator().manual_seed(0), torch.float64, "cpu")
    before = ravel_params(van).clone()
    out = pretrain(van, N, DIM, 0.15, EMAX, np.array([0.25, 0.25]), str(tmp_path),
                   torch.Generator().manual_seed(1), 1e-2, sr, 1e-3, 1e-2, 64, epoch=10,
                   dps=50, solver=solver, ckpt_every=5)
    assert out is van and not torch.equal(ravel_params(van), before)
    rows = np.loadtxt(os.path.join(tmp_path, "data.txt"), ndmin=2)
    assert rows.shape[1] == 7 and np.isfinite(rows).all()
    assert rows[0, 0] == 1 and rows[-1, 0] == 10 and len(rows) >= 8  # gaps only where reverted
    assert os.path.isfile(os.path.join(tmp_path, "ckpt_van.pkl"))
    text = capsys.readouterr().out
    assert "Analytic results for the thermodynamic quantities: F: " in text
    # F is bounded below by the exact free energy, up to the batch's noise
    F_exact = float(Z_E(N, DIM, 0.15, [0.25, 0.25], EMAX, dps=50)[0])
    assert (rows[:, 1] > F_exact - 5 * rows[:, 2] - 1e-6).all()


def test_main_torch_pretrains_where_no_van_exists(tmp_path, capsys):
    import main_torch

    argv = ["--cpu", "--hutchinson", "--n", str(N), "--Emax", str(EMAX), "--nlayers", "1",
            "--modelsize", "4", "--nheads", "2", "--nhidden", "6", "--spsize", "4",
            "--tpsize", "4", "--Gmax", "4", "--kappa", "5", "--batch", "6", "--mc_therm", "1",
            "--mc_steps", "2", "--acc_steps", "1", "--epoch", "1", "--pre_batch", "32",
            "--pre_epoch", "4", "--folder", str(tmp_path) + os.sep]
    run = main_torch.train(main_torch.parse_args(argv))
    pre = main_torch.freefermion_path(main_torch.parse_args(argv), np.array([0.25, 0.25]))
    assert os.path.isfile(os.path.join(pre, "params_van.pkl"))
    assert np.loadtxt(os.path.join(pre, "data.txt"), ndmin=2).shape[1] == 7
    assert len(run["epochs"]) == 1 and np.isfinite(run["epochs"][0]["F"])
    out = capsys.readouterr().out
    assert out.index("running free-fermion pretraining") < out.index("Pretraining done")
    # a second run finds the VAN and loads it
    main_torch.build_trainer(main_torch.parse_args(argv))
    assert "Load pretrained free-fermion model" in capsys.readouterr().out
