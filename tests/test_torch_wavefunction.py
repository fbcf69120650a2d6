"""The port's Slater determinant, log Psi, analytic gradient/Laplacian engine
and Ewald potential against the JAX package (f64 on the CPU; 1e-10 for plain
algebra, 1e-8 through log-dets, inverses and second derivatives)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import coulombgas_tpu as cg
from coulombgas_tpu.wavefunction.fast_laplacian import (
    make_logpsi_grad_laplacian_analytic as jax_make_gl,
)
from coulombgas_tpu_torch.models.ferminet_jac import (
    ferminet_apply_and_jac, ferminet_apply_jac_lap,
)
from coulombgas_tpu_torch.models.slater import logslaterdet, logslaterdet_ref
from coulombgas_tpu_torch.physics import ewald, orbitals as torch_orbitals
from coulombgas_tpu_torch.wavefunction.fast_laplacian import (
    make_logpsi_grad_laplacian_analytic,
)
from coulombgas_tpu_torch.wavefunction.logpsi import make_logpsi_fast, to_complex

from _torch_helpers import box, flow_pair, orbitals, t, walkers


def _wrap_phase(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


@pytest.mark.parametrize("dim,Emax", [(2, 9), (3, 3)])
def test_orbitals_match_jax(dim, Emax):
    idx_t, Es_t = torch_orbitals.sp_orbitals(dim, Emax)
    idx_j, Es_j = cg.sp_orbitals(dim, Emax)
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_array_equal(Es_t, Es_j)
    tw_t, Et = torch_orbitals.twist_sort(idx_t, np.full(dim, 0.25))
    tw_j, Ej = cg.twist_sort(idx_j, np.full(dim, 0.25))
    np.testing.assert_array_equal(tw_t, tw_j)
    np.testing.assert_array_equal(Et, Ej)


@pytest.mark.parametrize("dim,n", [(2, 5), (3, 4)])
def test_logslaterdet_matches_jax(dim, n):
    sp = orbitals(dim, 9 if dim == 2 else 3)
    L = box(n, dim)
    x, si = walkers(np.random.default_rng(dim), 5, n, dim, sp.shape[0])
    ref = jax.vmap(lambda s, q: cg.logslaterdet(jnp.asarray(sp)[s], q, L))(
        jnp.asarray(si), jnp.asarray(x))
    got = logslaterdet(t(sp)[t(si)], t(x), L).numpy()
    np.testing.assert_allclose(got[:, 0], np.asarray(ref.real), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(_wrap_phase(got[:, 1] - np.asarray(ref.imag)), 0, atol=1e-10)
    c = logslaterdet_ref(t(sp)[t(si)], t(x), L)
    assert c.dtype == torch.complex128
    np.testing.assert_allclose(c.real.numpy(), got[:, 0])


def test_logslaterdet_is_antisymmetric():
    sp = orbitals(2, 9)
    x, si = walkers(np.random.default_rng(0), 1, 5, 2, sp.shape[0])
    a = logslaterdet(t(sp)[t(si)], t(x), 3.0)[0]
    perm = [1, 0, 2, 3, 4]
    b = logslaterdet(t(sp)[t(si)], t(x[:, perm]), 3.0)[0]
    np.testing.assert_allclose(float(a[0]), float(b[0]), rtol=1e-12)
    np.testing.assert_allclose(abs(_wrap_phase(float(a[1] - b[1]))), np.pi, rtol=1e-10)


def _psi_case(dim=2, depth=2):
    n, Emax = (5, 9) if dim == 2 else (4, 3)
    sp = orbitals(dim, Emax)
    cfg, params, flow = flow_pair(depth, 8, 8, n, dim, stddev=0.1)
    x, si = walkers(np.random.default_rng(10 + dim), 4, n, dim, sp.shape[0])
    return n, sp, cfg, params, flow, x, si


@pytest.mark.parametrize("dim", [2, 3])
def test_logpsi_fast_matches_jax(dim):
    n, sp, cfg, params, flow, x, si = _psi_case(dim)
    jac = lambda p, q: cg.ferminet_apply_and_jac(p, cfg, q)
    logpsi_j = cg.make_logpsi_fast(jac, sp, cfg.L)
    ref = np.asarray(jax.jit(jax.vmap(logpsi_j, (0, None, 0)))(jnp.asarray(x), params, jnp.asarray(si)))
    logpsi = make_logpsi_fast(ferminet_apply_and_jac, sp, cfg.L)
    with torch.no_grad():
        got = logpsi(t(x), flow, t(si))
    assert got.shape == (4, 2)  # the reference's [Re, Im] convention
    np.testing.assert_allclose(got[:, 0].numpy(), ref[:, 0], rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(_wrap_phase(got[:, 1].numpy() - ref[:, 1]), 0, atol=1e-8)
    assert to_complex(got).dtype == torch.complex128


def test_logpsi_parameter_gradient_matches_jax():
    """d/d params of sum_b Re log Psi: through slogdet's own derivative and the
    closed-form derivative of the Gram log-det."""
    n, sp, cfg, params, flow, x, si = _psi_case(2)
    jac = lambda p, q: cg.ferminet_apply_and_jac(p, cfg, q)
    logpsi_j = cg.make_logpsi_fast(jac, sp, cfg.L)
    weights = np.random.default_rng(0).normal(size=(4, 2))

    def loss_j(p):
        lp = jax.vmap(logpsi_j, (0, None, 0))(jnp.asarray(x), p, jnp.asarray(si))
        return (lp * jnp.asarray(weights)).sum()

    g_ref = jax.jit(jax.grad(loss_j))(params)
    logpsi = make_logpsi_fast(ferminet_apply_and_jac, sp, cfg.L)
    (logpsi(t(x), flow, t(si)) * t(weights)).sum().backward()
    for i, lin in enumerate(flow.sp):
        np.testing.assert_allclose(lin.w.grad.numpy(), np.asarray(g_ref["sp"][i]["w"]), rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(lin.b.grad.numpy(), np.asarray(g_ref["sp"][i]["b"]), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(flow.tp[0].w.grad.numpy(), np.asarray(g_ref["tp"][0]["w"]), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(flow.final.w.grad.numpy(), np.asarray(g_ref["final"]["w"]), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(flow.final.b.grad.numpy(), np.asarray(g_ref["final"]["b"]), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("dim,depth", [(2, 2), (3, 2), (2, 3)])
def test_grad_laplacian_with_shared_probe_matches_jax(dim, depth):
    n, sp, cfg, params, flow, x, si = _psi_case(dim, depth)
    flow_apply = lambda p, q: cg.ferminet_apply(p, cfg, q)
    jac_lap = lambda p, q: cg.ferminet_apply_jac_lap(p, cfg, q)
    fn_j = jax_make_gl(flow_apply, sp, cfg.L, hutchinson=True, flow_jac_lap=jac_lap)
    key = jax.random.PRNGKey(3)
    g_ref, lap_ref = jax.jit(fn_j)(jnp.asarray(x), params, jnp.asarray(si), key)
    v = np.asarray(jax.random.normal(key, x.shape, jnp.float64))  # the reference's own probe

    fn = make_logpsi_grad_laplacian_analytic(sp, cfg.L, ferminet_apply_jac_lap)
    g, lap = fn(t(x), flow, t(si), v=t(v))
    assert g.dtype == torch.complex128 and g.shape == x.shape and lap.shape == (4,)
    assert not g.requires_grad and not lap.requires_grad
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(lap.numpy(), np.asarray(lap_ref), rtol=1e-8, atol=1e-8)


def test_grad_laplacian_draws_its_probe_from_the_generator():
    n, sp, cfg, params, flow, x, si = _psi_case(2)
    fn = make_logpsi_grad_laplacian_analytic(sp, cfg.L, ferminet_apply_jac_lap)
    g1, l1 = fn(t(x), flow, t(si), torch.Generator().manual_seed(5))
    g2, l2 = fn(t(x), flow, t(si), torch.Generator().manual_seed(5))
    g3, l3 = fn(t(x), flow, t(si), torch.Generator().manual_seed(6))
    assert torch.equal(l1, l2) and torch.equal(g1, g2)
    assert torch.equal(g1, g3) and not torch.equal(l1, l3)  # only the Laplacian is stochastic
    # the exact Laplacian (hutchinson=False) draws nothing: the same numbers
    # whatever the generator
    exact = make_logpsi_grad_laplacian_analytic(sp, cfg.L, ferminet_apply_jac_lap, hutchinson=False)
    g4, l4 = exact(t(x), flow, t(si), torch.Generator().manual_seed(5))
    g5, l5 = exact(t(x), flow, t(si), torch.Generator().manual_seed(6))
    assert torch.equal(g4, g5) and torch.equal(l4, l5) and torch.equal(g4, g1)


def test_identity_flow_kinetic_energy_is_sum_k_squared():
    """With zero flow weights u = x and the local kinetic energy is sum |k|^2."""
    n, sp, cfg, params, flow, x, si = _psi_case(2)
    with torch.no_grad():
        for p in flow.parameters():
            p.zero_()
    fn = make_logpsi_grad_laplacian_analytic(sp, cfg.L, ferminet_apply_jac_lap)
    g, lap = fn(t(x), flow, t(si), torch.Generator().manual_seed(0))
    kinetic = -lap - (g**2).sum(dim=(-2, -1))
    k2 = ((2 * np.pi / cfg.L * sp[si]) ** 2).sum(axis=(-2, -1))
    np.testing.assert_allclose(kinetic.real.numpy(), k2, rtol=1e-9)
    np.testing.assert_allclose(kinetic.imag.numpy(), 0, atol=1e-9)


@pytest.mark.parametrize("dim", [2, 3])
def test_ewald_matches_jax(dim):
    Gmax, kappa, n, rs = 6, 7, 5, 4.0
    L = box(n, dim)
    G_t, G_j = ewald.kpoints(dim, Gmax), cg.kpoints(dim, Gmax)
    np.testing.assert_array_equal(G_t, G_j)
    np.testing.assert_allclose(ewald.madelung(dim, kappa, G_t),
                               float(cg.madelung(dim, kappa, jnp.asarray(G_j, jnp.float64))),
                               rtol=1e-12)
    x = np.random.default_rng(dim).uniform(0, L, (6, n, dim))
    ref = cg.potential_energy(jnp.asarray(x), kappa, np.asarray(G_j, np.float64), L, rs)
    got = ewald.potential_energy(t(x), kappa, G_t, L, rs)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-10)
    one = ewald.ewald_sum(t(x[0] / L), kappa, G_t)
    np.testing.assert_allclose(float(one), float(cg.ewald_sum(jnp.asarray(x[0] / L), kappa,
                                                             np.asarray(G_j, np.float64))),
                               rtol=1e-10)


def test_ewald_is_independent_of_the_splitting_parameter():
    G = ewald.kpoints(2, 12)
    x = t(np.random.default_rng(0).uniform(0, 1, (3, 4, 2)))
    a = ewald.ewald_sum(x, 6, G) + 0.5 * 4 * ewald.madelung(2, 6, G)
    b = ewald.ewald_sum(x, 8, G) + 0.5 * 4 * ewald.madelung(2, 8, G)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)
    with pytest.raises(ValueError):
        ewald.ewald_sum(torch.zeros(2, 1, dtype=torch.float64), 6, np.ones((1, 1)))
