"""The exact Laplacian of the analytic engine, and the closed-form log-det
rules it nests over, against the JAX package (f64 on the CPU).

  * ``make_logpsi_grad_laplacian_analytic(hutchinson=False)``, in batched
    passes and column by column, with the analytic flow Jacobian and without
    one (``flow_apply`` alone: J by ``jacfwd``, lap_u by the
    forward-over-forward fan-out, log|det J| by ``slogdet``; also with the
    Hutchinson term), against the JAX engine: gradients to 1e-12 and
    Laplacians to 1e-10 relative to the largest entry, called under
    ``torch.no_grad()`` as the loss calls it;
  * chunkings of the batched basis against each other and against the
    column loop, for the analytic and the generic engines;
  * the identity flow's kinetic energy sum |k|^2;
  * ``gram_inverse_single`` against both packages' references;
  * ``logdet_spd_single`` under ``jacrev`` of ``jacrev``, ``vmap`` over a
    cotangent basis with the matrix unbatched and batched cotangents.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import coulombgas_tpu as cg
from coulombgas_tpu.ops.logdet import gram_inverse_single as jax_gram_inverse_single
from coulombgas_tpu.wavefunction.fast_laplacian import (
    make_logpsi_grad_laplacian_analytic as jax_make_gl,
)
from coulombgas_tpu_torch.models.ferminet import ferminet_apply
from coulombgas_tpu_torch.models.ferminet_jac import (
    ferminet_apply_and_jac, ferminet_apply_jac_lap,
)
from coulombgas_tpu_torch.ops.logdet import gram_inverse_single, logdet_spd_single
from coulombgas_tpu_torch.wavefunction.fast_laplacian import (
    make_logpsi_grad_laplacian_analytic,
)
from coulombgas_tpu_torch.wavefunction import logpsi as logpsi_mod
from coulombgas_tpu_torch.wavefunction.logpsi import (
    columns_per_pass, make_logpsi, make_logpsi_grad_laplacian,
)

from _torch_helpers import flow_pair, orbitals, t, walkers

TOL_GRAD, TOL_LAP = 1e-12, 1e-10


def assert_rel(got, ref, tol, what=""):
    """max |got - ref| within ``tol`` of the largest |ref|."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, "%s: relative error %g > %g" % (what, err, tol)


def _case(dim, batch=3, seed=1):
    n = 7 if dim == 2 else 5
    sp = orbitals(dim, 9 if dim == 2 else 3)
    cfg, params, flow = flow_pair(2, 8, 8, n, dim, seed=seed, stddev=0.1)
    x, si = walkers(np.random.default_rng(seed), batch, n, dim, sp.shape[0])
    return dict(sp=sp, cfg=cfg, params=params, flow=flow, x=x, si=si, L=cfg.L)


# (dim, analytic flow Jacobian?): the analytic Jacobian in 2D, flow_apply alone in 3D
CASES = [(2, True), (3, False)]
KEY = 5


@pytest.fixture(scope="module")
def refs():
    out = {}
    for dim, analytic in CASES:
        c = _case(dim)
        cfg = c["cfg"]
        flow_apply = lambda p, q, cfg=cfg: cg.ferminet_apply(p, cfg, q)
        jac_lap = ((lambda p, q, cfg=cfg: cg.ferminet_apply_jac_lap(p, cfg, q))
                   if analytic else None)
        key = jax.random.PRNGKey(KEY)
        args = (jnp.asarray(c["x"]), c["params"], jnp.asarray(c["si"]), key)
        res = {h: jax.tree.map(np.asarray, jax.jit(jax_make_gl(
            flow_apply, c["sp"], c["L"], hutchinson=h, flow_jac_lap=jac_lap))(*args))
            for h in ((False, True) if not analytic else (False,))}
        v = np.asarray(jax.random.normal(key, c["x"].shape, jnp.float64))
        out[dim, analytic] = dict(case=c, res=res, v=v)
    return out


def _engine(c, analytic, **kw):
    if analytic:
        return make_logpsi_grad_laplacian_analytic(
            c["sp"], c["L"], ferminet_apply_jac_lap, flow_jac=ferminet_apply_and_jac, **kw)
    return make_logpsi_grad_laplacian_analytic(c["sp"], c["L"], flow_apply=ferminet_apply, **kw)


@pytest.mark.parametrize("dim,analytic", CASES)
@pytest.mark.parametrize("forloop", [False, True])
def test_exact_analytic_engine_matches_jax(refs, dim, analytic, forloop):
    r = refs[dim, analytic]
    c = r["case"]
    g_ref, lap_ref = r["res"][False]
    fn = _engine(c, analytic, hutchinson=False, forloop=forloop)
    with torch.no_grad():  # as train/loss.py calls it
        g, lap = fn(t(c["x"]), c["flow"], t(c["si"]))
    assert g.dtype == torch.complex128 and not g.requires_grad and not lap.requires_grad
    assert_rel(g.numpy(), g_ref, TOL_GRAD, "grad")
    assert_rel(lap.numpy(), lap_ref, TOL_LAP, "laplacian")
    # the exact engine draws no probe
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    g2, lap2 = fn(t(c["x"]), c["flow"], t(c["si"]), gen)
    assert torch.equal(gen.get_state(), state)
    assert torch.equal(g2, g) and torch.equal(lap2, lap)


def test_hutchinson_without_an_analytic_jacobian_matches_jax(refs):
    r = refs[3, False]
    c = r["case"]
    g_ref, lap_ref = r["res"][True]
    with torch.no_grad():
        g, lap = _engine(c, False, hutchinson=True)(t(c["x"]), c["flow"], t(c["si"]), v=t(r["v"]))
    assert_rel(g.numpy(), g_ref, TOL_GRAD, "grad")
    assert_rel(lap.numpy(), lap_ref, TOL_LAP, "laplacian")


@pytest.mark.parametrize("engine", ["analytic", "generic"])
def test_basis_chunkings_agree_with_each_other_and_the_loop(monkeypatch, engine):
    c = _case(2, batch=2)
    x, si, flow = t(c["x"]), t(c["si"]), c["flow"]
    if engine == "analytic":
        build = lambda **kw: _engine(c, True, hutchinson=False, **kw)  # noqa: E731
    else:
        logpsi = make_logpsi(ferminet_apply, c["sp"], c["L"])
        build = lambda **kw: make_logpsi_grad_laplacian(logpsi, **kw)  # noqa: E731
    nd = x.shape[1] * x.shape[2]
    # the rule's ends: one a pass with forloop, never more than the basis
    assert columns_per_pass(nd, forloop=True) == 1
    assert columns_per_pass(2, forloop=False) == min(2, logpsi_mod.COLUMNS_PER_PASS)
    g0, lap0 = build(forloop=True)(x, flow, si)
    # 3 and 5 a pass (divisors of neither nd nor 2 nd), the shipped rule, all at once
    for k in (3, 5, logpsi_mod.COLUMNS_PER_PASS, 2 * nd):
        monkeypatch.setattr(logpsi_mod, "COLUMNS_PER_PASS", k)
        g, lap = build()(x, flow, si)
        assert torch.equal(g, g0)
        assert_rel(lap.numpy(), lap0.numpy(), 1e-12, "%d a pass vs one a pass" % k)


def test_identity_flow_kinetic_energy_is_sum_k_squared():
    c = _case(2, batch=2)
    with torch.no_grad():
        for p in c["flow"].parameters():
            p.zero_()
    for analytic in (True, False):
        g, lap = _engine(c, analytic, hutchinson=False)(t(c["x"]), c["flow"], t(c["si"]))
        kinetic = -lap - (g**2).sum(dim=(-2, -1))
        k2 = ((2 * np.pi / c["L"] * c["sp"][c["si"]]) ** 2).sum(axis=(-2, -1))
        np.testing.assert_allclose(kinetic.real.numpy(), k2, rtol=1e-10)
        np.testing.assert_allclose(kinetic.imag.numpy(), 0, atol=1e-9)


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_gram_inverse_single_matches_both_references(kind):
    rng = np.random.default_rng(3)
    D = rng.normal(size=(4, 6, 6)) + (1j * rng.normal(size=(4, 6, 6)) if kind == "complex" else 0)
    got = gram_inverse_single(torch.from_numpy(D)).numpy()
    ref = np.asarray(jax.jit(jax.vmap(jax_gram_inverse_single))(jnp.asarray(D)))
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got, np.linalg.inv(D), rtol=1e-9, atol=1e-9)


def test_logdet_rules_under_transforms():
    """The closed-form rules of ``logdet_spd_single`` nest in reverse mode:
    second derivatives by ``jacrev`` of ``jacrev``, by ``vmap`` over a
    cotangent basis with the matrix itself unbatched, and by
    ``autograd.grad(is_grads_batched=True)`` as the exact Laplacian takes
    them, equal those of ``torch.logdet`` in every symmetric direction (the
    rules take A, and so A^-1, symmetric, as A = J J^T and its tangents are)."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2, 5, 5))
    A = torch.from_numpy(X @ X.transpose(0, 2, 1) + 5 * np.eye(5))
    basis = torch.eye(25, dtype=A.dtype).reshape(25, 5, 5)
    sym = (basis + basis.transpose(-1, -2)).reshape(25, 25)  # spans the symmetric directions

    def sym_hessian(H):
        return (sym @ H.reshape(25, 25) @ sym.T).numpy()

    # the reference one matrix at a time: torch 2.13's own
    # vmap(hessian(torch.logdet)) gives other numbers
    H_refs = [sym_hessian(torch.func.hessian(torch.logdet)(a)) for a in A]
    for a, H_ref in zip(A, H_refs):
        grad_fn = torch.func.grad(logdet_spd_single)
        np.testing.assert_allclose(grad_fn(a).numpy(), torch.linalg.inv(a).T.numpy(), rtol=1e-10)
        _, vjp = torch.func.vjp(grad_fn, a)
        rows = torch.func.vmap(vjp)(basis)[0]  # cotangent basis, a unbatched
        np.testing.assert_allclose(sym_hessian(rows), H_ref, rtol=1e-10, atol=1e-12)
        H = torch.func.jacrev(torch.func.jacrev(logdet_spd_single))(a)
        np.testing.assert_allclose(sym_hessian(H), H_ref, rtol=1e-10, atol=1e-12)
    # batched over matrices: vmap, and the batched cotangents of the engines
    H = torch.func.vmap(torch.func.jacrev(torch.func.jacrev(logdet_spd_single)))(A)
    Ag = A.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(logdet_spd_single(Ag).sum(), Ag, create_graph=True)
    (rows,) = torch.autograd.grad(g, Ag, basis[:, None].expand(-1, 2, -1, -1),
                                  is_grads_batched=True)  # (25, 2, 5, 5)
    for b, H_ref in enumerate(H_refs):
        np.testing.assert_allclose(sym_hessian(H[b]), H_ref, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(sym_hessian(rows[:, b]), H_ref, rtol=1e-10, atol=1e-12)
