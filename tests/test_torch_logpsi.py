"""The port's generic-AD log Psi against the JAX package (f64 on the CPU).

  * ``make_logpsi`` (``jacfwd`` of the flow, ``slogdet``),
    ``make_logphi_logjacdet`` and ``make_logp`` against the JAX functions;
  * every engine of ``make_logpsi_grad_laplacian`` — exact in batched passes,
    exact column by column, full Hutchinson, split Hutchinson with JAX's own
    probe ``jax.random.normal(key, x.shape)`` — over ``make_logpsi`` and over
    ``make_logpsi_fast``: gradients to 1e-12 and Laplacians to 1e-10,
    relative to the largest entry, with the caller's grad mode on and under
    ``torch.no_grad()`` (PyTorch's backward of ``slogdet`` differs under an
    outer ``no_grad``; the engines switch grad mode on themselves);
  * the quantum score through ``make_logpsi`` (``vmap(jacrev)`` over the
    parameters of a function that runs ``jacfwd`` over coordinates);
  * the identities of tests/test_logpsi.py: kinetic energy sum |k|^2 at the
    identity flow, periodicity, antisymmetry, translation invariance of logp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import coulombgas_tpu as cg
from coulombgas_tpu.optim import sr as jax_sr
from coulombgas_tpu_torch.models.ferminet import ferminet_apply
from coulombgas_tpu_torch.models.ferminet_jac import ferminet_apply_and_jac
from coulombgas_tpu_torch.wavefunction.logpsi import (
    make_logp, make_logphi_logjacdet, make_logpsi, make_logpsi_fast,
    make_logpsi_grad_laplacian, make_quantum_score,
)

from _torch_helpers import flow_pair, orbitals, t, walkers

TOL_GRAD, TOL_LAP = 1e-12, 1e-10


def assert_rel(got, ref, tol, what=""):
    """max |got - ref| within ``tol`` of the largest |ref|."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, "%s: relative error %g > %g" % (what, err, tol)


def _wrap(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


def _case(dim, n=None, batch=3, seed=0):
    n = n or (6 if dim == 2 else 5)
    sp = orbitals(dim, 9 if dim == 2 else 3)
    cfg, params, flow = flow_pair(2, 8, 8, n, dim, seed=seed, stddev=0.1)
    x, si = walkers(np.random.default_rng(seed + dim), batch, n, dim, sp.shape[0])
    return dict(sp=sp, cfg=cfg, params=params, flow=flow, x=x, si=si, L=cfg.L)


def _jax_fns(c):
    cfg = c["cfg"]
    flow_apply = lambda p, q: cg.ferminet_apply(p, cfg, q)
    jac = lambda p, q: cg.ferminet_apply_and_jac(p, cfg, q)
    logphi, logjacdet = cg.make_logphi_logjacdet(flow_apply, c["sp"], c["L"])
    return {"generic": cg.make_logpsi(flow_apply, c["sp"], c["L"]),
            "fast": cg.make_logpsi_fast(jac, c["sp"], c["L"]),
            "logphi": logphi, "logjacdet": logjacdet}


def _torch_fns(c):
    logphi, logjacdet = make_logphi_logjacdet(ferminet_apply, c["sp"], c["L"])
    return {"generic": make_logpsi(ferminet_apply, c["sp"], c["L"]),
            "fast": make_logpsi_fast(ferminet_apply_and_jac, c["sp"], c["L"]),
            "logphi": logphi, "logjacdet": logjacdet}


@pytest.mark.parametrize("dim", [2, 3])
def test_logpsi_logphi_logjacdet_and_logp_match_jax(dim):
    c = _case(dim)
    fj, ft = _jax_fns(c), _torch_fns(c)
    x, si, flow = t(c["x"]), t(c["si"]), c["flow"]

    @jax.jit
    def refs(X, P, S):
        return (jax.vmap(fj["generic"], (0, None, 0))(X, P, S),
                jax.vmap(fj["logphi"], (0, None, 0))(X, P, S),
                jax.vmap(fj["logjacdet"], (0, None))(X, P),
                cg.make_logp(fj["generic"])(X, P, S))

    ref, ref_phi, ref_ljd, ref_lp = map(np.asarray, refs(
        jnp.asarray(c["x"]), c["params"], jnp.asarray(c["si"])))
    got = ft["generic"](x, flow, si).detach().numpy()
    assert got.shape == (3, 2)
    np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(_wrap(got[:, 1] - ref[:, 1]), 0, atol=1e-10)
    with torch.no_grad():
        phi = ft["logphi"](x, flow, si).numpy()
        ljd = ft["logjacdet"](x, flow).numpy()
        lp = make_logp(ft["generic"])(x, flow, si)
        fast = ft["fast"](x, flow, si).numpy()
    np.testing.assert_allclose(phi[:, 0], ref_phi[:, 0], rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(_wrap(phi[:, 1] - ref_phi[:, 1]), 0, atol=1e-10)
    np.testing.assert_allclose(ljd, ref_ljd, rtol=1e-10, atol=1e-12)
    assert not lp.requires_grad
    np.testing.assert_allclose(lp.numpy(), ref_lp, rtol=1e-10, atol=1e-10)
    # the generic and the fast log Psi agree (the fast one is held against
    # JAX in tests/test_torch_wavefunction.py)
    np.testing.assert_allclose(fast[:, 0], got[:, 0], rtol=1e-10, atol=1e-10)


ENGINES = {
    "exact": dict(),
    "exact_forloop": dict(forloop=True),
    "full_hutchinson": dict(hutchinson=True),
    "split_hutchinson": dict(hutchinson=True, split=True),
}
# (log Psi, dim): the generic one in 2D, the fast one (analytic flow Jacobian,
# Gram-Cholesky log-det) in 3D
CASES = [("generic", 2), ("fast", 3)]
KEY = 7


@pytest.fixture(scope="module")
def engine_refs():
    """JAX's exact, full-Hutchinson and split-Hutchinson results per case.  The
    JAX package holds its own column loop equal
    to its batched basis (tests/test_logpsi.py), so the port's loop is held
    against the batched result."""
    out = {}
    for psi, dim in CASES:
        c = _case(dim, batch=2)
        fj = _jax_fns(c)
        key = jax.random.PRNGKey(KEY)
        split = dict(logphi=fj["logphi"], logjacdet=fj["logjacdet"])
        fns = {name: cg.make_logpsi_grad_laplacian(fj[psi], hutchinson=name != "exact",
                                                   **(split if name == "split_hutchinson" else {}))[1]
               for name in ("exact", "full_hutchinson", "split_hutchinson")}
        res = {k: jax.jit(f)(jnp.asarray(c["x"]), c["params"], jnp.asarray(c["si"]), key)
               for k, f in fns.items()}
        res["exact_forloop"] = res["exact"]
        v = np.asarray(jax.random.normal(key, c["x"].shape, jnp.float64))  # JAX's own probe
        out[psi, dim] = dict(case=c, v=v, res=jax.tree.map(np.asarray, res))
    return out


@pytest.mark.parametrize("psi,dim", CASES)
@pytest.mark.parametrize("engine", list(ENGINES))
def test_engines_match_jax(engine_refs, engine, psi, dim):
    ref = engine_refs[psi, dim]
    c, v = ref["case"], ref["v"]
    g_ref, lap_ref = ref["res"][engine]
    ft = _torch_fns(c)
    kw = dict(ENGINES[engine])
    if kw.pop("split", False):
        kw.update(logphi=ft["logphi"], logjacdet=ft["logjacdet"])
    gl = make_logpsi_grad_laplacian(ft[psi], **kw)
    args = (t(c["x"]), c["flow"], t(c["si"]))
    g, lap = gl(*args, v=t(v))
    assert g.dtype == torch.complex128 and lap.shape == (2,)
    assert not g.requires_grad and not lap.requires_grad
    assert_rel(g.numpy(), g_ref, TOL_GRAD, "grad")
    assert_rel(lap.numpy(), lap_ref, TOL_LAP, "laplacian")
    with torch.no_grad():  # C-watch-7: the caller's grad mode does not matter
        g2, lap2 = gl(*args, v=t(v))
    assert_rel(g2.numpy(), g_ref, TOL_GRAD, "grad under no_grad")
    assert_rel(lap2.numpy(), lap_ref, TOL_LAP, "laplacian under no_grad")


def test_hutchinson_probe_comes_from_the_generator():
    c = _case(2, batch=2)
    gl = make_logpsi_grad_laplacian(_torch_fns(c)["generic"], hutchinson=True)
    args = (t(c["x"]), c["flow"], t(c["si"]))
    g1, l1 = gl(*args, torch.Generator().manual_seed(3))
    g2, l2 = gl(*args, torch.Generator().manual_seed(3))
    g3, l3 = gl(*args, torch.Generator().manual_seed(4))
    assert torch.equal(l1, l2) and torch.equal(g1, g2) and not torch.equal(l1, l3)
    np.testing.assert_allclose(g1.numpy(), g3.numpy(), rtol=1e-13)  # only the Laplacian draws


def test_quantum_score_through_make_logpsi_matches_jax():
    c = _case(2, n=5, batch=3)
    fj, ft = _jax_fns(c), _torch_fns(c)
    ref = jax_sr._ravel_batch(jax.jit(cg.make_quantum_score(fj["generic"]))(
        jnp.asarray(c["x"]), c["params"], jnp.asarray(c["si"])))
    score = make_quantum_score(ft["generic"])
    got = score(t(c["x"]), c["flow"], t(c["si"]))
    assert got.shape == ref.shape and got.dtype == torch.complex128
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-8, atol=1e-10)
    assert np.abs(np.asarray(ref).imag).max() > 1e-3
    with torch.no_grad():
        again = score(t(c["x"]), c["flow"], t(c["si"]))
    assert torch.equal(again, got)


@pytest.mark.parametrize("engine", ["exact", "exact_forloop"])
def test_identity_flow_kinetic_energy_is_sum_k_squared(engine):
    c = _case(3, n=7, batch=2)
    logpsi = make_logpsi(lambda flow, q: q, c["sp"], c["L"])
    gl = make_logpsi_grad_laplacian(logpsi, forloop=engine == "exact_forloop")
    g, lap = gl(t(c["x"]), c["flow"], t(c["si"]))
    kinetic = -lap - (g**2).sum(dim=(-2, -1))
    k2 = ((2 * np.pi / c["L"] * c["sp"][c["si"]]) ** 2).sum(axis=(-2, -1))
    np.testing.assert_allclose(kinetic.real.numpy(), k2, rtol=1e-10)
    np.testing.assert_allclose(kinetic.imag.numpy(), 0, atol=1e-9)


def test_periodicity_antisymmetry_and_translation_invariance():
    c = _case(3, n=7, batch=2)
    L = c["L"]
    logpsi = make_logpsi(ferminet_apply, c["sp"], L)
    x, si, flow = t(c["x"]), t(c["si"]), c["flow"]
    with torch.no_grad():
        lp = logpsi(x, flow, si)
        shift = torch.zeros_like(x)
        shift[:, 2] = torch.tensor([L, 0.0, 2 * L], dtype=x.dtype)
        np.testing.assert_allclose(logpsi(x + shift, flow, si)[:, 0].numpy(),
                                   lp[:, 0].numpy(), atol=1e-9)
        perm = list(range(x.shape[1]))
        perm[0], perm[1] = 1, 0
        lp_perm = logpsi(x[:, perm], flow, si)
        np.testing.assert_allclose(lp_perm[:, 0].numpy(), lp[:, 0].numpy(), atol=1e-9)
        dphi = (lp_perm[:, 1] - lp[:, 1]).numpy()
        np.testing.assert_allclose(np.abs(np.abs(dphi) % (2 * np.pi) - np.pi), 0, atol=1e-9)
        logp = make_logp(logpsi)
        a = torch.from_numpy(np.random.default_rng(9).normal(size=(1, 1, 3)))
        np.testing.assert_allclose(logp(x + a, flow, si).numpy(), logp(x, flow, si).numpy(),
                                   atol=1e-8)
