"""The depth-2 closed form of the flow Jacobian and Laplacian in the port:
against the JAX package's closures and the port's own carried-state form
(f64, 1e-10: plain algebra), and — as the plain versions of the closure
kernels — against the Pallas kernels in interpret mode (f32; u, J atol 1e-5,
lap 2e-4, the JAX tests' own bounds).  Then the two places that take the
kernels: the Metropolis logp (``use_d2_flow``) and the kinetic-energy engine
(``flow_jac_lap_batched``).  On CPU tensors the wrappers take the plain
versions.
"""

import glob
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import coulombgas_tpu as cg
from coulombgas_tpu.models.ferminet_jac import (
    ferminet_apply_and_jac_d2 as jax_jac_d2,
    ferminet_apply_jac_lap_d2 as jax_jac_lap_d2,
)
from coulombgas_tpu.ops.pallas_flow_jac import flow_u_jac_lap_pallas_d2, flow_u_jac_pallas_d2
from coulombgas_tpu_torch.models.ferminet_jac import (
    ferminet_apply_and_jac, ferminet_apply_and_jac_d2, ferminet_apply_jac_lap,
    ferminet_apply_jac_lap_d2, select_flow_jac,
)
from coulombgas_tpu_torch.ops import counters, cuda_flow_d2
from coulombgas_tpu_torch.wavefunction.fast_laplacian import (
    make_logpsi_grad_laplacian_analytic,
)
from coulombgas_tpu_torch.wavefunction.fast_logp import make_logp_fast

from _torch_helpers import box, flow_pair, orbitals, t, walkers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (dim, spsize, tpsize, n)
CASES = [(2, 6, 5, 4), (2, 8, 4, 7), (3, 8, 8, 4), (3, 4, 6, 7)]


def _x(n, dim, batch=3, seed=1, dtype=np.float64):
    return np.random.default_rng(seed).uniform(0, box(n, dim), (batch, n, dim)).astype(dtype)


@pytest.mark.parametrize("dim,spsize,tpsize,n", CASES)
def test_jac_d2_matches_jax(dim, spsize, tpsize, n):
    """u and J element by element (a log-det is blind to a permuted J)."""
    cfg, params, flow = flow_pair(2, spsize, tpsize, n, dim)
    x = _x(n, dim)
    ref = jax.jit(jax.vmap(lambda q: jax_jac_d2(params, cfg, q)))(jnp.asarray(x))
    with torch.no_grad():
        got = ferminet_apply_and_jac_d2(flow, t(x))
    assert got[1].shape == (x.shape[0], n * dim, n * dim)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("dim,spsize,tpsize,n", CASES)
def test_jac_lap_d2_matches_jax(dim, spsize, tpsize, n):
    cfg, params, flow = flow_pair(2, spsize, tpsize, n, dim)
    x = _x(n, dim)
    ref = jax.jit(jax.vmap(lambda q: jax_jac_lap_d2(params, cfg, q)))(jnp.asarray(x))
    with torch.no_grad():
        got = ferminet_apply_jac_lap_d2(flow, t(x))
    assert got[2].shape == (x.shape[0], n * dim)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("dim,spsize,tpsize,n", CASES)
def test_d2_closures_match_the_carried_form(dim, spsize, tpsize, n):
    """Same flow, two derivations: equal to roundoff, also for one walker and
    with two coincident particles (the guarded 1/d and 1/d^3)."""
    _, _, flow = flow_pair(2, spsize, tpsize, n, dim)
    x = t(_x(n, dim))
    x[0, 1] = x[0, 0]
    with torch.no_grad():
        carried = ferminet_apply_jac_lap(flow, x)
        closed = ferminet_apply_jac_lap_d2(flow, x)
        u, J = ferminet_apply_and_jac_d2(flow, x)
        one = ferminet_apply_jac_lap_d2(flow, x[1])
    for a, b in zip(closed, carried):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10, atol=1e-10)
    assert torch.equal(u, closed[0]) and torch.equal(J, closed[1])
    for a, b in zip(one, closed):
        np.testing.assert_allclose(a.numpy(), b[1].numpy(), rtol=1e-12, atol=1e-12)


def test_d2_closure_is_differentiable():
    """The closure serves the Hutchinson term too (``--flow_jac d2``): its
    gradient in x equals the carried form's."""
    _, _, flow = flow_pair(2, 6, 5, 4, 2)
    grads = []
    for fn in (ferminet_apply_and_jac, ferminet_apply_and_jac_d2):
        x = t(_x(4, 2)).requires_grad_(True)
        u, J = fn(flow, x)
        (g,) = torch.autograd.grad((J**2).sum() + u.sum(), x)
        grads.append(g)
    np.testing.assert_allclose(grads[1].numpy(), grads[0].numpy(), rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("lap", [False, True], ids=["flow_u_jac_d2", "flow_u_jac_lap_d2"])
def test_plain_versions_match_pallas_d2_kernels_interpret(lap, dim):
    """The kernels' plain versions against the TPU kernels themselves
    (interpret mode, f32), through the wrappers on CPU tensors."""
    n = 4
    cfg, params, flow = flow_pair(2, 16, 16, n, dim, dtype=np.float32, stddev=0.05)
    x = _x(n, dim, batch=5, dtype=np.float32)
    if lap:
        ref = flow_u_jac_lap_pallas_d2(params, cfg, jnp.asarray(x), interpret=True)
        got = cuda_flow_d2.flow_u_jac_lap_d2_cuda(flow, t(x))
    else:
        ref = flow_u_jac_pallas_d2(params, cfg, jnp.asarray(x), interpret=True)
        got = cuda_flow_d2.flow_u_jac_d2_cuda(flow, t(x))
    for g, r, atol in zip(got, ref, (1e-5, 1e-5, 2e-4)):
        np.testing.assert_allclose(g.numpy(), np.moveaxis(np.asarray(r), -1, 0), atol=atol)


def test_wrappers_take_plain_versions_only_for_cpu_tensors():
    _, _, flow = flow_pair(2, 8, 8, 5, 2)
    x = t(_x(5, 2))
    before = dict(counters.launches)
    u, J = cuda_flow_d2.flow_u_jac_d2_cuda(flow, x)
    ul, Jl, lap = cuda_flow_d2.flow_u_jac_lap_d2_cuda(flow, x)
    assert counters.launches == before  # no kernel was launched
    assert not (u.requires_grad or J.requires_grad or lap.requires_grad)
    with torch.no_grad():
        ref = cuda_flow_d2.flow_u_jac_lap_d2_plain(flow, x)
    assert all(torch.equal(a, b) for a, b in zip((ul, Jl, lap), ref))
    assert torch.equal(u, ref[0]) and torch.equal(J, ref[1])
    with pytest.raises(ValueError):  # one walker without a batch axis
        cuda_flow_d2.flow_u_jac_d2_cuda(flow, x[0])
    with pytest.raises(ValueError, match="no backward"):  # never a silently detached result
        cuda_flow_d2.flow_u_jac_lap_d2_cuda(flow, x.clone().requires_grad_(True))


def _logp_case():
    n, dim = 5, 2
    sp = orbitals(dim, 9)
    cfg, params, flow = flow_pair(2, 8, 8, n, dim, stddev=0.1)
    x, si = walkers(np.random.default_rng(3), 6, n, dim, sp.shape[0])
    return n, sp, cfg, params, flow, x, si


def test_logp_with_d2_flow_matches_slogdet_oracle():
    """``use_d2_flow``: closure flow -> fused tail, against the generic
    assembly (two LU slogdets per walker) of the JAX package."""
    n, sp, cfg, params, flow, x, si = _logp_case()
    slow = cg.make_logp(cg.make_logpsi(lambda p, q: cg.ferminet_apply(p, cfg, q), sp, cfg.L))
    ref = np.asarray(jax.jit(slow)(jnp.asarray(x), params, jnp.asarray(si)))
    counts = dict(counters.launches)
    got = make_logp_fast(sp, cfg.L, use_d2_flow=True)(t(x), flow, t(si))
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-8, atol=1e-8)
    assert counts == counters.launches
    # chunked evaluation gives the same numbers
    chunked = make_logp_fast(sp, cfg.L, use_d2_flow=True, chunk=3)(t(x), flow, t(si))
    np.testing.assert_allclose(chunked.numpy(), got.numpy(), rtol=1e-12, atol=1e-12)


def test_grad_laplacian_with_batched_hook_matches_unhooked():
    """``flow_jac_lap_batched`` replaces the primal flow of the Slater part
    only; with the closure behind it the engine's results do not move."""
    n, sp, cfg, params, flow, x, si = _logp_case()
    v = t(np.random.default_rng(5).normal(size=x.shape))
    calls = []

    def hook(flow_, x_):
        calls.append(tuple(x_.shape))
        assert not torch.is_grad_enabled()
        return cuda_flow_d2.flow_u_jac_lap_d2_cuda(flow_, x_)

    plain = make_logpsi_grad_laplacian_analytic(sp, cfg.L, ferminet_apply_jac_lap,
                                                flow_jac=ferminet_apply_and_jac)
    hooked = make_logpsi_grad_laplacian_analytic(sp, cfg.L, ferminet_apply_jac_lap,
                                                 flow_jac=ferminet_apply_and_jac,
                                                 flow_jac_lap_batched=hook)
    g0, l0 = plain(t(x), flow, t(si), v=v)
    g1, l1 = hooked(t(x), flow, t(si), v=v)
    assert calls == [tuple(x.shape)]  # one call for the whole batch
    np.testing.assert_allclose(g1.numpy(), g0.numpy(), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(l1.numpy(), l0.numpy(), rtol=1e-10, atol=1e-10)


def test_depth_3_is_refused_everywhere():
    cfg, _, flow = flow_pair(3, 6, 6, 4, 2)
    x = t(_x(4, 2))
    sp = orbitals(2, 4)
    si = t(walkers(np.random.default_rng(0), 3, 4, 2, sp.shape[0])[1])
    with pytest.raises(ValueError, match="depth"):
        select_flow_jac(flow.cfg, "d2")
    for fn in (ferminet_apply_and_jac_d2, ferminet_apply_jac_lap_d2,
               cuda_flow_d2.flow_u_jac_d2_cuda, cuda_flow_d2.flow_u_jac_lap_d2_cuda):
        with pytest.raises(ValueError, match="depth"):
            fn(flow, x)
    with pytest.raises(ValueError, match="depth"):  # requested kernel: launches or fails
        make_logp_fast(sp, cfg.L, use_d2_flow=True)(x, flow, si)


def test_port_and_its_scripts_import_neither_jax_nor_the_jax_package():
    files = glob.glob(os.path.join(ROOT, "coulombgas_tpu_torch", "**", "*.py"), recursive=True)
    files += [os.path.join(ROOT, f) for f in
              ("chip_smoke.py", "main_torch.py", "scripts/profile_torch_step.py")]
    assert len(files) > 25
    pat = re.compile(r"^\s*(import|from)\s+(jax|optax|coulombgas_tpu)(\s|\.|$)", re.M)
    for f in files:
        assert not pat.search(open(f).read()), f
