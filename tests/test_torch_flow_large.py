"""The row-chunked depth-2 flow (the port's ``ops/cuda_flow_large``): its
plain version against the TPU kernels themselves in interpret mode (f32,
u and J atol 1e-5, the JAX tests' own bound) and against the JAX package's
analytic Jacobian (f64, 1e-10: the same algebra in another order); then the
Metropolis logp on that route (``use_large_flow``) against the JAX package's
route through the same Pallas kernels and the fused tail in interpret mode,
the precedence of the closure kernel over it, and the requests it refuses.
On CPU tensors the wrapper takes the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import coulombgas_tpu as cg
from coulombgas_tpu.ops.pallas_flow_jac import flow_u_jac_pallas_large
from coulombgas_tpu.wavefunction.fast_logp import make_logp_fast as jax_make_logp_fast
from coulombgas_tpu_torch.ops import counters, cuda_flow_large
from coulombgas_tpu_torch.wavefunction import fast_logp
from coulombgas_tpu_torch.wavefunction.fast_logp import make_logp_fast

from _torch_helpers import box, flow_pair, orbitals, t, walkers


def _x(n, dim, batch, seed=1, dtype=np.float64):
    return np.random.default_rng(seed).uniform(0, box(n, dim), (batch, n, dim)).astype(dtype)


@pytest.mark.parametrize("dim,n", [(2, 9), (3, 8)])
def test_plain_version_matches_pallas_large_kernels_interpret(dim, n):
    """u and J element by element (a log-det is blind to a permuted J), with
    a batch of 9 that is no multiple of anything and two coincident
    particles (the guarded 1 / d of the pair distance)."""
    cfg, params, flow = flow_pair(2, 16, 16, n, dim, dtype=np.float32, stddev=0.1)
    x = _x(n, dim, 9, dtype=np.float32)
    x[0, 1] = x[0, 0]
    u_t, J_t = flow_u_jac_pallas_large(params, cfg, jnp.asarray(x), interpret=True)
    before = dict(counters.launches)
    u, J = cuda_flow_large.flow_u_jac_large_cuda(flow, t(x))
    assert counters.launches == before  # a CPU tensor launches nothing
    assert u.shape == (9, n, dim) and J.shape == (9, n * dim, n * dim)
    np.testing.assert_allclose(u.numpy(), np.moveaxis(np.asarray(u_t), -1, 0), atol=1e-5)
    np.testing.assert_allclose(J.numpy(), np.moveaxis(np.asarray(J_t), -1, 0), atol=1e-5)


@pytest.mark.parametrize("dim,n", [(2, 9), (3, 8)])
def test_plain_version_matches_jax_analytic_jacobian_f64(dim, n):
    cfg, params, flow = flow_pair(2, 6, 5, n, dim)
    x = _x(n, dim, 4)
    ref = jax.jit(jax.vmap(lambda q: cg.ferminet_apply_and_jac(params, cfg, q)))(jnp.asarray(x))
    with torch.no_grad():
        got = cuda_flow_large.flow_u_jac_large_ref(flow, t(x))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-10, atol=1e-10)


def _logp_case(dtype=np.float64, batch=6):
    n, dim = 5, 2
    sp = orbitals(dim, 9, dtype)
    cfg, params, flow = flow_pair(2, 8, 8, n, dim, dtype=dtype, stddev=0.1)
    x, si = walkers(np.random.default_rng(3), batch, n, dim, sp.shape[0], dtype)
    return sp, cfg, params, flow, x, si


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-8), (np.float32, 5e-3)],
                         ids=["f64", "f32"])
def test_logp_with_large_flow_matches_jax_large_flow_route(dtype, tol):
    """The JAX package's ``use_large_flow`` route (row-chunked Pallas kernels
    -> fused Pallas tail, both in interpret mode) against the port's; f32
    at the reference tests' own bound for a logp (5e-3)."""
    sp, cfg, params, flow, x, si = _logp_case(dtype)
    flow_apply = lambda p, q: cg.ferminet_apply(p, cfg, q)  # noqa: E731
    jax_fn = jax_make_logp_fast(flow_apply, sp, cfg.L, jacobian=lambda p, q: cg.ferminet_apply_and_jac(
        p, cfg, q), pallas_flow_cfg=cfg, use_large_flow=True, fused_interpret=True)
    ref = np.asarray(jax_fn(jnp.asarray(x), params, jnp.asarray(si)))
    counts = dict(counters.launches)
    got = make_logp_fast(sp, cfg.L, use_large_flow=True)(t(x), flow, t(si))
    assert not got.requires_grad and got.dtype == t(x).dtype
    np.testing.assert_allclose(got.numpy(), ref, rtol=0 if tol > 1e-6 else tol, atol=tol)
    assert counts == counters.launches
    chunked = make_logp_fast(sp, cfg.L, use_large_flow=True, chunk=3)(t(x), flow, t(si))
    np.testing.assert_allclose(chunked.numpy(), got.numpy(), rtol=1e-12, atol=1e-12)


def test_closure_kernel_wins_over_large_flow(monkeypatch):
    """With both flags, as in the JAX package, the depth-2 closure kernel
    runs; with ``use_large_flow`` alone the row-chunked kernel does, and the
    carried-state flow kernel never."""
    sp, cfg, params, flow, x, si = _logp_case()
    calls = []
    for name in ("flow_u_jac_d2_cuda", "flow_u_jac_large_cuda", "flow_u_jac_cuda"):
        real = getattr(fast_logp, name)
        monkeypatch.setattr(fast_logp, name,
                            lambda f, q, real=real, name=name: calls.append(name) or real(f, q))
    both = make_logp_fast(sp, cfg.L, use_large_flow=True, use_d2_flow=True)(t(x), flow, t(si))
    assert calls == ["flow_u_jac_d2_cuda"]
    large = make_logp_fast(sp, cfg.L, use_large_flow=True)(t(x), flow, t(si))
    assert calls == ["flow_u_jac_d2_cuda", "flow_u_jac_large_cuda"]
    np.testing.assert_allclose(both.numpy(), large.numpy(), rtol=1e-10, atol=1e-10)


def test_large_flow_requests_that_cannot_be_met_raise():
    sp, cfg, params, flow, x, si = _logp_case()
    with pytest.raises(ValueError, match="use_fused"):
        make_logp_fast(sp, cfg.L, use_large_flow=True, use_fused=False, use_flow_kernel=False)
    _, _, flow3 = flow_pair(3, 6, 6, 5, 2)
    with pytest.raises(ValueError, match="depth"):  # a requested kernel launches or fails
        make_logp_fast(sp, cfg.L, use_large_flow=True)(t(x), flow3, t(si))
    with pytest.raises(ValueError, match="depth"):
        cuda_flow_large.flow_u_jac_large_ref(flow3, t(x))
    with pytest.raises(ValueError):  # one walker without a batch axis
        cuda_flow_large.flow_u_jac_large_cuda(flow, t(x)[0])
    with pytest.raises(ValueError, match="no backward"):  # never a silently detached result
        cuda_flow_large.flow_u_jac_large_cuda(flow, t(x).requires_grad_(True))
