"""The port's Metropolis log-density (all three routes) against the JAX
package: ``make_logp_fast(..., use_fused=False, use_pallas=False)`` in f64
(1e-8, through log-dets), and once against the two Pallas kernels back to
back in interpret mode (f32, atol 5e-3 as in tests/test_flow_jac_pallas.py).
On CPU tensors every kernel wrapper of the port takes its plain version.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import coulombgas_tpu as cg
from coulombgas_tpu.wavefunction.fast_logp import make_logp_fast as jax_make_logp_fast
from coulombgas_tpu_torch.ops import counters
from coulombgas_tpu_torch.wavefunction.fast_logp import make_logp_fast

from _torch_helpers import flow_pair, orbitals, t, walkers

ROUTES = {
    "flow_kernel+fused_tail": dict(use_fused=True, use_flow_kernel=True),
    "plain_flow+fused_tail": dict(use_fused=True, use_flow_kernel=False),
    "stacked_chol_logdet": dict(use_fused=False, use_flow_kernel=False),
}


def _case(dim, dtype=np.float64, batch=6):
    n, Emax = (5, 9) if dim == 2 else (4, 3)
    sp = orbitals(dim, Emax, dtype)
    cfg, params, flow = flow_pair(2, 8, 8, n, dim, dtype=dtype, stddev=0.1)
    x, si = walkers(np.random.default_rng(dim), batch, n, dim, sp.shape[0], dtype)
    return n, sp, cfg, params, flow, x, si


def _jax_reference(cfg, params, sp, x, si):
    flow_apply = lambda p, q: cg.ferminet_apply(p, cfg, q)
    jac = lambda p, q: cg.ferminet_apply_and_jac(p, cfg, q)
    fn = jax_make_logp_fast(flow_apply, sp, cfg.L, use_pallas=False, use_fused=False,
                            jacobian=jac)
    return np.asarray(jax.jit(fn)(jnp.asarray(x), params, jnp.asarray(si)))


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("route", list(ROUTES))
def test_logp_routes_match_jax(route, dim):
    n, sp, cfg, params, flow, x, si = _case(dim)
    ref = _jax_reference(cfg, params, sp, x, si)
    counts = dict(counters.launches)
    got = make_logp_fast(sp, cfg.L, **ROUTES[route])(t(x), flow, t(si))
    assert not got.requires_grad and got.shape == (x.shape[0],)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-8, atol=1e-8)
    # CPU tensors: no kernel was launched
    assert counts == counters.launches


def test_logp_matches_slogdet_oracle():
    """Against the generic assembly (two LU slogdets per walker)."""
    n, sp, cfg, params, flow, x, si = _case(2)
    slow = cg.make_logp(cg.make_logpsi(lambda p, q: cg.ferminet_apply(p, cfg, q), sp, cfg.L))
    ref = np.asarray(jax.jit(slow)(jnp.asarray(x), params, jnp.asarray(si)))
    got = make_logp_fast(sp, cfg.L)(t(x), flow, t(si))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-8, atol=1e-8)


def test_logp_chunked_equals_whole_batch():
    n, sp, cfg, params, flow, x, si = _case(2)
    whole = make_logp_fast(sp, cfg.L)(t(x), flow, t(si))
    chunked = make_logp_fast(sp, cfg.L, chunk=2)(t(x), flow, t(si))
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError):
        make_logp_fast(sp, cfg.L, chunk=4)(t(x), flow, t(si))


def test_logp_matches_pallas_kernels_interpret_f32():
    """Main route in f32 against the reference's two-kernel path."""
    n, sp, cfg, params, flow, x, si = _case(2, np.float32, batch=9)
    flow_apply = lambda p, q: cg.ferminet_apply(p, cfg, q)
    jac = lambda p, q: cg.ferminet_apply_and_jac(p, cfg, q)
    all_pallas = jax_make_logp_fast(flow_apply, sp, cfg.L, jacobian=jac,
                                    pallas_flow_cfg=cfg, fused_interpret=True)
    ref = np.asarray(all_pallas(jnp.asarray(x), params, jnp.asarray(si)))
    got = make_logp_fast(sp, cfg.L)(t(x), flow, t(si))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=5e-3)


def test_logp_custom_jacobian_and_unported_options():
    n, sp, cfg, params, flow, x, si = _case(2)
    calls = []

    def jac(flow_, x_):
        calls.append(x_.shape)
        from coulombgas_tpu_torch.models.ferminet_jac import ferminet_apply_and_jac
        return ferminet_apply_and_jac(flow_, x_)

    # the defaults leave both choices to the closure (chosen by size)
    defaults = inspect.signature(make_logp_fast).parameters
    assert defaults["use_fused"].default is None and defaults["use_flow_kernel"].default is None
    a = make_logp_fast(sp, cfg.L, jacobian=jac, use_flow_kernel=False)(t(x), flow, t(si))
    b = make_logp_fast(sp, cfg.L)(t(x), flow, t(si))
    assert calls == [tuple(x.shape)]
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-12)
    # on CPU tensors every plain version takes the size: the main route, as
    # an explicit request of both kernels gives
    e = make_logp_fast(sp, cfg.L, jacobian=jac, use_fused=True, use_flow_kernel=True)
    np.testing.assert_array_equal(e(t(x), flow, t(si)).numpy(), b.numpy())
    assert calls == [tuple(x.shape)]
    # the row-chunked depth-2 kernels (their plain version on CPU tensors)
    c = make_logp_fast(sp, cfg.L, use_large_flow=True)(t(x), flow, t(si))
    np.testing.assert_allclose(c.numpy(), b.numpy(), rtol=1e-10, atol=1e-10)
    with pytest.raises(ValueError):  # the depth-2 closure kernel feeds the fused tail only
        make_logp_fast(sp, cfg.L, use_d2_flow=True, use_fused=False, use_flow_kernel=False)
    with pytest.raises(ValueError):
        make_logp_fast(sp, cfg.L, use_fused=False, use_flow_kernel=True)
