"""The Metropolis logp's routes past the kernels' size limits.

``make_logp_fast`` left to choose (``use_fused`` and ``use_flow_kernel``
None) asks the kernels' ``*_fits`` functions, as the JAX package asks
``fused_fits`` and ``MAX_FLOW_N``.  Those ask the built library, so here they
are stubbed; the wrappers the closure calls are recorded, and every route is
held against the JAX ``make_logp_fast`` (``use_fused=False``, the analytic
Jacobian) on the same numpy inputs, f64, 1e-8 (through log-dets).  On CPU
tensors each wrapper takes its plain version, so a route's numbers do not
depend on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import coulombgas_tpu as cg
from coulombgas_tpu.ops.logdet import chol_logdet_ref as jax_chol_logdet_ref
from coulombgas_tpu.wavefunction.fast_logp import make_logp_fast as jax_make_logp_fast
from coulombgas_tpu_torch.ops import (
    cuda_flow_d2, cuda_flow_jac, cuda_flow_large, cuda_fused_logp, cuda_logdet,
)
from coulombgas_tpu_torch.ops import logdet
from coulombgas_tpu_torch.ops.logdet import chol_logdet, logdet_spd_single
from coulombgas_tpu_torch.wavefunction import fast_logp
from coulombgas_tpu_torch.wavefunction.fast_logp import make_logp_fast

from _torch_helpers import flow_pair, orbitals, t, walkers

# (flow kernel fits, fused tail fits, chol_logdet fits) -> the wrappers called
ROUTES = {
    "flow_kernel+fused": ((True, True, True), ["flow_u_jac_cuda", "fused_logp_cuda"]),
    "jacobian+fused": ((False, True, True), ["jacobian", "fused_logp_cuda"]),
    "jacobian+stacked_k3": ((False, False, True), ["jacobian", "chol_logdet_cuda"]),
    "jacobian+stacked_plain": ((False, False, False), ["jacobian", "chol_logdet_ref"]),
    # the flow kernel only ever feeds the fused tail
    "k1_fits_k2_not": ((True, False, True), ["jacobian", "chol_logdet_cuda"]),
}
SHAPES = {"n7_dim3": (7, 3, 3), "n13_dim2": (13, 2, 9)}


@functools.lru_cache(maxsize=None)
def _case(shape):
    n, dim, Emax = SHAPES[shape]
    sp = orbitals(dim, Emax)
    cfg, params, flow = flow_pair(2, 8, 8, n, dim, stddev=0.1)
    x, si = walkers(np.random.default_rng(n), 5, n, dim, sp.shape[0])
    jac = lambda p, q: cg.ferminet_apply_and_jac(p, cfg, q)  # noqa: E731
    ref = jax_make_logp_fast(lambda p, q: cg.ferminet_apply(p, cfg, q), sp, cfg.L,
                             use_pallas=False, use_fused=False, jacobian=jac)
    ref = np.asarray(jax.jit(ref)(jnp.asarray(x), params, jnp.asarray(si)))
    return sp, cfg, flow, x, si, ref


def _stub(monkeypatch, flow_fits, fused_fits, chol_fits, asked=None):
    for mod, name, ans in ((cuda_flow_jac, "flow_jac_fits", flow_fits),
                           (cuda_fused_logp, "fused_fits", fused_fits),
                           (cuda_logdet, "chol_logdet_fits", chol_fits)):
        def fits(*args, name=name, ans=ans, **kw):
            if asked is not None:
                asked.append(name)
            return ans
        monkeypatch.setattr(mod, name, fits)


def _record(monkeypatch, calls):
    """Record the wrappers the closure and ``chol_logdet`` call."""
    for mod, name in ((fast_logp, "flow_u_jac_cuda"), (fast_logp, "fused_logp_cuda"),
                      (cuda_logdet, "chol_logdet_cuda")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, real=real, name=name:
                            calls.append(name) or real(*a))
    real_ref = logdet.chol_logdet_ref
    monkeypatch.setattr(logdet, "chol_logdet_ref",
                        lambda A: calls.append("chol_logdet_ref") or real_ref(A))


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("route", list(ROUTES))
def test_closure_takes_the_reference_route_at_each_limit(monkeypatch, route, shape):
    sp, cfg, flow, x, si, ref = _case(shape)
    fits, expect = ROUTES[route]
    _stub(monkeypatch, *fits)
    calls = []
    _record(monkeypatch, calls)
    jac = fast_logp.ferminet_apply_and_jac

    def jacobian(flow_, x_):
        calls.append("jacobian")
        return jac(flow_, x_)

    logp = make_logp_fast(sp, cfg.L, jacobian=jacobian)
    got = logp(t(x), flow, t(si))
    n, dim = x.shape[1:]
    # dim 2 stacks both Grams into one chol_logdet call; dim 3 makes two
    stacked = 1 if dim == 2 else 2
    want = expect if expect[1] == "fused_logp_cuda" else expect[:1] + expect[1:] * stacked
    assert calls == want
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-8, atol=1e-8)
    name = logp.route(n, dim, cfg, "cpu")
    assert name.startswith("flow kernel" if expect[0] == "flow_u_jac_cuda"
                           else "analytic flow Jacobian")
    assert name.split(" (")[0].endswith(
        "+ fused_logp" if expect[1] == "fused_logp_cuda" else "+ stacked chol_logdet")


def test_the_choice_is_made_once_per_shape(monkeypatch):
    sp, cfg, flow, x, si, _ = _case("n13_dim2")
    asked = []
    _stub(monkeypatch, False, True, True, asked)
    logp = make_logp_fast(sp, cfg.L)
    a = logp(t(x), flow, t(si))
    b = logp(t(x), flow, t(si))
    assert asked == ["fused_fits", "flow_jac_fits"]
    assert torch.equal(a, b)
    logp(t(x)[:, :12], flow, t(si)[:, :12])  # another n: asked again
    assert asked == ["fused_fits", "flow_jac_fits"] * 2
    # an explicit choice asks only what it must
    asked.clear()
    make_logp_fast(sp, cfg.L, use_fused=False)(t(x), flow, t(si))
    assert "fused_fits" not in asked and "flow_jac_fits" not in asked


def test_without_stubs_the_cpu_takes_the_main_route():
    """On a CPU device every wrapper's plain version takes any size."""
    sp, cfg, flow, x, si, ref = _case("n7_dim3")
    assert cuda_flow_jac.flow_jac_fits(200, 3, cfg, "cpu")
    assert cuda_fused_logp.fused_fits(200, 3, torch.device("cpu"))
    assert cuda_logdet.chol_logdet_fits(1000, "cpu")
    assert cuda_flow_d2.flow_d2_fits(200, 3, cfg, device="cpu")
    assert cuda_flow_large.flow_large_fits(200, 3, 8, 8, "cpu")
    logp = make_logp_fast(sp, cfg.L)
    assert logp.route(7, 3, cfg, "cpu") == "flow kernel + fused_logp"
    np.testing.assert_allclose(logp(t(x), flow, t(si)).numpy(), ref, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("request_", ["use_flow_kernel", "use_fused", "use_d2_flow",
                                      "use_large_flow"])
def test_an_explicit_request_raises_where_its_kernel_does_not_fit(monkeypatch, request_):
    sp, cfg, flow, x, si, _ = _case("n13_dim2")
    _stub(monkeypatch, False, True, True)
    if request_ == "use_fused":
        _stub(monkeypatch, True, False, True)
    monkeypatch.setattr(cuda_flow_d2, "flow_d2_fits", lambda *a, **k: False)
    monkeypatch.setattr(cuda_flow_large, "flow_large_fits", lambda *a, **k: False)
    with pytest.raises(ValueError):
        make_logp_fast(sp, cfg.L, **{request_: True})(t(x), flow, t(si))
    # left to the closure, the same sizes take a route around the kernel
    make_logp_fast(sp, cfg.L)(t(x), flow, t(si))


def _spd(rng, B, m, deflate):
    a = rng.normal(size=(B, m, m))
    A = a @ a.transpose(0, 2, 1) + m * np.eye(m)
    if deflate:  # a zero row and column: pivot 3 deflates to log(PIVOT_FLOOR)
        A[:, 3, :] = 0
        A[:, :, 3] = 0
    return A


@pytest.mark.parametrize("deflate", [False, True], ids=["spd", "deflated"])
def test_chol_logdet_past_its_limit_is_the_plain_elimination(monkeypatch, deflate):
    A = _spd(np.random.default_rng(1), 4, 9, deflate)
    ref = np.asarray(jax.jit(jax_chol_logdet_ref)(jnp.asarray(A)))
    calls = []
    _record(monkeypatch, calls)
    for fits, expect in ((False, ["chol_logdet_ref"]), (True, ["chol_logdet_cuda"])):
        monkeypatch.setattr(cuda_logdet, "chol_logdet_fits", lambda m, device=None, f=fits: f)
        calls.clear()
        got = chol_logdet(t(A))
        assert calls == expect
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-8, atol=1e-8)
    if deflate:
        assert ref.max() < -40  # log(1e-30) = -69 from the deflated pivot
    # the accumulate's log det with its closed-form derivative goes the same way
    monkeypatch.setattr(cuda_logdet, "chol_logdet_fits", lambda m, device=None: False)
    calls.clear()
    got = logdet_spd_single(t(A))
    assert calls == ["chol_logdet_ref"]
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-8, atol=1e-8)
