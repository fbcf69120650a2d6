"""Stochastic reconfiguration in the port against the JAX package (f64).

  * the per-sample score matrices, column by column, against
    ``_ravel_batch`` of the JAX scores with the parameters carried over by
    ``io/convert.py`` (1e-8): a permuted Fisher is invisible to every scalar
    observable;
  * ``fishers_from_scores`` and every variant of ``_solve_scaled`` on a
    well-conditioned, an ill-conditioned, an indefinite and a NaN Fisher
    (1e-10 in f64), and the guards in f32 (zero step, never NaN);
  * the float64 apply (``host64``) and its Fisher cache;
  * the score-based gradients against autograd of the loss closures;
  * one whole SR accumulate + apply against the JAX
    ``make_accumulate_and_apply`` with the same Hutchinson probe (updates
    1e-8), with and without ``--microbatch``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coulombgas_tpu.optim import host_sr as jax_host_sr
from coulombgas_tpu.optim import sr as jax_sr
from coulombgas_tpu.train.train import (
    init_accumulators as jax_init_accumulators,
    make_accumulate_and_apply as jax_make_accumulate_and_apply,
)
from coulombgas_tpu_torch.io.convert import (
    flatten_tree, ravel_order, ravel_params, unravel_like,
)
from coulombgas_tpu_torch.optim import host_sr, sr
from coulombgas_tpu_torch.parallel import mesh
from coulombgas_tpu_torch.train.train import (
    chunk_layout, init_accumulators, make_accumulate_and_apply,
)

from _torch_helpers import hutchinson_probe, t, training_stacks

DAMPING, MAX_NORM = 1e-3, 1e-3


@pytest.fixture(scope="module")
def stacks():
    return training_stacks()


# ---- scores ----------------------------------------------------------------------


def test_ravel_order_is_ravel_pytree_order(stacks):
    """Names in the order ``ravel_pytree`` flattens the carried-over pytree,
    which is not the order of ``module.parameters()``."""
    from jax.flatten_util import ravel_pytree

    for module, tree in ((stacks["flow"], stacks["params_flow"]),
                         (stacks["van"], stacks["params_van"])):
        order = ravel_order(module)
        flat = flatten_tree(jax.tree.map(np.asarray, tree))
        assert sorted(order) == sorted(flat)
        want = np.asarray(ravel_pytree(tree)[0])
        got = np.concatenate([flat[k].ravel() for k in order])
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(ravel_params(module).numpy(), want)
        back = unravel_like(ravel_params(module), module)
        assert all(torch.equal(a, b) for a, b in zip(back, module.parameters()))
    assert ravel_order(stacks["flow"])[:2] == ["final.b", "final.w"]
    assert [k for k, _ in stacks["flow"].named_parameters()][0] == "sp.0.w"


def test_classical_score_columns_match_jax(stacks):
    ref = jax_sr._ravel_batch(jax.jit(stacks["classical_score_j"])(
        stacks["params_van"], jnp.asarray(stacks["si"])))
    got = stacks["classical_score"](stacks["van"], t(stacks["si"]))
    assert got.shape == ref.shape and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-8, atol=1e-8)
    # the columns are distinguishable: a permutation would show
    assert np.unique(np.round(np.abs(np.asarray(ref)).sum(0), 9)).size > ref.shape[1] // 2


def test_quantum_score_columns_match_jax(stacks):
    ref = jax_sr._ravel_batch(jax.jit(stacks["quantum_score_j"])(
        jnp.asarray(stacks["x"]), stacks["params_flow"], jnp.asarray(stacks["si"])))
    got = stacks["quantum_score"](t(stacks["x"]), stacks["flow"], t(stacks["si"]))
    assert got.shape == ref.shape and got.dtype == torch.complex128
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-8, atol=1e-8)
    assert np.abs(np.asarray(ref).imag).max() > 1e-3  # the imaginary part is exercised
    # the caller's grad mode must not matter (under an outer no_grad PyTorch's
    # backward of a complex slogdet goes wrong under vmap; the port guards it)
    with torch.no_grad():
        again = stacks["quantum_score"](t(stacks["x"]), stacks["flow"], t(stacks["si"]))
    assert torch.equal(again, got)


def test_fishers_from_scores_match_jax():
    rng = np.random.default_rng(0)
    s_c = rng.normal(size=(16, 7))
    s_q = rng.normal(size=(16, 5)) + 1j * rng.normal(size=(16, 5))
    ref = jax_sr.fishers_from_scores(jnp.asarray(s_c), jnp.asarray(s_q))
    got = sr.fishers_from_scores(t(s_c), torch.from_numpy(s_q))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-10, atol=1e-10)


# ---- _solve_scaled ------------------------------------------------------------------

VARIANTS = {
    "plain": {}, "jacobi": dict(jacobi=True), "refine": dict(refine=2),
    "refined": dict(jacobi=True, refine=2), "chol": dict(jacobi=True, refine=2, chol=True),
}


def _fisher(kind, P=12, seed=0):
    rng = np.random.default_rng(seed)
    S = rng.normal(size=(4 * P, P))
    if kind == "ill":  # diagonal spread of 1e8, lambda_max / damping ~ 1e9
        S = S * np.logspace(-4, 4, P)
    F = S.T @ S / S.shape[0]
    if kind == "indefinite":
        F = -F
    if kind == "nan":
        F[3, 5] = F[5, 3] = np.nan
    return F, rng.normal(size=P)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("kind", ["well", "ill", "indefinite", "nan"])
def test_solve_scaled_matches_jax_f64(kind, variant):
    F, g = _fisher(kind)
    ref, ref_diag = jax_sr._solve_scaled(jnp.asarray(F), jnp.asarray(g), DAMPING, MAX_NORM,
                                         with_diag=True, **VARIANTS[variant])
    got, diag = sr._solve_scaled(t(F), t(g), DAMPING, MAX_NORM, with_diag=True,
                                 **VARIANTS[variant])
    assert torch.isfinite(got).all()  # never NaN: a zero step instead
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(float(diag["scale"]), float(ref_diag["scale"]), rtol=1e-10)
    if kind in ("indefinite", "nan"):
        assert float(diag["scale"]) == 0 and not got.any()
    else:
        assert 0 < float(diag["scale"]) <= 1 and float(diag["gnorm"]) > 0


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_solve_scaled_f64_takes_the_plain_solve_whatever_the_flags(variant):
    """The reference's f64 short-cut: ``jacobi`` / ``refine`` / ``chol`` are
    f32 accuracy measures and are not honoured in f64."""
    F, g = _fisher("ill", seed=3)
    plain = sr._solve_scaled(t(F), t(g), DAMPING, MAX_NORM)
    assert torch.equal(sr._solve_scaled(t(F), t(g), DAMPING, MAX_NORM, **VARIANTS[variant]),
                       plain)
    f32 = sr._solve_scaled(t(F, torch.float32), t(g, torch.float32), DAMPING, MAX_NORM,
                           **VARIANTS[variant])
    assert f32.dtype == torch.float32
    if variant != "plain":  # in f32 the flags do change the arithmetic
        assert not torch.equal(f32, sr._solve_scaled(t(F, torch.float32), t(g, torch.float32),
                                                     DAMPING, MAX_NORM))


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("kind", ["well", "ill", "indefinite", "nan"])
def test_solve_scaled_f32_guards(kind, variant):
    """f32: a well-conditioned solve agrees with f64; whatever the matrix the
    step is finite, and a non-positive or non-finite curvature zeroes it."""
    F, g = _fisher(kind, seed=1)
    got, diag = sr._solve_scaled(t(F, torch.float32), t(g, torch.float32), DAMPING, MAX_NORM,
                                 with_diag=True, **VARIANTS[variant])
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    gnorm, scale = float(diag["gnorm"]), float(diag["scale"])
    if not np.isfinite(gnorm) or gnorm <= 0:
        assert scale == 0 and not got.any()
    else:
        assert 0 < scale <= 1
    if kind == "well":
        ref = sr._solve_scaled(t(F), t(g), DAMPING, MAX_NORM)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-3, atol=1e-7)
    if kind == "nan":
        assert scale == 0
    if kind == "indefinite" and variant != "chol":
        assert scale == 0  # (chol refactors once with 32x damping, then the same guard)


@pytest.mark.parametrize("scale", [1.0, 0.25])
@pytest.mark.parametrize("variant", ["plain", "chol"])
def test_hybrid_update_matches_jax(variant, scale):
    rng = np.random.default_rng(5)
    s_c = rng.normal(size=(32, 9))
    s_q = rng.normal(size=(32, 6)) + 1j * rng.normal(size=(32, 6))
    gv, gf = rng.normal(size=9), rng.normal(size=6)
    kw = VARIANTS[variant]
    opt_j = jax_sr.hybrid_fisher_sr(None, None, DAMPING, MAX_NORM, **kw)
    fish_j = jax_sr.fishers_from_scores(jnp.asarray(s_c), jnp.asarray(s_q))
    (uv_j, uf_j), diag_j = opt_j.update(({"a": jnp.asarray(gv)}, {"b": jnp.asarray(gf)}),
                                        opt_j.init(None), fish_j, max_norm_scale=scale)
    opt = sr.hybrid_fisher_sr(None, None, DAMPING, MAX_NORM, **kw)
    assert set(opt.init()) == set(diag_j)
    fish = sr.fishers_from_scores(t(s_c), torch.from_numpy(s_q))
    (uv, uf), diag = opt.update((t(gv), t(gf)), opt.init(), fish, max_norm_scale=scale)
    np.testing.assert_allclose(uv.numpy(), np.asarray(uv_j["a"]), rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(uf.numpy(), np.asarray(uf_j["b"]), rtol=1e-10, atol=1e-14)
    for k in diag_j:
        np.testing.assert_allclose(float(diag[k]), float(diag_j[k]), rtol=1e-10)
    # the update of the classical block alone, through fisher_sr
    upd, d1 = sr.fisher_sr(lambda van, si: t(s_c), DAMPING, MAX_NORM, **kw).update(
        t(gv), None, None, None, max_norm_scale=scale)
    np.testing.assert_allclose(upd.numpy(), uv.numpy(), rtol=1e-12, atol=1e-16)


# ---- the float64 apply and its cache ----------------------------------------------------

P_VAN, P_FLOW, BATCH, K = 17, 11, 64, 3


def _acc(seed, with_fishers=True):
    """Synthetic accumulators in the layout of the apply step (sums over K
    accumulation steps), gradients and scores as raveled vectors."""
    rng = np.random.RandomState(seed)
    s_c = rng.randn(BATCH, P_VAN)
    s_q = rng.randn(BATCH, P_FLOW) + 1j * rng.randn(BATCH, P_FLOW)
    data = {k: np.float32(v) for k, v in [
        ("F_mean", K * rng.randn()), ("F2_mean", K * abs(rng.randn())),
        ("E_mean", K * rng.randn()), ("E2_mean", K * abs(rng.randn())),
        ("K_mean", K), ("K2_mean", K), ("V_mean", K), ("V2_mean", K),
        ("S_mean", K), ("S2_mean", K)]}
    acc = {
        "data": data,
        "grads": (np.float32(K * rng.randn(P_VAN)), np.float32(K * rng.randn(P_FLOW))),
        "classical_score": np.float32(K * s_c.mean(0)),
        "quantum_score": np.float32(K * 2.0 * s_q.real.mean(0)),
        "quantum_score_mean": np.float32(K * np.stack([s_q.mean(0).real, s_q.mean(0).imag])),
    }
    if with_fishers:
        acc["classical_fisher"] = np.float32(K * s_c.T @ s_c / BATCH)
        acc["quantum_fisher"] = np.float32(K * (s_q.conj().T @ s_q).real / BATCH)
    return acc


def _jax_layout(acc):
    """The same accumulators as the JAX package's apply expects them."""
    return dict(acc, grads=({"w": acc["grads"][0]}, {"a": acc["grads"][1]}),
                classical_score={"w": acc["classical_score"]},
                quantum_score={"a": acc["quantum_score"]})


def test_packed_triangle_helpers_are_bitwise_the_jax_packages():
    rng = np.random.default_rng(0)
    M = rng.normal(size=(9, 9)).astype(np.float32)
    M = M + M.T
    packed = host_sr.sym_pack(M)
    np.testing.assert_array_equal(packed, np.asarray(jax_host_sr.sym_pack(jnp.asarray(M))))
    np.testing.assert_array_equal(host_sr.sym_unpack(packed), jax_host_sr.sym_unpack(packed))
    np.testing.assert_array_equal(host_sr.sym_unpack(packed), M.astype(np.float64))
    iu = np.triu_indices(9)
    np.testing.assert_array_equal(host_sr.damped_upper(packed, 3, 1e-3)[iu],
                                  jax_host_sr.damped_upper(packed, 3, 1e-3)[iu])
    with pytest.raises(ValueError):
        host_sr.sym_unpack(np.zeros(7))


@pytest.mark.parametrize("packed", [False, True], ids=["full", "sym_packed"])
def test_host_apply_matches_jax_and_its_cache_on_a_refresh_epoch(packed):
    acc = _acc(0)
    ref = jax_host_sr.host_hybrid_apply(_jax_layout(acc), K, DAMPING, MAX_NORM)
    if packed:
        acc = dict(acc, classical_fisher=host_sr.sym_pack(acc["classical_fisher"]),
                   quantum_fisher=host_sr.sym_pack(acc["quantum_fisher"]))
    uv0, uf0, d0, diag0 = host_sr.host_hybrid_apply(acc, K, DAMPING, MAX_NORM)
    assert uv0.dtype == torch.float64
    np.testing.assert_allclose(uv0.numpy(), ref[0], rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(uf0.numpy(), ref[1], rtol=1e-10, atol=1e-14)
    assert d0 == ref[2]
    for k in diag0:
        assert np.isclose(diag0[k], ref[3][k], rtol=1e-10), k
    cache = host_sr.HostFisherCache(DAMPING)
    uv1, uf1, d1, diag1 = host_sr.host_hybrid_apply(acc, K, DAMPING, MAX_NORM, cache=cache)
    np.testing.assert_allclose(uv1.numpy(), uv0.numpy(), rtol=0, atol=1e-13)
    np.testing.assert_allclose(uf1.numpy(), uf0.numpy(), rtol=0, atol=1e-13)
    assert d1 == d0 and cache.ready and cache.age == 0


@pytest.mark.parametrize("fresh_quantum", [False, True], ids=["frozen_qf", "fresh_qf"])
def test_host_cache_stale_epoch(fresh_quantum):
    """A stale epoch solves the classical block with the cached factor and
    everything else with the current accumulators; the quantum block is the
    fresh one whenever the accumulators carry it."""
    acc_a, acc_b = _acc(1), _acc(2, with_fishers=False)
    if fresh_quantum:
        acc_b["quantum_fisher"] = _acc(2)["quantum_fisher"]
    cache = host_sr.HostFisherCache(DAMPING)
    host_sr.host_hybrid_apply(acc_a, K, DAMPING, MAX_NORM, cache=cache)
    uv, uf, d, _ = host_sr.host_hybrid_apply(acc_b, K, DAMPING, MAX_NORM, cache=cache)
    assert cache.age == 1
    mixed = dict(acc_b, classical_fisher=acc_a["classical_fisher"],
                 quantum_fisher=acc_b.get("quantum_fisher", acc_a["quantum_fisher"]))
    uv0, uf0, d0, _ = host_sr.host_hybrid_apply(mixed, K, DAMPING, MAX_NORM)
    np.testing.assert_allclose(uv.numpy(), uv0.numpy(), rtol=0, atol=1e-13)
    np.testing.assert_allclose(uf.numpy(), uf0.numpy(), rtol=0, atol=1e-13)
    assert d == d0


def test_host_solve_scaled_guards_and_matches_the_device_solve():
    F, g = _fisher("well", seed=2)
    upd, diag = host_sr.host_solve_scaled(F, g, DAMPING, MAX_NORM)
    np.testing.assert_allclose(upd.numpy(), sr._solve_scaled(t(F), t(g), DAMPING, MAX_NORM).numpy(),
                               rtol=1e-9)
    assert diag["gnorm"] > 0 and 0 < diag["scale"] <= 1
    # an f32 Fisher is solved in f64 all the same
    upd32, _ = host_sr.host_solve_scaled(t(F, torch.float32), t(g, torch.float32), DAMPING, MAX_NORM)
    assert upd32.dtype == torch.float64
    for bad in (-np.eye(6), np.full((6, 6), np.nan)):
        upd, diag = host_sr.host_solve_scaled(bad, np.ones(6), DAMPING, MAX_NORM)
        assert not upd.any() and diag["scale"] == 0.0


# ---- the training step ---------------------------------------------------------------------


def _named(module, tensors):
    return list(zip([k for k, _ in module.named_parameters()], tensors))


def _assert_tree(named_tensors, tree, rtol=1e-8, atol=1e-10):
    flat = flatten_tree(jax.tree.map(np.asarray, tree))
    assert sorted(k for k, _ in named_tensors) == sorted(flat)
    for k, val in named_tensors:
        np.testing.assert_allclose(val.detach().numpy(), flat[k], rtol=rtol, atol=atol, err_msg=k)


def _sr_opt(stacks, **kw):
    return sr.hybrid_fisher_sr(stacks["classical_score"], stacks["quantum_score"],
                               DAMPING, MAX_NORM, **kw)


def test_score_based_gradients_match_autograd_of_the_losses(stacks):
    """grad_van = S_c^T Floc / B and grad_flow = 2 Re mean(S_q conj(Eloc)) are
    the gradients of the loss closures (a wrong ``conj`` leaves the Fisher
    unchanged and flips the imaginary part's contribution here)."""
    van, flow = stacks["van"], stacks["flow"]
    x, si = t(stacks["x"]), t(stacks["si"])
    v = t(hutchinson_probe(jax.random.PRNGKey(3), x.shape))
    fast, _ = make_accumulate_and_apply(stacks["loss"], 1, sr_opt=_sr_opt(stacks))
    slow, _ = make_accumulate_and_apply(stacks["loss"], 1)
    a = fast(van, flow, si, x, None, init_accumulators(van, flow, sr=True), v=v)
    b = slow(van, flow, si, x, None, init_accumulators(van, flow), v=v)
    for key in ("classical_score", "quantum_score"):
        for p, q in zip(a[key], b[key]):
            np.testing.assert_allclose(p.numpy(), q.numpy(), rtol=1e-9, atol=1e-12)
    for i in (0, 1):
        for p, q in zip(a["grads"][i], b["grads"][i]):
            np.testing.assert_allclose(p.numpy(), q.numpy(), rtol=1e-9, atol=1e-12)
    assert max(float(g.abs().max()) for g in a["grads"][1]) > 1e-6


@pytest.fixture(scope="module", params=[None, 4], ids=["whole_batch", "microbatch_4"])
def sr_step(request, stacks):
    """One SR accumulate + apply in each package on the same inputs."""
    micro = request.param
    pv, pf = stacks["params_van"], stacks["params_flow"]
    x, si = stacks["x"], stacks["si"]
    key = jax.random.PRNGKey(11)
    v = hutchinson_probe(key, x.shape, 1 if micro is None else x.shape[0] // micro)

    opt_j = jax_sr.hybrid_fisher_sr(stacks["classical_score_j"], stacks["quantum_score_j"],
                                    DAMPING, MAX_NORM)
    acc_fn, apply_fn = jax_make_accumulate_and_apply(stacks["loss_j"], None, 1, opt_j,
                                                     microbatch=micro)
    acc_j = jax.jit(acc_fn)(pv, pf, jnp.asarray(si), jnp.asarray(x), key,
                            jax_init_accumulators(pv, pf, True, jnp.float64))
    new_van, new_flow, diag_j, data_j = jax.jit(apply_fn)(pv, pf, opt_j.init(None), acc_j)

    # copies of the modules: apply_update moves the parameters in place
    van, flow = copy.deepcopy(stacks["van"]), copy.deepcopy(stacks["flow"])
    pieces = None if micro is None else mesh.window_groups(chunk_layout(x.shape[0], micro, 1))
    accumulate, apply_update = make_accumulate_and_apply(
        stacks["loss"], 1, pieces=pieces, sr_opt=_sr_opt(stacks))
    acc = accumulate(van, flow, t(si), t(x), None, init_accumulators(van, flow, sr=True), v=t(v))
    acc_copy = {k: (val.clone() if torch.is_tensor(val) else val) for k, val in acc.items()}
    before = (ravel_params(van).clone(), ravel_params(flow).clone())
    data = apply_update(van, flow, None, acc)
    return dict(acc_j=acc_j, new_van=new_van, new_flow=new_flow, data_j=data_j, pv=pv, pf=pf,
                van=van, flow=flow, acc=acc_copy, data=data, before=before, x=x, si=si, v=v)


def test_sr_accumulators_match_jax(sr_step):
    a, j = sr_step["acc"], sr_step["acc_j"]
    for k in ("classical_fisher", "quantum_fisher", "quantum_score_mean"):
        assert a[k].shape == j[k].shape
        np.testing.assert_allclose(a[k].numpy(), np.asarray(j[k]), rtol=1e-8, atol=1e-9, err_msg=k)
    _assert_tree(_named(sr_step["van"], a["grads"][0]), j["grads"][0])
    _assert_tree(_named(sr_step["flow"], a["grads"][1]), j["grads"][1])
    _assert_tree(_named(sr_step["van"], a["classical_score"]), j["classical_score"])
    _assert_tree(_named(sr_step["flow"], a["quantum_score"]), j["quantum_score"])
    for k, val in a["data"].items():
        np.testing.assert_allclose(float(val), float(j["data"][k]), rtol=1e-8, atol=1e-8)


def test_sr_update_matches_jax(sr_step):
    """``p += update`` as ``optax.apply_updates``: the steps agree to 1e-8
    (absolute; a step is of order sqrt(max_norm) = 3e-2 in the Fisher norm)."""
    from jax.flatten_util import ravel_pytree

    for module, before, new, old in (
        (sr_step["van"], sr_step["before"][0], sr_step["new_van"], sr_step["pv"]),
        (sr_step["flow"], sr_step["before"][1], sr_step["new_flow"], sr_step["pf"]),
    ):
        step_j = np.asarray(ravel_pytree(new)[0] - ravel_pytree(old)[0])
        step = (ravel_params(module) - before).numpy()
        assert np.abs(step_j).max() > 1e-5
        np.testing.assert_allclose(step, step_j, rtol=0, atol=1e-8)
        _assert_tree(list(module.named_parameters()), new, rtol=0, atol=1e-8)
    for k in ("gnorm_van", "scale_van", "gnorm_flow", "scale_flow"):
        np.testing.assert_allclose(float(sr_step["data"]["diag_" + k]),
                                   float(sr_step["data_j"]["diag_" + k]), rtol=1e-7)


def test_sr_trust_scale_and_host64_apply(sr_step, stacks):
    """``trust_scale`` shrinks the trust radius (a scaled step is shorter by
    sqrt(trust_scale)); the float64 apply gives the device solve's step."""
    van, flow = copy.deepcopy(stacks["van"]), copy.deepcopy(stacks["flow"])
    _, apply_update = make_accumulate_and_apply(stacks["loss"], 1, sr_opt=_sr_opt(stacks))
    before = (ravel_params(van).clone(), ravel_params(flow).clone())
    acc = sr_step["acc"]
    data = apply_update(van, flow, None, acc, trust_scale=0.25)
    full = ((ravel_params(sr_step["van"]) - sr_step["before"][0]),
            (ravel_params(sr_step["flow"]) - sr_step["before"][1]))
    for module, b, f, name in ((van, before[0], full[0], "van"), (flow, before[1], full[1], "flow")):
        np.testing.assert_allclose((ravel_params(module) - b).numpy(), 0.5 * f.numpy(),
                                   rtol=1e-9, atol=1e-14)
        np.testing.assert_allclose(float(data["diag_scale_" + name]),
                                   0.5 * float(sr_step["data"]["diag_scale_" + name]), rtol=1e-10)
    uv, uf, d, diag = host_sr.host_hybrid_apply(acc, 1, DAMPING, MAX_NORM,
                                                van=sr_step["van"], flow=sr_step["flow"])
    np.testing.assert_allclose(uv.numpy(), full[0].numpy(), rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(uf.numpy(), full[1].numpy(), rtol=1e-7, atol=1e-12)
    assert d["F_mean"] == pytest.approx(float(sr_step["data"]["F_mean"]), rel=1e-12)
    assert 0 < diag["scale_van"] <= 1 and 0 < diag["scale_flow"] <= 1
