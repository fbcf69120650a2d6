"""The port's VAN, autoregressive sampler and Metropolis sampler against the
JAX package.

The VAN's draws cannot be replayed (the two frameworks' generators differ),
so the sampler is tested through ``log_prob`` on fixed states, exact
normalisation over an enumerated state space, and the ordering of its
samples.  The Metropolis sampler can be replayed: the test reproduces the
reference's key splits and feeds the same normal and uniform draws.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import coulombgas_tpu as cg
from coulombgas_tpu_torch.models.transformer import (
    TransformerConfig, init_kv_cache, init_transformer_params, transformer_apply,
    transformer_decode_step,
)
from coulombgas_tpu_torch.sampling.autoregressive import make_autoregressive_sampler
from coulombgas_tpu_torch.sampling.mcmc import mcmc

from _torch_helpers import orbitals, t, van_pair, walkers


def _van_case(n=4, nlayers=2, seed=0):
    sp = orbitals(2, 4)  # 13 states
    M = sp.shape[0]
    cfg_j, params_j, van = van_pair(M, nlayers, 8, 2, 12, 2, seed)
    return sp, M, cfg_j, params_j, van


def test_transformer_apply_matches_jax():
    sp, M, cfg_j, params_j, van = _van_case()
    _, si = walkers(np.random.default_rng(0), 5, 4, 2, M)
    tokens = sp[si]
    ref = jax.vmap(lambda q: cg.transformer_apply(params_j, cfg_j, q))(jnp.asarray(tokens))
    with torch.no_grad():
        got = transformer_apply(van, t(tokens))
    assert got.shape == (5, 4, M)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-10)


def test_transformer_is_autoregressive():
    """Row i of the logits depends on tokens < i only."""
    sp, M, _, _, van = _van_case()
    tokens = t(sp[[1, 4, 7, 9]])[None].requires_grad_(True)
    logits = transformer_apply(van, tokens)
    for i in range(4):
        (g,) = torch.autograd.grad(logits[0, i].sum(), tokens, retain_graph=True)
        assert torch.all(g[0, i:] == 0)
        if i > 0:
            assert torch.any(g[0, :i] != 0)


def test_decode_step_equals_full_forward():
    sp, M, _, _, van = _van_case()
    _, si = walkers(np.random.default_rng(1), 3, 4, 2, M)
    tokens = t(sp[si])
    with torch.no_grad():
        full = transformer_apply(van, tokens)
        kc, vc = init_kv_cache(van.cfg, 3, 4, torch.float64, "cpu")
        assert kc.shape == (3, 2, 4, 2, 4)
        for pos in range(3):
            logits, kc, vc = transformer_decode_step(van, tokens[:, pos], pos, kc, vc)
            np.testing.assert_allclose(logits.numpy(), full[:, pos + 1].numpy(),
                                       rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("nlayers", [1, 2])
def test_log_prob_matches_jax_on_fixed_states(nlayers):
    sp, M, cfg_j, params_j, van = _van_case(nlayers=nlayers, seed=nlayers)
    n = 4
    _, si = walkers(np.random.default_rng(2), 6, n, 2, M)
    _, log_prob_j = cg.make_autoregressive_sampler(cfg_j, sp, n, M)
    ref = jax.vmap(log_prob_j, (None, 0))(params_j, jnp.asarray(si))
    _, log_prob = make_autoregressive_sampler(sp, n, M)
    with torch.no_grad():
        got = log_prob(van, t(si))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-10)


def test_mask_matches_jax():
    sp, M, cfg_j, _, _ = _van_case()
    n = 4
    mask_j, _, _ = cg.make_autoregressive_sampler(cfg_j, sp, n, M, mask_fn=True)
    mask_t, _, _ = make_autoregressive_sampler(sp, n, M, mask_fn=True)
    _, si = walkers(np.random.default_rng(3), 4, n, 2, M)
    for s in si:
        np.testing.assert_array_equal(mask_t(t(s)[None])[0].numpy(),
                                      np.asarray(mask_j(jnp.asarray(s))) > 0)


def test_log_prob_is_normalised_over_all_ordered_states():
    sp = orbitals(2, 2)  # 9 states
    M, n = sp.shape[0], 3
    _, _, van = van_pair(M, 2, 8, 2, 12, 2, seed=5)
    _, log_prob = make_autoregressive_sampler(sp, n, M)
    states = torch.tensor(list(itertools.combinations(range(M), n)))
    with torch.no_grad():
        total = torch.exp(log_prob(van, states)).sum()
    np.testing.assert_allclose(float(total), 1.0, rtol=1e-10)


def test_sampler_draws_ordered_states_with_the_exact_frequencies():
    sp = orbitals(2, 1)  # 5 states
    M, n = sp.shape[0], 2
    _, _, van = van_pair(M, 1, 8, 2, 12, 2, seed=6)
    sampler, log_prob = make_autoregressive_sampler(sp, n, M)
    batch = 20000
    s = sampler(van, torch.Generator().manual_seed(0), batch)
    assert s.shape == (batch, n) and s.dtype == torch.long
    assert torch.all(s[:, 1:] > s[:, :-1]) and s.min() >= 0 and s.max() < M
    states = list(itertools.combinations(range(M), n))
    with torch.no_grad():
        p = torch.exp(log_prob(van, torch.tensor(states))).numpy()
    counts = np.array([int(((s[:, 0] == a) & (s[:, 1] == b)).sum()) for a, b in states])
    sigma = np.sqrt(batch * p * (1 - p))
    assert np.all(np.abs(counts - batch * p) < 5 * sigma + 1), (counts, batch * p)


def test_init_transformer_params_shapes_and_scale():
    cfg = TransformerConfig(81, 2, 16, 4, 32)
    van = init_transformer_params(cfg, 2, torch.Generator().manual_seed(0), torch.float64, "cpu")
    assert sum(p.numel() for p in van.parameters()) == 5826
    assert float(van.embed.b.detach().abs().max()) == 0.0
    assert 0 < float(van.layers[0].attn.q.w.detach().std()) < 0.1
    with pytest.raises(ValueError):
        TransformerConfig(81, 2, 16, 3, 32)


def _replayed_draws(key, steps, shape):
    """The normal and uniform draws of the reference's ``mcmc`` for ``key``."""
    props, unifs = [], []
    for _ in range(steps):
        key, key_prop, key_acc = jax.random.split(key, 3)
        props.append(np.asarray(jax.random.normal(key_prop, shape, jnp.float64)))
        unifs.append(np.asarray(jax.random.uniform(key_acc, shape[:1], jnp.float64)))
    return np.stack(props), np.stack(unifs)


def test_mcmc_replay_gives_identical_walkers_and_accepts():
    rng = np.random.default_rng(0)
    centre = rng.normal(size=(3, 2))
    logp_j = lambda x: -0.5 * ((x - centre) ** 2 / 0.3).sum(axis=(-2, -1))
    logp_t = lambda x: -0.5 * ((x - t(centre)) ** 2 / 0.3).sum(dim=(-2, -1))
    x0 = rng.normal(size=(16, 3, 2))
    key = jax.random.PRNGKey(7)
    steps, stddev = 5, 0.4
    x_ref, acc_ref = cg.mcmc(logp_j, jnp.asarray(x0), key, steps, stddev)
    props, unifs = _replayed_draws(key, steps, x0.shape)
    x_got, acc_got = mcmc(logp_t, t(x0), None, steps, stddev,
                          proposals=t(props), uniforms=t(unifs))
    # the same walkers moved at every sweep: the accept counts are equal, and
    # the coordinates agree to the last bit or two (XLA contracts
    # x + stddev * noise into one fused multiply-add, torch rounds twice)
    assert round(float(acc_got) * steps * 16) == round(float(acc_ref) * steps * 16)
    np.testing.assert_allclose(x_got.numpy(), np.asarray(x_ref), rtol=0, atol=1e-14)
    assert 0.05 < float(acc_got) < 0.95


def test_mcmc_rescues_stuck_walkers_and_rejects_nan_proposals():
    calls = {"n": 0}

    def logp(x):
        calls["n"] += 1
        out = -x.pow(2).sum(dim=(-2, -1))
        if calls["n"] == 1:          # initial logp: walker 0 is stuck at -inf
            out[0] = -float("inf")
        else:                        # every proposal of walker 1 is NaN
            out[1] = float("nan")
        return out

    x0 = torch.ones(3, 2, 2, dtype=torch.float64)
    x, acc = mcmc(logp, x0, torch.Generator().manual_seed(0), 3, 0.1)
    assert calls["n"] == 4
    assert not torch.equal(x[0], x0[0])   # rescued
    assert torch.equal(x[1], x0[1])       # never moved
    assert torch.isfinite(x).all() and 0 < float(acc) <= 1


def test_mcmc_with_a_generator_samples_the_target():
    g = torch.Generator().manual_seed(1)
    logp = lambda x: -0.5 * (x**2).sum(dim=(-2, -1))
    x = torch.zeros(4000, 1, 1, dtype=torch.float64)
    x, acc = mcmc(logp, x, g, 60, 1.0)
    assert abs(float(x.mean())) < 0.08 and abs(float(x.var()) - 1.0) < 0.1
    assert 0.5 < float(acc) < 0.9
