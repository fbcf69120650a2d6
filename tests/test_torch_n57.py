"""The checked-in n = 57 production checkpoint (epoch 100 of the rs = 1.0 run,
Emax 49, batch 512) loaded into both packages, in f64: for 4 of its
walkers the Metropolis logp (the JAX package's analytic-Jacobian route
against the port's row-chunked large-flow route), the VAN's log-probability
of 4 occupation states and the Ewald potential energy agree to 1e-8
relative — the full production widths, the trained weights.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import coulombgas_tpu as cg
from coulombgas_tpu.wavefunction.fast_logp import make_logp_fast as jax_make_logp_fast
from coulombgas_tpu_torch.io.checkpoint import load_data
from coulombgas_tpu_torch.io.convert import flow_from_numpy, van_from_numpy
from coulombgas_tpu_torch.models.ferminet import FermiNet, FermiNetConfig
from coulombgas_tpu_torch.models.transformer import Transformer, TransformerConfig
from coulombgas_tpu_torch.physics.ewald import kpoints, potential_energy
from coulombgas_tpu_torch.sampling.autoregressive import make_autoregressive_sampler
from coulombgas_tpu_torch.wavefunction.fast_logp import make_logp_fast

from _torch_helpers import orbitals, t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = os.path.join(
    ROOT, "data", "interacting_n57_goodseed",
    "n_57_dim_2_rs_1.0_Theta_0.15_Emax_49_twist_0.250_0.250_nlayers_2_modelsize_16_nheads_4_"
    "nhidden_32_depth_2_spsize_16_tpsize_16_Gmax_15_kappa_10_mctherm_10_mcsteps_50_"
    "mcstddev_0.10_hutchinson_damping_0.00100_maxnorm_0.00100_batch_512_ndevices_1_accsteps_16")
N, DIM, EMAX, RS, KAPPA, GMAX = 57, 2, 49, 1.0, 10, 15
WALKERS = [0, 101, 257, 511]


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


@pytest.fixture(scope="module")
def n57():
    ckpt = load_data(os.path.join(RUN, "epoch_000100.pkl"))
    assert ckpt["x"].shape == (512, N, DIM)
    L = float(np.sqrt(np.pi * N))
    sp = orbitals(DIM, EMAX)
    M = sp.shape[0]
    flow = FermiNet(FermiNetConfig(2, 16, 16, L), DIM, torch.float64, "cpu")
    flow_from_numpy(_f64(ckpt["params_flow"]), flow)
    van = Transformer(TransformerConfig(M, 2, 16, 4, 32), DIM, torch.float64, "cpu")
    van_from_numpy(_f64(ckpt["params_van"]), van)
    x = np.asarray(ckpt["x"], np.float64)[WALKERS]
    rng = np.random.default_rng(57)
    si = np.stack([np.sort(rng.choice(M, N, replace=False)) for _ in WALKERS]).astype(np.int32)
    si[0] = np.arange(M - N, M)  # the lowest-energy states (highest indices) for one walker
    return dict(ckpt=ckpt, L=L, sp=sp, M=M, flow=flow, van=van, x=x, si=si)


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b)) / np.maximum(np.abs(b), 1e-300)))


def test_logp_large_flow_route_matches_jax(n57):
    d = n57
    cfg = cg.FermiNetConfig(2, 16, 16, d["L"])
    params = jax.tree.map(jnp.asarray, _f64(d["ckpt"]["params_flow"]))
    jac = lambda p, q: cg.ferminet_apply_and_jac(p, cfg, q)  # noqa: E731
    jax_fn = jax_make_logp_fast(lambda p, q: cg.ferminet_apply(p, cfg, q), d["sp"], d["L"],
                                use_pallas=False, use_fused=False, jacobian=jac)
    ref = np.asarray(jax.jit(jax_fn)(jnp.asarray(d["x"]), params, jnp.asarray(d["si"])))
    got = make_logp_fast(d["sp"], d["L"], use_large_flow=True)(t(d["x"]), d["flow"], t(d["si"]))
    assert np.isfinite(ref).all() and _rel(got.numpy(), ref) <= 1e-8


def test_van_log_prob_matches_jax(n57):
    d = n57
    cfg = cg.TransformerConfig(d["M"], 2, 16, 4, 32)
    params = jax.tree.map(jnp.asarray, _f64(d["ckpt"]["params_van"]))
    _, lp1 = cg.make_autoregressive_sampler(cfg, d["sp"], N, d["M"])
    ref = np.asarray(jax.jit(jax.vmap(lp1, (None, 0), 0))(params, jnp.asarray(d["si"])))
    _, log_prob = make_autoregressive_sampler(d["sp"], N, d["M"])
    with torch.no_grad():
        got = log_prob(d["van"], t(d["si"]))
    assert np.isfinite(ref).all() and _rel(got.numpy(), ref) <= 1e-8


def test_ewald_potential_energy_matches_jax(n57):
    d = n57
    G = kpoints(DIM, GMAX)
    ref = np.asarray(jax.jit(lambda q: cg.potential_energy(q, KAPPA, jnp.asarray(G), d["L"], RS))(
        jnp.asarray(d["x"])))
    got = potential_energy(t(d["x"]), KAPPA, G, d["L"], RS)
    assert np.isfinite(ref).all() and _rel(got.numpy(), ref) <= 1e-8
