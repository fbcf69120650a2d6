"""Shared set-up of the tests that hold the PyTorch port against the JAX
package: the same numpy inputs and the same parameters go into both."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import coulombgas_tpu as cg
from coulombgas_tpu_torch.io.convert import flow_from_numpy, van_from_numpy
from coulombgas_tpu_torch.models.ferminet import FermiNet, FermiNetConfig
from coulombgas_tpu_torch.models.transformer import Transformer, TransformerConfig

# The port's tests work on tiny tensors: intra-op threads buy nothing there and
# contend with the other test workers (a third of the files' wall time).
torch.set_num_threads(1)


def box(n, dim):
    return float(np.sqrt(np.pi * n)) if dim == 2 else float((4 / 3 * np.pi * n) ** (1 / 3))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def randomize_biases(tree, rng, scale=0.1):
    """JAX initialises biases to zero; give every leaf named 'b' a value so a
    swapped or dropped bias shows."""
    def visit(node):
        if isinstance(node, dict):
            return {k: (rng.normal(0, scale, np.shape(v)).astype(np.asarray(v).dtype)
                        if k == "b" else visit(v)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [visit(v) for v in node]
        return np.asarray(node)
    return visit(np_tree(tree))


def flow_pair(depth, spsize, tpsize, n, dim, seed=0, dtype=np.float64, stddev=0.3):
    """(jax cfg, jax params, torch flow) holding the same numbers."""
    L = box(n, dim)
    jdtype = jnp.dtype(dtype)
    cfg_j = cg.FermiNetConfig(depth, spsize, tpsize, L, init_stddev=stddev)
    params = cg.init_ferminet_params(jax.random.PRNGKey(seed), cfg_j, dim, jdtype)
    tree = randomize_biases(params, np.random.default_rng(seed))
    params_j = jax.tree.map(jnp.asarray, tree)
    tdtype = torch.float64 if np.dtype(dtype) == np.float64 else torch.float32
    flow = FermiNet(FermiNetConfig(depth, spsize, tpsize, L, stddev), dim, tdtype)
    flow_from_numpy(tree, flow)
    return cfg_j, params_j, flow


def van_pair(M, nlayers, modelsize, nheads, nhidden, dim, seed=0, dtype=np.float64):
    """(jax cfg, jax params, torch van) holding the same numbers."""
    cfg_j = cg.TransformerConfig(M, nlayers, modelsize, nheads, nhidden)
    params = cg.init_transformer_params(jax.random.PRNGKey(seed), cfg_j, dim, jnp.dtype(dtype))
    rng = np.random.default_rng(seed)
    tree = randomize_biases(params, rng)
    # the default init is tiny (0.02 / layers): scale the weights up so the
    # attention and the MLP matter in the comparison
    def grow(node):
        if isinstance(node, dict):
            return {k: (8.0 * v if k == "w" else grow(v)) for k, v in node.items()}
        if isinstance(node, list):
            return [grow(v) for v in node]
        return node
    tree = grow(tree)
    tree["x1hat"] = rng.normal(0, 1.0, (M,)).astype(dtype)
    params_j = jax.tree.map(jnp.asarray, tree)
    tdtype = torch.float64 if np.dtype(dtype) == np.float64 else torch.float32
    van = Transformer(TransformerConfig(M, nlayers, modelsize, nheads, nhidden), dim, tdtype)
    van_from_numpy(tree, van)
    return cfg_j, params_j, van


def orbitals(dim, Emax, dtype=np.float64):
    sp_indices, _ = cg.sp_orbitals(dim, Emax)
    sp_twist, _ = cg.twist_sort(sp_indices, np.full(dim, 0.25))
    return np.asarray(sp_twist[::-1].copy(), dtype)


def walkers(rng, batch, n, dim, M, dtype=np.float64):
    """Walker coordinates in the box and ordered occupation states."""
    x = rng.uniform(0, box(n, dim), (batch, n, dim)).astype(dtype)
    si = np.stack([np.sort(rng.choice(M, n, replace=False)) for _ in range(batch)])
    return x, si.astype(np.int32)


def t(a, dtype=None):
    out = torch.from_numpy(np.array(a))
    if out.dtype == torch.int32:
        out = out.long()
    return out if dtype is None else out.to(dtype)


def hutchinson_probe(key, shape, nchunks=1):
    """The probe the JAX engine draws from ``key`` for a batch ``shape`` cut
    into ``nchunks`` microbatches (``accumulate`` splits the key per chunk)."""
    if nchunks == 1:
        return np.asarray(jax.random.normal(key, shape, jnp.float64))
    chunk = (shape[0] // nchunks,) + tuple(shape[1:])
    return np.concatenate([np.asarray(jax.random.normal(k, chunk, jnp.float64))
                           for k in jax.random.split(key, nchunks)])


def training_stacks(n=4, dim=2, batch=8, Emax=4, rs=5.0, kappa=6, gmax=5, theta=0.15, seed=0):
    """Both packages' loss and score functions over the same models, walkers
    and constants (f64): everything a whole-step comparison needs."""
    from coulombgas_tpu.train.loss import make_loss as jax_make_loss
    from coulombgas_tpu.wavefunction.fast_laplacian import (
        make_logpsi_grad_laplacian_analytic as jax_make_gl,
    )
    from coulombgas_tpu_torch.models.ferminet_jac import (
        ferminet_apply_and_jac, ferminet_apply_jac_lap,
    )
    from coulombgas_tpu_torch.physics import ewald
    from coulombgas_tpu_torch.sampling.autoregressive import (
        make_autoregressive_sampler, make_classical_score,
    )
    from coulombgas_tpu_torch.train.loss import make_loss
    from coulombgas_tpu_torch.wavefunction.fast_laplacian import (
        make_logpsi_grad_laplacian_analytic,
    )
    from coulombgas_tpu_torch.wavefunction.logpsi import make_logpsi_fast, make_quantum_score

    sp = orbitals(dim, Emax)
    M = sp.shape[0]
    cfg_f, params_flow, flow = flow_pair(2, 6, 5, n, dim, seed=seed, stddev=0.1)
    cfg_v, params_van, van = van_pair(M, 1, 8, 2, 12, dim, seed=seed + 1)
    L = cfg_f.L
    x, si = walkers(np.random.default_rng(seed), batch, n, dim, M)
    G = ewald.kpoints(dim, gmax)
    Vconst = n * rs / L * ewald.madelung(dim, kappa, G)
    beta = 1 / (4 * theta)

    _, log_prob_1 = cg.make_autoregressive_sampler(cfg_v, sp, n, M)
    jac = lambda p, q: cg.ferminet_apply_and_jac(p, cfg_f, q)
    jac_lap = lambda p, q: cg.ferminet_apply_jac_lap(p, cfg_f, q)
    logpsi_1 = cg.make_logpsi_fast(jac, sp, L)
    logpsi_j, _ = cg.make_logpsi_grad_laplacian(logpsi_1)
    gl_j = jax_make_gl(lambda p, q: cg.ferminet_apply(p, cfg_f, q), sp, L,
                       hutchinson=True, flow_jac_lap=jac_lap)
    loss_j = jax_make_loss(jax.vmap(log_prob_1, (None, 0), 0), logpsi_j, gl_j, kappa,
                           np.asarray(G, np.float64), L, rs, Vconst, beta)

    _, log_prob = make_autoregressive_sampler(sp, n, M)
    logpsi = make_logpsi_fast(ferminet_apply_and_jac, sp, L)
    gl = make_logpsi_grad_laplacian_analytic(sp, L, ferminet_apply_jac_lap,
                                             flow_jac=ferminet_apply_and_jac)
    loss = make_loss(log_prob, logpsi, gl, kappa, G, L, rs, Vconst, beta)
    return dict(
        sp=sp, L=L, x=x, si=si, van=van, flow=flow, params_van=params_van,
        params_flow=params_flow, loss_j=loss_j, loss=loss, log_prob=log_prob, logpsi=logpsi,
        classical_score_j=cg.make_classical_score(log_prob_1),
        quantum_score_j=cg.make_quantum_score(logpsi_1),
        classical_score=make_classical_score(log_prob),
        quantum_score=make_quantum_score(logpsi),
    )
