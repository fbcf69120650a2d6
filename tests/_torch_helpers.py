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
