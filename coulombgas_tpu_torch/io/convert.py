"""Carrying parameters between the JAX package's pytrees and the port.

The JAX package pickles its parameter pytrees as nested dicts and lists of
numpy arrays (``{"sp": [{"w": ..., "b": ...}, ...], ...}``), which
``pickle.load`` reads without JAX.  The port's modules name their parameters
by the same path joined with dots (``sp.0.w``), so the conversion is a
flattening and its inverse.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.ferminet import FermiNet
from ..models.transformer import Transformer
from .checkpoint import load_data

__all__ = ["flatten_tree", "unflatten_tree", "van_from_numpy", "flow_from_numpy",
           "van_to_numpy", "flow_to_numpy", "load_reference_checkpoint"]


def flatten_tree(tree, prefix: str = "") -> dict:
    """Nested dicts/lists of arrays -> {"a.0.w": array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flatten_tree(v, "%s.%s" % (prefix, k) if prefix else str(k)))
    return out


def unflatten_tree(flat: dict):
    """Inverse of ``flatten_tree``: all-digit keys of one level become a list."""
    root: dict = {}
    for name, value in flat.items():
        node = root
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def _state_dict(tree, module):
    flat = flatten_tree(tree)
    want = {k: v for k, v in module.state_dict().items()}
    if set(flat) != set(want):
        raise ValueError("parameter names differ: only in file %s, only in module %s" % (
            sorted(set(flat) - set(want)), sorted(set(want) - set(flat))))
    out = {}
    for k, v in flat.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError("shape of %s: file %s, module %s" % (
                k, v.shape, tuple(want[k].shape)))
        out[k] = torch.from_numpy(np.array(v)).to(want[k].dtype)
    return out


def van_from_numpy(tree, van: Transformer) -> Transformer:
    """Load a ``params_van`` pytree of numpy arrays into ``van`` (in place)."""
    van.load_state_dict(_state_dict(tree, van))
    return van


def flow_from_numpy(tree, flow: FermiNet) -> FermiNet:
    """Load a ``params_flow`` pytree of numpy arrays into ``flow`` (in place)."""
    flow.load_state_dict(_state_dict(tree, flow))
    return flow


def _to_numpy(module):
    return unflatten_tree(
        {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()})


def van_to_numpy(van: Transformer):
    """The VAN's parameters as the JAX package's ``params_van`` pytree."""
    tree = _to_numpy(van)
    if not van.cfg.num_layers:
        tree["layers"] = []
    return tree


def flow_to_numpy(flow: FermiNet):
    """The flow's parameters as the JAX package's ``params_flow`` pytree."""
    tree = _to_numpy(flow)
    tree.setdefault("tp", [])  # depth 1 has no pair layer
    return tree


def load_reference_checkpoint(path: str) -> dict:
    """Read an ``epoch_%06d.pkl`` written by either training script.

    Returns ``{"x", "params_van", "params_flow"}`` as numpy; a foreign RNG
    ``key`` and optimizer state are dropped (neither carries over between the
    two frameworks).
    """
    ckpt = load_data(path)
    return {k: ckpt[k] for k in ("x", "params_van", "params_flow")}
