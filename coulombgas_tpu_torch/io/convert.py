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
           "van_to_numpy", "flow_to_numpy", "load_reference_checkpoint",
           "adam_state_from_reference", "sr_state_from_reference",
           "ravel_order", "ravel_named", "ravel_params", "unravel_like"]


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

    Returns ``{"x", "params_van", "params_flow"}`` as numpy, and the
    optimizer state ``opt_state`` of a ``main.py`` checkpoint where it has
    one (``adam_state_from_reference``, ``sr_state_from_reference``).  The
    RNG ``key`` is dropped: JAX's threefry key means nothing to PyTorch's
    generators.
    """
    ckpt = load_data(path)
    return {k: ckpt[k] for k in ("x", "params_van", "params_flow", "opt_state") if k in ckpt}


def _named_tensors(tree, module) -> list:
    """A pytree shaped as ``module``'s parameters -> tensors in the order of
    ``module.parameters()``."""
    named = _state_dict(tree, module)
    return [named[k] for k, _ in module.named_parameters()]


def adam_state_from_reference(opt_state, van: Transformer, flow: FermiNet,
                              optimizer: torch.optim.Adam) -> int:
    """Carry ``main.py``'s optax Adam state over into ``optimizer``.

    ``opt_state`` is optax.adam's ``(ScaleByAdamState(count, mu, nu),
    EmptyState())`` over the pytree pair ``(params_van, params_flow)``, as a
    ``main.py`` checkpoint holds it (``io.checkpoint.load_data`` reads the
    optax classes as tuples).  ``optimizer`` is the ``torch.optim.Adam`` over
    ``[*van.parameters(), *flow.parameters()]``: each parameter's
    ``exp_avg`` / ``exp_avg_sq`` become optax's ``mu`` / ``nu`` of the same
    leaf and ``step`` its ``count``, so that the next step is optax's.
    Returns the step count.
    """
    count, mu, nu = opt_state[0]
    params = [*van.parameters(), *flow.parameters()]
    moments = [[*_named_tensors(m[0], van), *_named_tensors(m[1], flow)] for m in (mu, nu)]
    step = int(np.asarray(count))
    state = optimizer.state_dict()
    state["state"] = {
        i: {"step": torch.tensor(float(step), dtype=torch.float32),
            "exp_avg": m.to(p), "exp_avg_sq": v.to(p)}
        for i, (p, m, v) in enumerate(zip(params, *moments))}
    optimizer.load_state_dict(state)
    return step


def sr_state_from_reference(opt_state) -> dict:
    """``main.py``'s hybrid-SR state (the last solve's ``gnorm_van``,
    ``scale_van``, ``gnorm_flow``, ``scale_flow``) as the port's
    ``sr_state``: Python floats."""
    return {k: float(np.asarray(opt_state[k]))
            for k in ("gnorm_van", "scale_van", "gnorm_flow", "scale_flow")}


# ---- the raveled parameter vector ------------------------------------------------
#
# The JAX package flattens a parameter pytree with ``ravel_pytree``: dictionary
# keys sorted, list entries in order, each leaf row-major.  For the flow that is
# final.b, final.w, sp.0.b, sp.0.w, ..., tp.0.b, tp.0.w — not the order of
# ``module.parameters()`` (sp.0.w, sp.0.b, ..., final.b).  Score matrices,
# Fisher matrices and raveled updates of the port use the JAX order, so that
# column j means the same parameter in both packages.


def ravel_order(module) -> list[str]:
    """Parameter names of ``module`` in the order ``ravel_pytree`` gives the
    corresponding pytree's leaves."""
    def key(name):
        return [(0, int(p), "") if p.isdigit() else (1, 0, p) for p in name.split(".")]
    return sorted((k for k, _ in module.named_parameters()), key=key)


def ravel_named(named: dict, order, batch_dims: int = 0):
    """Concatenate ``named[k]`` for k in ``order``, each flattened after its
    first ``batch_dims`` dimensions: the raveled vector ``(P,)`` or, with
    ``batch_dims = 1``, the matrix ``(B, P)``."""
    return torch.cat([named[k].reshape(*named[k].shape[:batch_dims], -1) for k in order],
                     dim=-1)


def ravel_params(module, tensors=None):
    """Raveled vector of ``tensors`` (a list in the order of
    ``module.parameters()``; default: the parameters themselves)."""
    names = [k for k, _ in module.named_parameters()]
    if tensors is None:
        tensors = [p.detach() for p in module.parameters()]
    return ravel_named(dict(zip(names, tensors)), ravel_order(module))


def unravel_like(vec, module) -> list:
    """Inverse of ``ravel_params``: cut a raveled vector into tensors shaped as
    the parameters, returned in the order of ``module.parameters()``."""
    shapes = {k: p.shape for k, p in module.named_parameters()}
    out, at = {}, 0
    for k in ravel_order(module):
        size = shapes[k].numel()
        out[k] = vec[at:at + size].reshape(shapes[k])
        at += size
    if at != vec.numel():
        raise ValueError("raveled vector has %d entries, the module %d" % (vec.numel(), at))
    return [out[k] for k in shapes]
