"""Checkpoint persistence and run-directory conventions.

Pickle files ``epoch_%06d.pkl`` / ``params_van.pkl``, with all run
hyperparameters encoded in the directory name — the same files and names as
``coulombgas_tpu/io/checkpoint.py`` writes.  Tensors are turned into host
numpy arrays before pickling, so a file never depends on a device.

A checkpoint of ``main.py`` under Adam pickles optax's state classes
(``ScaleByAdamState``, ``EmptyState``: named tuples).  ``load_data`` reads
them without optax or JAX: each class of the JAX stack becomes a plain tuple
subclass of the same name, holding the same fields in the same order.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

__all__ = ["save_data", "load_data", "ckpt_filename", "pretrained_model_filename",
           "to_host", "from_host", "ForeignTuple"]


def to_host(tree):
    """Nested dicts/lists/tuples of tensors -> the same of numpy arrays."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def from_host(tree):
    """Inverse of ``to_host``: numpy arrays back to (CPU) tensors."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    if isinstance(tree, dict):
        return {k: from_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_host(v) for v in tree)
    return tree


def save_data(data, filename: str) -> None:
    with open(filename, "wb") as f:
        pickle.dump(to_host(data), f)


# The one package whose classes a ``main.py`` checkpoint names: optax's
# optimizer states (``ScaleByAdamState``, ``EmptyState``).  Any other class
# (of the JAX stack too: a pickled ``jax.Array``) is looked up as pickle does,
# and raises from ``find_class`` where its package is missing.
_FOREIGN_PACKAGE = "optax"
_FOREIGN_CLASSES: dict = {}


class ForeignTuple(tuple):
    """Stands in for a named tuple of the JAX stack (optax's optimizer
    states); ``foreign`` names the class it replaces."""

    foreign = ""

    def __new__(cls, *fields):
        return super().__new__(cls, fields)

    def __repr__(self):
        return "%s%s" % (self.foreign, tuple.__repr__(self))


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] != _FOREIGN_PACKAGE:
            return super().find_class(module, name)
        key = "%s.%s" % (module, name)
        if key not in _FOREIGN_CLASSES:
            _FOREIGN_CLASSES[key] = type(name, (ForeignTuple,), {"foreign": key})
        return _FOREIGN_CLASSES[key]


def load_data(filename: str):
    with open(filename, "rb") as f:
        return _Unpickler(f).load()


def ckpt_filename(epoch: int, path: str) -> str:
    return os.path.join(path, "epoch_%06d.pkl" % epoch)


def pretrained_model_filename(path: str) -> str:
    return os.path.join(path, "params_van.pkl")
