"""Checkpoint persistence and run-directory conventions.

Pickle files ``epoch_%06d.pkl`` / ``params_van.pkl``, with all run
hyperparameters encoded in the directory name — the same files and names as
``coulombgas_tpu/io/checkpoint.py`` writes.  Tensors are turned into host
numpy arrays before pickling, so a file never depends on a device.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

__all__ = ["save_data", "load_data", "ckpt_filename", "pretrained_model_filename",
           "to_host", "from_host"]


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


def load_data(filename: str):
    with open(filename, "rb") as f:
        return pickle.load(f)


def ckpt_filename(epoch: int, path: str) -> str:
    return os.path.join(path, "epoch_%06d.pkl" % epoch)


def pretrained_model_filename(path: str) -> str:
    return os.path.join(path, "params_van.pkl")
