"""Plane-wave single-particle orbital bases (host numpy).

Fixes the discrete state space over which the autoregressive network works.
The ordering (meshgrid axis order, introsort tie-breaking among degenerate
shells) defines which momentum vector a token index means, so a checkpoint
only loads correctly if it is reproduced exactly.
"""

from __future__ import annotations

import numpy as np

__all__ = ["sp_orbitals", "twist_sort"]


def sp_orbitals(dim: int, Emax: int = 60) -> tuple[np.ndarray, np.ndarray]:
    """Plane-wave orbitals ``(n_1, ..., n_dim)`` with energy ``sum n^2 <= Emax``.

    Returns:
      indices: (n_orbitals, dim) integer array, sorted by energy ascending.
      Es:      (n_orbitals,) integer energies.
    """
    n_max = int(np.floor(np.sqrt(Emax)))
    rng = np.arange(-n_max, n_max + 1)
    grids = np.meshgrid(*([rng] * dim))
    indices = np.stack([g.ravel() for g in grids], axis=-1)
    Es = np.sum(indices**2, axis=-1)
    keep = Es <= Emax
    indices, Es = indices[keep], Es[keep]
    order = np.argsort(Es)
    return indices[order], Es[order]


def twist_sort(indices: np.ndarray, twist) -> tuple[np.ndarray, np.ndarray]:
    """Re-sort orbitals by twisted energy ``(n + theta)^2``.

    Returns the twisted (fractional) indices ``n + theta`` and their
    energies, both sorted ascending.
    """
    twisted = np.asarray(indices, dtype=float) + np.asarray(twist, dtype=float)
    Es = np.sum(twisted**2, axis=-1)
    order = np.argsort(Es)
    return twisted[order], Es[order]
