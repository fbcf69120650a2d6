"""Plane-wave single-particle orbital bases and many-body state enumeration
(host numpy).

Fixes the discrete state space over which the autoregressive network works.
The ordering (meshgrid axis order, introsort tie-breaking among degenerate
shells) defines which momentum vector a token index means, so a checkpoint
only loads correctly if it is reproduced exactly.  The port's copy of
``coulombgas_tpu/physics/orbitals.py``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["sp_orbitals", "twist_sort", "manybody_orbitals", "closed_shells"]


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


def manybody_orbitals(n: int, dim: int, Ecut: int) -> tuple[np.ndarray, np.ndarray]:
    """Every n-fermion occupation state within ``E0 + Ecut``, ``E0`` the
    n-fermion ground-state energy (the sum of the n lowest orbital
    energies).  Used for diagnostics and exhaustive-normalization checks.

    The native enumeration (``ops/native``) where it builds, the Python DFS
    over the energy-sorted orbitals otherwise (no ``g++``; also the
    differential oracle); either way the states are then sorted stably by
    total energy.

    Returns:
      mb_indices: (n_states, n, dim) plane-wave indices of each state,
      mb_Es:      (n_states,) total energies, sorted ascending.
    """
    indices, Es = sp_orbitals(dim)
    Es = Es.astype(np.int64)
    M = Es.size
    Emax_tot = int(Es[:n].sum()) + Ecut

    from ..ops.native import enumerate_subsets

    occ = enumerate_subsets(Es, n, Emax_tot)
    if occ is not None:
        totals = Es[occ].sum(axis=1)
        order = np.argsort(totals, kind="stable")
        return indices[occ[order], :], totals[order]

    # cheapest way to place k particles at or above slot i: Es is ascending,
    # so it is Es[i:i+k].sum()
    cumsum = np.concatenate([[0], np.cumsum(Es)])

    def tail_min(i: int, k: int) -> int:
        return int(cumsum[i + k] - cumsum[i])

    results: list[tuple[int, ...]] = []
    totals: list[int] = []
    stack: list[tuple[tuple[int, ...], int, int]] = [((), 0, 0)]
    while stack:
        chosen, next_i, etot = stack.pop()
        if len(chosen) == n:
            results.append(chosen)
            totals.append(etot)
            continue
        remaining = n - len(chosen)
        for i in range(next_i, M - remaining + 1):
            e_new = etot + int(Es[i])
            # even the cheapest completion overshoots, and so does every later i
            if e_new + tail_min(i + 1, remaining - 1) > Emax_tot:
                break
            stack.append((chosen + (i,), i + 1, e_new))

    order = np.argsort(totals, kind="stable")
    occ = np.array(results, dtype=np.int64)[order]
    return indices[occ, :], np.array(totals, dtype=np.int64)[order]


def closed_shells(dim: int, Emax: int = 60) -> list[tuple[int, int]]:
    """(n, Ef) pairs at which the Fermi sea is a closed shell (diagnostic)."""
    _, Es = sp_orbitals(dim, Emax)
    out = []
    Ef = Es[0]
    for i in range(Es.size):
        if Es[i] != Ef:
            out.append((i, int(Ef)))
            Ef = Es[i]
    out.append((int(Es.size), int(Es[-1])))
    return out
