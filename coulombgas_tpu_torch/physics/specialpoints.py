"""Monkhorst-Pack special twist points for twist-averaged boundary conditions
(host numpy; the port's copy of ``coulombgas_tpu/physics/specialpoints.py``).

Capability parity with reference src/specialpoints.py:3-23 (2D grids with the
symmetry-reduced weights); extended with the generic construction for any
(dim, Nk) so 3D TABC works too.
"""

from __future__ import annotations

import itertools

import numpy as np

__all__ = ["Monkhorst_Pack", "monkhorst_pack_full"]


def monkhorst_pack_full(dim: int, Nk: int) -> tuple[list[np.ndarray], list[float]]:
    """Full (unreduced) Monkhorst-Pack grid: Nk^dim twists with equal weight.

    Twist components are ``(2*i - Nk + 1) / (2*Nk)`` for i in [0, Nk).
    """
    pts_1d = (2 * np.arange(Nk) - Nk + 1) / (2 * Nk)
    twists = [np.array(t) for t in itertools.product(pts_1d, repeat=dim)]
    w = 1.0 / len(twists)
    return twists, [w] * len(twists)


def Monkhorst_Pack(dim: int, Nk: int) -> tuple[list[np.ndarray], list[float]]:
    """Symmetry-reduced MP twist grids.

    For 2D and Nk <= 4 returns the same reduced points/weights the reference
    hard-codes (src/specialpoints.py:4-23); otherwise falls back to the full
    unreduced grid (equal weights), which averages to the same result.
    """
    if dim == 2:
        if Nk == 1:
            return [np.array([0.0, 0.0])], [1.0]
        if Nk == 2:
            return [np.array([0.25, 0.25])], [1.0]
        if Nk == 3:
            return (
                [np.array([0.0, 0.0]), np.array([1 / 3, 0.0]), np.array([1 / 3, 1 / 3])],
                [1 / 9, 4 / 9, 4 / 9],
            )
        if Nk == 4:
            return (
                [np.array([1 / 8, 1 / 8]), np.array([3 / 8, 1 / 8]), np.array([3 / 8, 3 / 8])],
                [1 / 4, 1 / 2, 1 / 4],
            )
    return monkhorst_pack_full(dim, Nk)
