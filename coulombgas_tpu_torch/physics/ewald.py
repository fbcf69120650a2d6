"""Ewald summation of the periodic Coulomb interaction.

Counterpart of ``coulombgas_tpu/physics/ewald.py`` (structure-factor form),
batched over walkers.  Units and conventions: box of unit length for
``ewald_sum``, nearest-image-only minimum-image convention for the
short-range part, energies in Ry/rs^2 from ``potential_energy``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["kpoints", "madelung", "ewald_sum", "ewald_sum_pairs", "potential_energy"]


def kpoints(dim: int, Gmax: int) -> np.ndarray:
    """Integer reciprocal-mesh points with 0 < |G| <= Gmax (host numpy)."""
    rng = np.arange(-Gmax, Gmax + 1)
    grids = np.meshgrid(*([rng] * dim), indexing="ij")
    G = np.stack([g.ravel() for g in grids], axis=-1)
    G2 = np.sum(G**2, axis=-1)
    return G[(G2 <= Gmax**2) & (G2 > 0)]


def _gk_g0(dim: int, kappa, Gnorm):
    """Reciprocal-space kernel g_k and G=0 correction g_0 (unit box)."""
    if dim == 3:
        g_k = torch.exp(-(math.pi**2) * Gnorm**2 / kappa**2) / (math.pi * Gnorm**2)
        g_0 = -math.pi / kappa**2
    elif dim == 2:
        g_k = torch.special.erfc(math.pi * Gnorm / kappa) / Gnorm
        g_0 = -2 * math.sqrt(math.pi) / kappa
    else:
        raise ValueError(f"Ewald sum only implemented for dim in (2, 3), got {dim}")
    return g_k, g_0


def madelung(dim: int, kappa, G) -> float:
    """Madelung constant of the simple-cubic lattice with L=1: the potential
    felt by a unit charge at its own lattice site.  Host scalar, f64."""
    G = torch.as_tensor(np.asarray(G), dtype=torch.float64)
    g_k, g_0 = _gk_g0(dim, kappa, torch.linalg.vector_norm(G, dim=-1))
    return float(g_k.sum() + g_0 - 2 * kappa / math.sqrt(math.pi))


def _mesh(G, x):
    """The mesh G as a tensor of x's dtype on x's device."""
    if not isinstance(G, torch.Tensor):
        G = np.asarray(G)
    return torch.as_tensor(G, dtype=x.dtype, device=x.device)


def ewald_sum(x, kappa, G):
    """Coordinate-dependent electrostatic energy for a unit periodic box.

    ``0.5 * sum_{i != j} psi(r_i, r_j)`` with the Ewald split at screening
    parameter ``kappa``; the Madelung self-term is *not* included.  The
    reciprocal sum uses the structure factor S(G) = sum_i e^{2 pi i G.u_i}:
    sum_{i<j} cos(2 pi G . r_ij) = (|S(G)|^2 - n) / 2, exact for integer G.

    INPUT: x (..., n, dim) in the unit box; G (NG, dim) integer mesh, host
    (numpy) or a tensor of x's dtype on x's device (used as it is: no copy).
    OUTPUT: (...,).
    """
    n, dim = x.shape[-2:]
    G = _mesh(G, x)

    rij = x[..., :, None, :] - x[..., None, :, :]
    rij = rij - torch.round(rij)
    iu = torch.triu(torch.ones(n, n, dtype=torch.bool, device=x.device), diagonal=1)

    # Short range: erfc(kappa d)/d over unique pairs; the masked-out distances
    # are shifted to 1 to keep the division finite.
    d2 = (rij**2).sum(dim=-1)
    d = torch.sqrt(torch.where(iu, d2, torch.ones_like(d2)))
    V_short = torch.where(iu, torch.special.erfc(kappa * d) / d,
                          torch.zeros_like(d)).sum(dim=(-2, -1))

    # Long range via the structure factor.
    g_k, g_0 = _gk_g0(dim, kappa, torch.linalg.vector_norm(G, dim=-1))
    theta = 2 * math.pi * (x @ G.T)  # (..., n, NG)
    S2 = torch.cos(theta).sum(dim=-2) ** 2 + torch.sin(theta).sum(dim=-2) ** 2
    npairs = n * (n - 1) // 2
    V_long = (g_k * (S2 - n)).sum(dim=-1) / 2 + g_0 * npairs
    return V_short + V_long


def ewald_sum_pairs(x, kappa, G):
    """Dense O(n^2 NG) pair-sum form of ``ewald_sum``'s reciprocal part:
    sum_{i<j} cos(2 pi G . r_ij) summed over the pairs directly.  The same
    number as ``ewald_sum`` (the differential-test oracle of the structure
    factor), batched the same way: x (..., n, dim) -> (...,)."""
    n, dim = x.shape[-2:]
    G = _mesh(G, x)
    rij = x[..., :, None, :] - x[..., None, :, :]
    rij = rij - torch.round(rij)
    iu = torch.triu(torch.ones(n, n, dtype=torch.bool, device=x.device), diagonal=1)
    d2 = (rij**2).sum(dim=-1)
    d = torch.sqrt(torch.where(iu, d2, torch.ones_like(d2)))
    V_short = torch.where(iu, torch.special.erfc(kappa * d) / d,
                          torch.zeros_like(d)).sum(dim=(-2, -1))

    g_k, g_0 = _gk_g0(dim, kappa, torch.linalg.vector_norm(G, dim=-1))
    phases = 2 * math.pi * torch.einsum("gd,...ijd->...gij", G, rij)
    pair_cos = torch.where(iu, torch.cos(phases), torch.zeros_like(phases)).sum(dim=(-2, -1))
    npairs = n * (n - 1) // 2
    V_long = (g_k * pair_cos).sum(dim=-1) + g_0 * npairs
    return V_short + V_long


def potential_energy(x, kappa, G, L, rs):
    """Batched potential energy in Ry/rs^2 for a box of size L.

    Only the coordinate-dependent part; add ``n*rs/L * madelung(dim, kappa, G)``
    for the constant piece.  x (batch, n, dim) -> (batch,); G as ``ewald_sum``
    takes it.
    """
    return 2 * rs / L * ewald_sum(x / L, kappa, G)
