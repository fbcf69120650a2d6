"""Exact canonical-ensemble thermodynamics of free fermions (mpmath).

The correctness oracle of the pretraining: arbitrary-precision partition
function, energy, free energy and entropy of n free spinless fermions in a
periodic box, via the fermionic recursion

    Z_N = (1/N) sum_{k=1}^{N} (-1)^(k-1) z(k*beta) Z_{N-k},

whose alternating signs demand very high working precision.  The port's
copy of ``coulombgas_tpu/analytic/canonical.py`` (same functions, same
numbers).  ``mpmath`` is imported inside the functions, so importing this
module needs nothing beyond the port's own dependencies.
"""

from __future__ import annotations

__all__ = ["z_e", "Z_E", "box_parameters"]


def box_parameters(n: int, dim: int, Theta):
    """Box size L and inverse temperature beta from (n, dim, Theta).

    Same conventions as main.py and main_torch.py: 2D L=sqrt(pi n),
    beta = 1/(4 Theta); 3D L=(4 pi n/3)^(1/3), beta = 1/((4.5 pi)^(2/3) Theta).
    Energies are in Ry/rs^2 throughout.
    """
    from mpmath import mp, mpf

    Theta = mpf(str(Theta)) if not isinstance(Theta, mpf) else Theta
    if dim == 3:
        L = (mpf(4) / 3 * mp.pi * n) ** (mpf(1) / 3)
        beta = 1 / ((mpf("4.5") * mp.pi) ** (mpf(2) / 3) * Theta)
    elif dim == 2:
        L = mp.sqrt(mp.pi * n)
        beta = 1 / (4 * Theta)
    else:
        raise ValueError(f"dim must be 2 or 3, got {dim}")
    return L, beta


def _z_e_exact_1d(c, beta, theta):
    """sum_{m in Z} exp(-beta c (m+theta)^2) and its energy moment, exactly.

    Truncates where additional terms fall below the working precision:
    beta*c*(m+theta)^2 > dps*ln(10) + margin.
    """
    from mpmath import mp, mpf

    a = beta * c
    m_max = int(mp.ceil(mp.sqrt((mp.dps + 10) * mp.log(10) / a))) + 2
    z = mpf(0)
    ze = mpf(0)  # sum of E * weight
    for m in range(-m_max, m_max + 1):
        E = c * (m + theta) ** 2
        w = mp.exp(-beta * E)
        z += w
        ze += E * w
    return z, ze / z


def z_e(dim: int, L, beta, twist, Emax=None):
    """Single-particle partition function and mean energy in the box.

    With ``Emax`` the spectrum is truncated to the same finite orbital set the
    VAN uses (for pretraining parity); with ``Emax=None`` the infinite sum is
    evaluated to working precision.
    """
    from mpmath import mp, mpf

    c = (2 * mp.pi / L) ** 2
    if Emax is not None:
        from ..physics.orbitals import sp_orbitals

        sp_indices, _ = sp_orbitals(dim, Emax)
        Es = [
            c * mp.fsum((mpf(int(idx_i)) + t_i) ** 2 for idx_i, t_i in zip(idx, twist))
            for idx in sp_indices
        ]
        z = mp.fsum(mp.exp(-beta * E) for E in Es)
        e = mp.fsum(E * mp.exp(-beta * E) for E in Es) / z
        return z, e

    z, e = mpf(1), mpf(0)
    for t in twist:
        z_d, e_d = _z_e_exact_1d(c, beta, mpf(str(t)))
        z *= z_d
        e += e_d
    return z, e


def Z_E(n: int, dim: int, Theta, twist, Emax=None, dps: int = 1200):
    """Exact F, E, S of n free spinless fermions (canonical ensemble).

    Theta is T/T_F, ``twist`` a list of
    dim components in (-1/2, 1/2].  Returns mpmath values (units Ry/rs^2 for
    F and E; S dimensionless).  ``dps`` is the mpmath working precision; the
    alternating recursion cancels ~n*log10(z_1) digits, so 1200 is the safe
    default (tests may lower it).
    """
    from mpmath import mp, mpf

    mp.dps = dps
    L, beta = box_parameters(n, dim, Theta)

    zs, es = zip(*[z_e(dim, L, k * beta, twist, Emax) for k in range(1, n + 1)])

    Zs = [mpf(1)]
    Es = [mpf(0)]
    for N in range(1, n + 1):
        Z = mp.fsum((-1) ** (k - 1) * zs[k - 1] * Zs[N - k] for k in range(1, N + 1)) / N
        E = (
            mp.fsum(
                (-1) ** (k - 1) * zs[k - 1] * Zs[N - k] * (k * es[k - 1] + Es[N - k])
                for k in range(1, N + 1)
            )
            / N
            / Z
        )
        Zs.append(Z)
        Es.append(E)

    F = -mp.log(Zs[-1]) / beta
    E = Es[-1]
    S = beta * (E - F)
    return F, E, S
