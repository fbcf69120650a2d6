"""Free-fermion thermodynamics in the thermodynamic limit (mpmath).

Fugacity root-solve + polylogarithm formulas for the per-particle free
energy, energy and entropy at n -> infinity.  The port's copy of
``coulombgas_tpu/analytic/thermo.py``; ``mpmath`` is imported inside the
function.
"""

from __future__ import annotations

__all__ = ["thermo_quantities"]


def thermo_quantities(dim: int, Theta, dps: int = 50):
    """Returns (z, f, e, s): fugacity and per-particle F, E (Ry/rs^2), S.

    Derivation: for spinless fermions at density fixed by rs, the number
    equation is -Gamma(d/2+1) Li_{d/2}(-z) Theta^{d/2} = 1 (energies in units
    of the Fermi energy eps_F = 4*Gamma(d/2+1)^{4/d} Ry/rs^2).
    """
    from mpmath import mp, mpf

    mp.dps = dps
    d = mpf(dim)
    Theta = mpf(str(Theta))
    if dim == 2:
        # closed form: -Li_1(-z) = log(1+z), so log(1+z)*Theta = 1.
        z = mp.expm1(1 / Theta)
    else:
        # Sommerfeld guess log z ~ 1/Theta keeps findroot stable at low T.
        z0 = mp.exp(1 / Theta)
        z = mp.findroot(
            lambda z: mp.gamma(d / 2 + 1) * mp.polylog(d / 2, -z) * Theta ** (d / 2) + 1, z0
        )
    eps_F = 4 * mp.gamma(d / 2 + 1) ** (4 / d)
    ratio = mp.polylog(d / 2 + 1, -z) / mp.polylog(d / 2, -z)
    e = d / 2 * ratio * Theta * eps_F
    s = (d / 2 + 1) * ratio - mp.log(z)
    f = e - Theta * eps_F * s
    return z, f, e, s
