"""Twist averaging on Monkhorst-Pack special points (host CLI).

The port's copy of ``coulombgas_tpu/analytic/tabc_specialpoints.py`` (mpmath
on the host, over the port's ``analytic/canonical.py:Z_E`` and
``physics/specialpoints.py``): the weighted MP-grid average of the exact
canonical F/E/S (``twists_Nk_%d.txt``, the same format), plus the
temperature-dependence sweep.  The output directory is a CLI flag.

Run:  python -m coulombgas_tpu_torch.analytic.tabc_specialpoints --n 57 --dim 2 --Nk 2
"""

from __future__ import annotations

import os

import numpy as np
from mpmath import mp, mpf

from ..physics.specialpoints import Monkhorst_Pack
from .canonical import Z_E

__all__ = ["tabc_specialpoints", "tabc_specialpoints_T_dependence"]


def _path(folder, n, dim, Theta, Emax):
    return os.path.join(folder, "n_%d_dim_%d_Theta_%f_Emax_%s" % (n, dim, Theta, Emax))


def tabc_specialpoints(n, dim, Theta, Emax, Nk, folder=".", dps=1200):
    """Weighted Monkhorst-Pack average of the exact thermodynamics."""
    path = _path(folder, n, dim, Theta, Emax)
    os.makedirs(path, exist_ok=True)
    filename = os.path.join(path, "twists_Nk_%d.txt" % Nk)

    if not os.path.isfile(filename):
        twists, weights = Monkhorst_Pack(dim, Nk)
        with open(filename, "w", buffering=1, newline="\n") as f:
            for twist, weight in zip(twists, weights):
                twist = [mpf(t) for t in twist]
                F, E, S = Z_E(n, dim, mpf(str(Theta)), twist, Emax=Emax, dps=dps)
                line = ("%f" + "  %s" * dim + "  %s" * 3 + "\n") % (
                    weight, *[mp.nstr(t) for t in twist], mp.nstr(F), mp.nstr(E), mp.nstr(S),
                )
                print(line, end="")
                f.write(line)

    weight, *twist, F, E, S = np.loadtxt(filename, unpack=True, ndmin=2)
    return (weight * F).sum(), (weight * E).sum(), (weight * S).sum()


def tabc_specialpoints_T_dependence(n, dim, Nk, folder=".", dps=1200):
    """Per-particle f/e/s vs Theta on the MP grid (diagnostic sweep)."""
    path = os.path.join(folder, "T_dependence")
    os.makedirs(path, exist_ok=True)
    filename = os.path.join(path, "n_%d_dim_%d_Nk_%d.txt" % (n, dim, Nk))

    twists, weights = Monkhorst_Pack(dim, Nk)
    with open(filename, "w", buffering=1, newline="\n") as fp:
        fp.write("#Theta\tf\te\ts\n")
        for Theta in mp.linspace(mpf("0.02"), mpf("0.60"), 59):
            f = e = s = mpf(0)
            for twist, weight in zip(twists, weights):
                twist = [mpf(t) for t in twist]
                F, E, S = Z_E(n, dim, Theta, twist, Emax=None, dps=dps)
                f += weight * F / n
                e += weight * E / n
                s += weight * S / n
            fp.write(("%s" + "\t%s" * 3 + "\n") % tuple(mp.nstr(v) for v in (Theta, f, e, s)))
            print("Theta:", mp.nstr(Theta), "f:", mp.nstr(f), "e:", mp.nstr(e), "s:", mp.nstr(s))


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(
        description="Exact free-fermion canonical-ensemble TABC on Monkhorst-Pack points."
    )
    parser.add_argument("--n", type=int, default=37)
    parser.add_argument("--dim", type=int, default=2)
    parser.add_argument("--Theta", type=float, default=0.15)
    parser.add_argument("--Emax", type=int, default=None)
    parser.add_argument("--Nk", type=int, default=2)
    parser.add_argument("--folder", default="./tabc_data")
    parser.add_argument("--dps", type=int, default=1200)
    args = parser.parse_args()

    print(
        "---- n = %d, dim = %d, Theta = %f, Emax = %s, Nk = %d ----"
        % (args.n, args.dim, args.Theta, args.Emax, args.Nk)
    )
    out = tabc_specialpoints(args.n, args.dim, args.Theta, args.Emax, args.Nk, args.folder, args.dps)
    print("F_mean: %f, E_mean: %f, S_mean: %f" % out)
