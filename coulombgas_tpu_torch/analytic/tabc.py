"""Twist-averaged boundary conditions via random twist sampling (host CLI).

The port's copy of ``coulombgas_tpu/analytic/tabc.py`` (mpmath on the host,
over the port's ``analytic/canonical.py:Z_E``): samples random twists,
evaluates the exact canonical-ensemble F/E/S at each, appends them to
``twists.txt`` (the same format, resumable with ``Ntwists_finished``), and
reports PBC vs twist-averaged statistics.  The twists come from
``mp.rand()``, which draws from Python's ``random`` module, so a
``random.seed`` before the call fixes them.

Run:  python -m coulombgas_tpu_torch.analytic.tabc --n 37 --dim 2 --Theta 0.15
"""

from __future__ import annotations

import os

import numpy as np
from mpmath import mp, mpf

from .canonical import Z_E

__all__ = ["tabc"]


def _path(folder, n, dim, Theta, Emax):
    return os.path.join(folder, "n_%d_dim_%d_Theta_%f_Emax_%s" % (n, dim, Theta, Emax))


def tabc(n, dim, Theta, Emax, Ntwists, Ntwists_finished=0, folder=".", dps=1200):
    """Random-twist average of the exact free-fermion thermodynamics.

    Twist index 0 is the PBC (zero-twist) point; indices >= 1 are uniform
    random twists in (-1/2, 1/2)^dim.  Returns
    (F_pbc, E_pbc, S_pbc, F_tabc, F_std, E_tabc, E_std, S_tabc, S_std).
    """
    path = _path(folder, n, dim, Theta, Emax)
    os.makedirs(path, exist_ok=True)
    filename = os.path.join(path, "twists.txt")

    if Ntwists > Ntwists_finished:
        start = 0 if Ntwists_finished == 0 else Ntwists_finished + 1
        with open(filename, "w" if Ntwists_finished == 0 else "a", buffering=1,
                  newline="\n") as f:
            for i in range(start, Ntwists + 1):
                twist = ([mpf(0)] * dim if i == 0
                         else [mp.rand() - mpf("0.5") for _ in range(dim)])
                F, E, S = Z_E(n, dim, mpf(str(Theta)), twist, Emax=Emax, dps=dps)
                line = ("%6d" + "  %s" * dim + "  %s" * 3 + "\n") % (
                    i, *[mp.nstr(t) for t in twist], mp.nstr(F), mp.nstr(E), mp.nstr(S),
                )
                print(line, end="")
                f.write(line)

    _, *twist, F, E, S = np.loadtxt(filename, unpack=True)
    F_pbc, E_pbc, S_pbc = F[0], E[0], S[0]
    F, E, S = F[1:], E[1:], S[1:]
    return (
        F_pbc, E_pbc, S_pbc,
        F.mean(), F.std(), E.mean(), E.std(), S.mean(), S.std(),
    )


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(
        description="Exact free-fermion canonical-ensemble TABC via random twist sampling."
    )
    parser.add_argument("--n", type=int, default=37)
    parser.add_argument("--dim", type=int, default=2)
    parser.add_argument("--Theta", type=float, default=0.15)
    parser.add_argument("--Emax", type=int, default=None)
    parser.add_argument("--Ntwists", type=int, default=10000)
    parser.add_argument("--Ntwists_finished", type=int, default=0)
    parser.add_argument("--folder", default="./tabc_data")
    parser.add_argument("--dps", type=int, default=1200)
    args = parser.parse_args()

    print(
        "---- n = %d, dim = %d, Theta = %f, Emax = %s ----"
        % (args.n, args.dim, args.Theta, args.Emax)
    )
    out = tabc(
        args.n, args.dim, args.Theta, args.Emax,
        args.Ntwists, args.Ntwists_finished, args.folder, args.dps,
    )
    print(
        "F_pbc: %f, E_pbc: %f, S_pbc: %f\n"
        "F_tabc: %f, F_tabc_std: %f\n"
        "E_tabc: %f, E_tabc_std: %f\n"
        "S_tabc: %f, S_tabc_std: %f" % out
    )
