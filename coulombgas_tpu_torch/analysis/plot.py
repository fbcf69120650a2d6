"""Post-analysis CLI: converged observables and rs-sweep entropy plots.

The port's copy of ``coulombgas_tpu/analysis/plot.py`` (matplotlib only
inside ``main``, for ``--out``): reads the ``data.txt`` logs of a folder of
runs (``main_torch.py``'s run directories have ``main.py``'s names and
columns), applies the exponentially-weighted moving average to the tail of
each trace, and reports/plots S/S0 (entropy relative to the non-interacting
value, from the port's ``analytic/canonical.py``) across the rs sweep.

Run:  python -m coulombgas_tpu_torch.analysis.plot ./runs/ --alpha 0.01 --out sweep.png
"""

from __future__ import annotations

import os

import numpy as np

from .ewm import running_average
from .utils import natural_sort, parse_filename

__all__ = ["collect_runs", "run_tail_stats", "sweep_summary", "main"]

COLUMNS = ["iter", "F", "F_std", "E", "E_std", "K", "K_std", "V", "V_std", "S", "S_std", "accept"]


def collect_runs(folder: str):
    """All run directories under ``folder`` that contain a data.txt."""
    runs = []
    for root, _, files in os.walk(folder):
        if "data.txt" in files and "freefermion" not in root:
            runs.append(root)
    return natural_sort(runs)


def run_tail_stats(rundir: str, alpha: float = 0.01):
    """EWM mean/std of every observable over the trace (last-entry values)."""
    data = np.loadtxt(os.path.join(rundir, "data.txt"), ndmin=2)
    out = {}
    for j, name in enumerate(COLUMNS[1 : data.shape[1]], start=1):
        mean, var = running_average(data[:, j], alpha)
        out[name] = (mean[-1], np.sqrt(max(var[-1], 0.0)))
    out["epochs"] = int(data[-1, 0])
    return out


def sweep_summary(folder: str, alpha: float = 0.01, S0_fn=None):
    """Per-run converged observables, grouped by (n, rs)."""
    rows = []
    for rundir in collect_runs(folder):
        try:
            n, dim, rs, Theta, *_ = parse_filename(os.path.basename(rundir))
        except AttributeError:
            continue
        stats = run_tail_stats(rundir, alpha)
        row = {"run": rundir, "n": n, "dim": dim, "rs": rs, "Theta": Theta}
        row.update({k: v[0] if isinstance(v, tuple) else v for k, v in stats.items()})
        if S0_fn is not None:
            row["S0"] = S0_fn(n, dim, Theta)
            row["S_over_S0"] = row["S"] / row["S0"]
        rows.append(row)
    return rows


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="Summarize/plot converged observables")
    parser.add_argument("folder")
    parser.add_argument("--alpha", type=float, default=0.01, help="EWM decay")
    parser.add_argument("--out", default=None, help="write an S/S0-vs-rs plot (png)")
    parser.add_argument("--S0", action="store_true",
                        help="normalize S by the exact free-fermion entropy (mpmath)")
    args = parser.parse_args(argv)

    S0_fn = None
    if args.S0 or args.out:
        from mpmath import mpf

        from ..analytic.canonical import Z_E

        cache = {}

        def S0_fn(n, dim, Theta):
            key = (n, dim, Theta)
            if key not in cache:
                _, _, S = Z_E(n, dim, mpf(str(Theta)), [mpf("0.25")] * dim, dps=400)
                cache[key] = float(S)
            return cache[key]

    rows = sweep_summary(args.folder, args.alpha, S0_fn)
    if not rows:
        print("no runs found under", args.folder)
        return
    keys = [k for k in ("n", "rs", "Theta", "epochs", "F", "E", "K", "V", "S", "S_over_S0")
            if k in rows[0]]
    print("  ".join("%8s" % k for k in keys))
    for row in rows:
        print("  ".join(
            ("%8.4f" % row[k]) if isinstance(row[k], float) else ("%8s" % row[k]) for k in keys
        ))

    if args.out:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        by_n = {}
        for row in rows:
            by_n.setdefault(row["n"], []).append((row["rs"], row.get("S_over_S0", row["S"])))
        fig, ax = plt.subplots(figsize=(5, 3.4), dpi=150)
        for n, pts in sorted(by_n.items()):
            pts.sort()
            ax.plot([p[0] for p in pts], [p[1] for p in pts], "o-", label=f"n={n}")
        ax.set_xlabel(r"$r_s$")
        ax.set_ylabel(r"$S/S_0$")
        ax.set_xscale("log")
        ax.legend()
        fig.tight_layout()
        fig.savefig(args.out)
        print("wrote", args.out)


if __name__ == "__main__":
    main()
