"""Compare the tails of training runs' ``data.txt`` logs, column by column.

The statistic of the port's done-criterion run (ROADMAP.md, order of work):
for each of F, E, K, V, S and the accept rate, the mean over the last
``--tail`` epochs of each run, with its standard error se from ``--blocks``
block means (consecutive epochs are correlated: the walkers and parameters
carry over).  The first log is the run held; the others (at least two) are
repeats of the reference, which give its centre m_R (the mean of their tail
means), the standard error of that centre se_R (sqrt of the sum of their
se^2, over their count), and the run-to-run spread s (the sample standard
deviation of their tail means: the training path itself varies between
seeds, most of all in S).  The run agrees where, for every column,

    z = |m - m_R| / sqrt(se^2 + se_R^2 + s^2) <= --threshold (3).

For context every pair of logs is also printed with the plain two-run
z = |m_a - m_b| / sqrt(se_a^2 + se_b^2).

Run:
  python scripts/done_criterion_torch.py PORT/data.txt JAX/data.txt JAX_R3/data.txt

Prints one table per pair and, as its last line, one JSON object with the
means, standard errors, z and the verdict of each pair.  Reads text files
only: numpy, no JAX and no torch.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os

import numpy as np

# data.txt columns (main.py and main_torch.py write the same)
COLUMNS = {"F": 1, "E": 3, "K": 5, "V": 7, "S": 9, "accept": 11}


def tail_stats(path: str, tail: int, blocks: int) -> dict:
    data = np.loadtxt(path, ndmin=2)
    if data.shape[0] < tail:
        raise SystemExit("%s has %d epochs, fewer than --tail %d" % (path, data.shape[0], tail))
    rows = data[-tail:]
    out = {"epochs": [int(rows[0, 0]), int(rows[-1, 0])]}
    for name, j in COLUMNS.items():
        means = rows[: tail - tail % blocks, j].reshape(blocks, -1).mean(axis=1)
        out[name] = (float(rows[:, j].mean()), float(means.std(ddof=1) / np.sqrt(blocks)))
    return out


def compare(a: dict, b: dict, threshold: float) -> dict:
    z = {}
    for name in COLUMNS:
        (ma, sa), (mb, sb) = a[name], b[name]
        z[name] = abs(ma - mb) / float(np.hypot(sa, sb))
    return {"z": z, "agree": all(v <= threshold for v in z.values())}


def against_reference(run: dict, refs: list, threshold: float) -> dict:
    out = {}
    for name in COLUMNS:
        m, se = run[name]
        ms = np.array([r[name][0] for r in refs])
        se_r = float(np.sqrt(sum(r[name][1] ** 2 for r in refs)) / len(refs))
        spread = float(ms.std(ddof=1))
        z = abs(m - ms.mean()) / float(np.sqrt(se**2 + se_r**2 + spread**2))
        out[name] = {"m": m, "m_R": float(ms.mean()), "diff": float(m - ms.mean()), "se": se,
                     "se_R": se_r, "spread": spread, "z": float(z)}
    return {"columns": out, "agree": all(v["z"] <= threshold for v in out.values())}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("logs", nargs="+", help="data.txt files; the first is the run held")
    parser.add_argument("--tail", type=int, default=100)
    parser.add_argument("--blocks", type=int, default=10)
    parser.add_argument("--threshold", type=float, default=3.0)
    args = parser.parse_args(argv)

    stats = [tail_stats(p, args.tail, args.blocks) for p in args.logs]
    names = [os.path.basename(os.path.dirname(os.path.dirname(os.path.abspath(p))))
             for p in args.logs]
    for name, st in zip(names, stats):
        print("%s, epochs %d-%d:" % (name, *st["epochs"]))
        print("  " + "  ".join("%s %.6f +- %.6f" % (c, *st[c]) for c in COLUMNS))
    if len(stats) < 3:
        raise SystemExit("give the run held and at least two reference logs")
    held = against_reference(stats[0], stats[1:], args.threshold)
    print("%s against the reference's centre:" % names[0])
    for c, v in held["columns"].items():
        print("  %-6s diff %+.6f  se %.6f  se_R %.6f  spread %.6f  z %.2f"
              % (c, v["diff"], v["se"], v["se_R"], v["spread"], v["z"]))
    print("  -> %s" % ("agree" if held["agree"] else "DISAGREE"))
    pairs = {}
    for i, j in itertools.combinations(range(len(stats)), 2):
        res = compare(stats[i], stats[j], args.threshold)
        key = "%s vs %s" % (names[i], names[j])
        pairs[key] = res
        print("%s: %s -> %s" % (key, "  ".join("z_%s %.2f" % kv for kv in res["z"].items()),
                                 "agree" if res["agree"] else "DISAGREE"))
    print(json.dumps({"tail": args.tail, "blocks": args.blocks, "threshold": args.threshold,
                      "runs": dict(zip(names, stats)), "held": held, "pairs": pairs}))


if __name__ == "__main__":
    main()
