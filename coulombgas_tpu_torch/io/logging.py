"""Observable logging in the reference's line-buffered text protocol.

``data.txt`` per run directory; training columns:
    iter F F_std E E_std K K_std V V_std S S_std accept_rate
pretraining columns:
    iter F F_std E E_std S S_std
F/E/K/V in Ry/rs^2, S dimensionless; error bars are
sqrt((<O^2> - <O>^2) / total_batch).  The byte format is the same as
``coulombgas_tpu/io/logging.py`` writes, so one analysis reads either log.

Epochs reverted by the update tripwire (``train/tripwire.py``) are not
written — their record goes to ``sr_diag.txt`` — so the epoch column is
monotone but may have gaps: key on the epoch value, never on the row count.
"""

from __future__ import annotations

import math
import os

__all__ = ["ObservableLog", "stderr_from_moments"]


def stderr_from_moments(mean, sq_mean, total_batch):
    """Monte-Carlo standard error from first/second moments."""
    var = sq_mean - mean**2
    return math.sqrt(max(var, 0.0) / total_batch)


class ObservableLog:
    """Line-buffered data.txt writer (values mirrored to stdout)."""

    def __init__(self, path: str, resume: bool = False, filename: str = "data.txt"):
        # Open mode "a" when resuming from a checkpoint.  A fresh run into an
        # existing directory must not concatenate two runs' epoch rows, but
        # instead of truncating, the old log is moved aside to
        # ``data.txt.bak<N>``.
        os.makedirs(path, exist_ok=True)
        self.filename = os.path.join(path, filename)
        if not resume and os.path.exists(self.filename) and os.path.getsize(self.filename) > 0:
            k = 1
            while os.path.exists("%s.bak%d" % (self.filename, k)):
                k += 1
            os.replace(self.filename, "%s.bak%d" % (self.filename, k))
        self.f = open(self.filename, "a", buffering=1, newline="\n")

    def write_train(self, i, F, F_std, E, E_std, K, K_std, V, V_std, S, S_std, accept_rate):
        print(
            "iter: %04d" % i,
            "F:", F, "F_std:", F_std,
            "E:", E, "E_std:", E_std,
            "K:", K, "K_std:", K_std,
            "V:", V, "V_std:", V_std,
            "S:", S, "S_std:", S_std,
            "accept_rate:", accept_rate,
        )
        self.f.write(
            ("%6d" + "  %.6f" * 10 + "  %.4f" + "\n")
            % (i, F, F_std, E, E_std, K, K_std, V, V_std, S, S_std, accept_rate)
        )

    def write_pretrain(self, i, F, F_std, E, E_std, S, S_std):
        print(
            "iter: %04d" % i,
            "F:", F, "F_std:", F_std,
            "E:", E, "E_std:", E_std,
            "S:", S, "S_std:", S_std,
        )
        self.f.write(("%6d" + "  %.6f" * 6 + "\n") % (i, F, F_std, E, E_std, S, S_std))

    def close(self):
        self.f.close()
