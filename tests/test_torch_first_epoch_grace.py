"""The hang watchdog's first-interval grace covers the first epoch of
``main_torch.py`` (the kernel builds and first launches happen there).

``train`` runs with ``--hang_timeout`` 1 s and a watchdog whose exit is
recorded instead of taken, through two epochs that each take 2 s of a clock
the test moves (``tests/_watchdog_clock.py``), whatever their work takes on
the machine's own clock: the first runs under the 4x grace and must not
trigger, the second runs at the plain budget and must.  A heartbeat at the
top of the loop would spend the grace before the first epoch ran.
"""

import os

import main_torch
from _watchdog_clock import install
from coulombgas_tpu_torch.utils import watchdog
from coulombgas_tpu_torch.utils.watchdog import HANG_EXIT_CODE, StepWatchdog

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOW_S, TIMEOUT_S = 2.0, 1.0
SMALL = ["--cpu", "--hutchinson", "--n", "13", "--batch", "4", "--mc_therm", "1",
         "--mc_steps", "3", "--acc_steps", "1", "--epoch", "2", "--ckpt_every", "1000",
         "--hang_timeout", str(TIMEOUT_S),
         "--folder", os.path.join(ROOT, "data", "interacting") + os.sep]


def test_the_first_epoch_runs_under_the_grace(tmp_path, monkeypatch):
    clock = install(monkeypatch, watchdog)
    fired, epochs, made = [], [], []

    def make_watchdog(*args, **kw):
        made.append(StepWatchdog(*args, poll_s=0.05, **kw,
                                 exit_fn=lambda code: fired.append((code, list(epochs)))))
        return made[-1]

    monkeypatch.setattr(main_torch, "StepWatchdog", make_watchdog)
    apply_step = main_torch.apply_step

    def slow_apply(tr, acc, epoch, *rest):
        epochs.append(epoch)
        clock.advance(SLOW_S, made[0])
        return apply_step(tr, acc, epoch, *rest)

    monkeypatch.setattr(main_torch, "apply_step", slow_apply)
    run = main_torch.train(main_torch.parse_args(SMALL), out_folder=str(tmp_path))
    assert [r["epoch"] for r in run["epochs"]] == [1, 2]
    # nothing fired in epoch 1 (2 s against a 4 s grace); epoch 2 overran 1 s
    assert fired == [(HANG_EXIT_CODE, [1, 2])]
