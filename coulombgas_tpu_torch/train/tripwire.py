"""Update tripwire: detect-and-revert for rare catastrophic optimizer steps.

The port's own copy of ``coulombgas_tpu/train/tripwire.py`` (pure Python, so
the decisions are the same to the bit; ``tests/test_torch_tripwire.py``
replays both on the same traces).  What it guards against, from the
forensics of the JAX runs recorded in that module and in PARITY.md:

1. a single garbage SR update, visible in the NEXT epoch's observables as an
   upward free-energy jump many standard errors wide: revert to the BEST
   healthy epoch seen, also on a gradual runaway above it;
2. the epoch-to-epoch scatter of F under SR exceeds the Monte-Carlo error
   near the plateau: the threshold is ``sigma * max(stderr, scatter)`` with a
   self-tuning upper-quartile scatter floor;
3. bursts of events: never disarm; halve ``trust_scale`` (the training loop
   multiplies the SR trust radius ``max_norm`` by it) and relax it after a
   quiet window;
4. a bad step also poisons the Markov chains, so the training loop snapshots and
   restores the walkers and the generator state with the parameters;
5. poisoned epochs have an exploded standard error or a collapsed accept
   rate, which trip on their own;
6. an entropy leak at flat F, invisible to every F-based detector, raises
   ``drift_events`` (an alarm, with nothing to revert to).

The observables logged at epoch ``i`` describe the parameters produced by
the apply step of epoch ``i-1``, i.e. the parameters ENTERING epoch ``i`` —
exactly the state passed to ``snapshot`` at the top of epoch ``i``.
``sigma <= 0`` switches the tripwire off.
"""

from __future__ import annotations

import math
from collections import deque

__all__ = ["UpdateTripwire"]


def _median(xs):
    s = sorted(xs)
    return s[len(s) // 2]


def _q75(xs):
    """Upper-quartile scatter estimate: robust to the occasional un-reverted
    outlier, and biased UPWARD relative to the median — the sample median of
    ~16 half-normal |dF| draws scatters low enough to cause noise fires."""
    s = sorted(xs)
    return s[int(0.75 * (len(s) - 1))]


class UpdateTripwire:
    """Decides whether to revert after each epoch's observables arrive.

    Usage per epoch::

        tripwire.snapshot(params_state)            # BEFORE sampling/apply
        ... sample, accumulate, apply ...          # trust radius scaled by
        ...                                        #   tripwire.trust_scale
        revert_to = tripwire.check(F_raw, F_stderr, all_finite)
        if revert_to is not None:
            params_state = revert_to
    """

    def __init__(self, sigma: float = 15.0, cooldown: int = 3,
                 burst_events: int = 4, window: int = 80,
                 scatter_window: int = 16, min_trust_scale: float = 1 / 16,
                 sig_explode: float = 15.0, accept_collapse: float = 0.5,
                 drift_window: int = 600, drift_rel: float = 0.07):
        self.sigma = sigma
        self.cooldown_epochs = cooldown
        self.burst_events = burst_events
        self.window = window  # also the max age of the best-epoch anchor
        self.min_trust_scale = min_trust_scale
        self.sig_explode = sig_explode  # F_stderr > this x healthy median -> trip
        self.accept_collapse = accept_collapse  # accept < this x healthy median -> trip
        self.drift_rel = drift_rel  # entropy-drift margin, relative to plateau S
        self._hist = deque(maxlen=2)  # snapshots of the opaque params state
        self._prev = None  # (F, stderr) of the last healthy epoch
        self._best = None  # (F, stderr, state, epoch) of the best healthy epoch
        self._recent = None  # most recent healthy (F, stderr, state, epoch)
        self._deltas = deque(maxlen=scatter_window)  # |ΔF| between healthy epochs
        self._sig_hist = deque(maxlen=32)   # healthy F_stderr history
        self._acc_hist = deque(maxlen=32)   # healthy accept-rate history
        self._fs_hist = deque(maxlen=drift_window)  # healthy (F, S) history
        self._cooldown = 0
        self._drift_cooldown = 0
        self._epoch = 0
        self.events = []  # epochs at which a revert fired
        self.drift_events = []  # epochs at which the entropy-drift alarm fired
        self.last_reason = None  # human-readable cause of the latest trip
        self._last_event = 0
        self.trust_scale = 1.0  # loop multiplies max_norm by this
        self.disabled = sigma <= 0

    def _thresh(self, stderr_combined: float) -> float:
        """sigma * max(MC error, observed epoch-to-epoch scatter)."""
        scatter = _q75(self._deltas) if len(self._deltas) >= 6 else 0.0
        return self.sigma * max(stderr_combined, scatter)

    def snapshot(self, state) -> None:
        """Record the parameter state entering this epoch."""
        self._hist.append(state)

    def _check_drift(self) -> None:
        """Entropy-drift alarm (failure mode 6): a sustained S descent below
        an established (F-flat, S-flat) plateau at non-improving F.

        The hard part is NOT firing on healthy physics: during equilibration
        S legitimately descends for hundreds of epochs at nearly flat F (the
        healthy rs=10 run descends 4.9 -> 4.1 over epochs 600-1300 at the
        SAME rate as the pathological leak).  The discriminator is the
        plateau precondition — the alarm only arms once the trailing history
        contains a window that is flat in BOTH F and S (converged), and
        fires only when the recent mean S has fallen a margin below that
        plateau while F has not improved.  Tuned against the real traces in
        tests/test_tripwire_v2.py (healthy n=29 runs and the n=57 flagship
        must stay silent; the quarantined chol extension must fire).
        """
        if self._drift_cooldown > 0:
            self._drift_cooldown -= 1
            return
        if len(self._fs_hist) < self._fs_hist.maxlen:
            return
        rows = list(self._fs_hist)
        plat, rec = rows[100:500], rows[-50:]
        n_p, n_r = len(plat), len(rec)
        Fp = sum(r[0] for r in plat) / n_p
        Sp = sum(r[1] for r in plat) / n_p
        Fr = sum(r[0] for r in rec) / n_r
        Sr = sum(r[1] for r in rec) / n_r
        sigF = (sum((r[0] - Fp) ** 2 for r in plat) / n_p) ** 0.5
        sigS = (sum((r[1] - Sp) ** 2 for r in plat) / n_p) ** 0.5
        sem = (1.0 / n_p) ** 0.5 + (1.0 / n_r) ** 0.5
        margin = max(self.drift_rel * abs(Sp), 5.0 * sigS * sem)
        # plateau precondition: S flat across the plateau window itself
        S1 = sum(r[1] for r in plat[: n_p // 2]) / (n_p // 2)
        S2 = sum(r[1] for r in plat[n_p // 2:]) / (n_p - n_p // 2)
        if abs(S2 - S1) >= 0.5 * margin:
            return
        f_tol = 3.0 * sigF * sem
        if Fr >= Fp - f_tol and Sr < Sp - margin:
            self.drift_events.append(self._epoch)
            self._drift_cooldown = 400

    def check(self, F: float, F_stderr: float, finite: bool,
              accept: float | None = None, S: float | None = None):
        """Return the state to revert to, or None to keep going.

        ``F``/``F_stderr``: this epoch's free-energy estimate (any consistent
        units); ``finite``: whether ALL observables were finite.  ``accept``
        (MCMC acceptance rate) and ``S`` (entropy) are optional: they arm the
        walker-poisoning and entropy-drift detectors (failure modes 4-6 in
        the module docstring).
        """
        self._epoch += 1
        if self.disabled:
            return None
        # the state that PRODUCED this epoch's observables
        state = self._hist[-1] if self._hist else None

        # A poisoned Markov chain cannot produce healthy statistics even if F
        # itself looks plausible: an exploded standard error or a collapsed
        # acceptance rate is a trip condition in its own right (failure mode
        # 5).  Both arm from in-run healthy history, never absolute values.
        med_sig = _median(self._sig_hist) if len(self._sig_hist) >= 16 else None
        garbage = False
        self.last_reason = None  # set on every trip for the training loop's log line
        if finite and self._cooldown <= 0 and med_sig is not None and med_sig > 0:
            if F_stderr > self.sig_explode * med_sig:
                garbage = True
                self.last_reason = "exploded F stderr (poisoned chains)"
        if (not garbage and accept is not None and self._cooldown <= 0
                and len(self._acc_hist) >= 16):
            if accept < self.accept_collapse * _median(self._acc_hist):
                garbage = True
                self.last_reason = "collapsed MCMC acceptance (poisoned chains)"

        jump = False
        # Jump detection arms only once the epoch-to-epoch noise estimate
        # exists (>= 6 healthy deltas): before that the stderr-only threshold
        # cannot separate ordinary SR fluctuation from a bad step.  Non-finite
        # observables revert unconditionally below.
        if finite and self._cooldown <= 0 and len(self._deltas) >= 6:
            # cap the stderr entering the threshold at 3x the healthy median:
            # a garbage epoch's exploded stderr must not raise its own bar
            sig_eff = min(F_stderr, 3.0 * med_sig) if med_sig else F_stderr
            if self._prev is not None:
                F_prev, sig_prev = self._prev
                if med_sig:
                    sig_prev = min(sig_prev, 3.0 * med_sig)
                thresh = self._thresh(sig_eff + sig_prev)
                jump = math.isfinite(thresh) and (F - F_prev) > thresh
            if not jump and self._best is not None:
                # runaway guard: cumulative ascent above the best healthy
                # epoch, even if each individual step stayed under threshold.
                # The anchor is a running MINIMUM, which sits ~2 scatter units
                # below the running mean under pure noise — widen the band by
                # 2x so ordinary fluctuations measured from the min don't fire.
                F_best, sig_best, _, _ = self._best
                if med_sig:
                    sig_best = min(sig_best, 3.0 * med_sig)
                thresh = 2.0 * self._thresh(sig_eff + sig_best)
                jump = math.isfinite(thresh) and (F - F_best) > thresh

        if not finite or jump or garbage:
            if self.last_reason is None:
                self.last_reason = ("upward F jump" if finite
                                    else "non-finite observables")
            target = None
            if self._best is not None:
                target = self._best[2]
            elif len(self._hist) == 2:
                target = self._hist[0]
            if target is not None:
                self._hist.clear()
                self._prev = None
                self._cooldown = self.cooldown_epochs
                self.events.append(self._epoch)
                self._last_event = self._epoch
                if (len(self.events) >= self.burst_events
                        and self.events[-self.burst_events]
                        > self._epoch - self.window):
                    # persistent instability, not a rare bad step: shrink the
                    # trust region at the source and keep guarding
                    self.trust_scale = max(self.min_trust_scale,
                                           self.trust_scale * 0.5)
                    self.events.clear()
                return target

        if finite:
            if self._prev is not None and self._cooldown <= 0:
                d = abs(F - self._prev[0])
                if math.isfinite(d):
                    self._deltas.append(d)
            if self._cooldown <= 0:
                if math.isfinite(F_stderr):
                    self._sig_hist.append(F_stderr)
                if accept is not None and math.isfinite(accept):
                    self._acc_hist.append(accept)
                if S is not None and math.isfinite(S):
                    self._fs_hist.append((F, S))
                    self._check_drift()
            if (self.trust_scale < 1.0
                    and self._epoch - self._last_event > self.window
                    and self._epoch % self.window == 0):
                # a full window without events: relax the trust region back
                self.trust_scale = min(1.0, self.trust_scale * 2.0)
            self._prev = (F, F_stderr)
            if self._cooldown <= 0 and state is not None:
                rec = (F, F_stderr, state, self._epoch)
                self._recent = rec
                if self._best is None or F <= self._best[0]:
                    self._best = rec
                elif (self._epoch - self._best[3] > self.window
                      and self._recent is not None):
                    # the anchor has gone stale (e.g. an early lucky-noise
                    # minimum in a long plateau): re-anchor to the present
                    self._best = self._recent
        self._cooldown = max(0, self._cooldown - 1)
        return None
