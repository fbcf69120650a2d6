"""Step-heartbeat watchdog: fail fast when the device stops answering.

The port's copy of ``coulombgas_tpu/utils/watchdog.py``.  A wedged device
call raises no exception, so the update tripwire (``train/tripwire.py``),
which runs between epochs on values it can only read once the device
returns, never gets control, and a hung trainer holds its card until the
process dies.  The watchdog turns that unbounded hang into a bounded,
resumable failure: a daemon thread checks a heartbeat that the training loop
beats once per epoch, after the previous epoch's ``torch.cuda.synchronize``,
and hard-exits the process with ``HANG_EXIT_CODE`` once the silent gap
exceeds the timeout.  ``os._exit`` (not ``sys.exit``) is deliberate: the
main thread is parked inside the CUDA runtime and will never unwind, so
raising in a daemon thread cannot end anything; the forensic line written
here is all that can usefully be flushed.  A checkpoint-resume wrapper that
retries on that exit code gives crash-only recovery.

The first heartbeat interval gets a grace multiplier: the first epoch after
a (re)start builds the CUDA kernels and warms the allocator, which a plain
timeout would turn into a crash loop.
"""

import os
import sys
import threading
import time

__all__ = ["StepWatchdog", "HANG_EXIT_CODE"]

# Reserved exit code wrappers test for "device hang, resume me".
HANG_EXIT_CODE = 42


class StepWatchdog:
    """Hard-exit the process if ``beat()`` goes silent for ``timeout_s``.

    Parameters
    ----------
    timeout_s: silent-gap budget between heartbeats, in seconds.  <= 0
        disables the watchdog entirely (``start`` becomes a no-op).
    context: short string naming the run, included in the forensic line.
    first_grace: multiplier on ``timeout_s`` for the FIRST interval only
        (kernel builds; see module docstring).
    poll_s: how often the daemon thread wakes to check the gap.
    exit_fn: called with HANG_EXIT_CODE on trigger; ``os._exit`` in
        production, injectable for tests.
    """

    def __init__(self, timeout_s, context="", first_grace=4.0, poll_s=5.0,
                 exit_fn=os._exit):
        self.timeout_s = float(timeout_s)
        self.context = context
        self.first_grace = float(first_grace)
        self.poll_s = float(poll_s)
        self.exit_fn = exit_fn
        self._last = None          # monotonic time of the newest beat
        self._deadline_mult = None  # first_grace until the first beat lands
        self._stop = threading.Event()
        self._thread = None

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        if self.timeout_s <= 0 or self._thread is not None:
            return self
        self._last = time.monotonic()
        self._deadline_mult = self.first_grace
        self._thread = threading.Thread(
            target=self._watch, name="step-watchdog", daemon=True)
        self._thread.start()
        return self

    def beat(self):
        """Mark liveness; called once per epoch by the training loop."""
        self._last = time.monotonic()
        self._deadline_mult = 1.0

    def stop(self):
        self._stop.set()

    # -- the daemon --------------------------------------------------------
    def _watch(self):
        while not self._stop.wait(self.poll_s):
            last, mult = self._last, self._deadline_mult
            gap = time.monotonic() - last
            budget = self.timeout_s * mult
            if gap > budget:
                msg = (
                    "WATCHDOG: no epoch heartbeat for %.0f s (budget %.0f s)"
                    " — device presumed wedged%s; exiting %d so the"
                    " checkpoint-resume wrapper can relaunch\n"
                    % (gap, budget,
                       " [%s]" % self.context if self.context else "",
                       HANG_EXIT_CODE))
                try:
                    sys.stderr.write(msg)
                    sys.stderr.flush()
                except Exception:
                    pass
                self.exit_fn(HANG_EXIT_CODE)
                return  # only reached with an injected exit_fn (tests)
