"""A clock that the test moves, for the step watchdogs of both packages.

``install(monkeypatch, module)`` gives a watchdog module a ``time`` whose
``monotonic()`` moves only when the test calls ``advance``, so what a
watchdog decides depends on the seconds the test says have passed and not
on how fast a loaded machine runs.
"""

import threading
import time
import types


class Clock:
    def __init__(self):
        self.now = 0.0
        self._reads = {}
        self._cond = threading.Condition()

    def monotonic(self):
        with self._cond:
            me = threading.current_thread()
            self._reads[me] = self._reads.get(me, 0) + 1
            self._cond.notify_all()
            return self.now

    def advance(self, seconds, watchdog, timeout=60.0):
        """Move the clock on by ``seconds`` and return once ``watchdog``'s
        thread has checked the new time: it read the clock and then read it
        again or ended."""
        thread = watchdog._thread
        deadline = time.monotonic() + timeout
        with self._cond:
            self.now += seconds
            seen = self._reads.get(thread, 0)
            while self._reads.get(thread, 0) < seen + 2 and thread.is_alive():
                if time.monotonic() > deadline:
                    raise TimeoutError("the watchdog's thread did not look at the clock")
                self._cond.wait(0.01)


def install(monkeypatch, module):
    clock = Clock()
    monkeypatch.setattr(module, "time", types.SimpleNamespace(monotonic=clock.monotonic))
    return clock
