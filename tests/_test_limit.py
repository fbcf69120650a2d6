"""A time limit on every test, and no process of a test outliving it.

pytest-timeout is not installed, so this plugin builds the limit from the
standard library, in the main thread of the process that runs the tests (an
xdist worker runs them there):

* a ``SIGALRM`` timer fails the test once its setup, call and teardown have
  taken ``LIMIT_S`` seconds together (a module fixture counts in the first
  test that uses it).  The failure's message holds every thread's stack.
  The teardown of a test that ran out still gets ``GRACE_S`` to run its
  finalizers;
* ``faulthandler.dump_traceback_later`` is the backstop for a main thread
  held in C code, which never returns to run the alarm's handler: at the
  limit plus ``BACKSTOP_S`` it prints every thread's stack to the worker's
  stderr and ends the worker (xdist then reports the test as failed and
  starts a new worker).

When a test ends, every process it started is killed with ``SIGKILL``: the
children of this process that were not there before the test, with their
own children (a ``main.py`` child under ``--multihost`` ignores
``SIGTERM``).  Multiprocessing's resource tracker, which lives as long as the
process that started it, is left alone.

The plugin is loaded on request, with ``tests/`` on the path::

    PYTHONPATH=tests python -m pytest tests/test_torch_*.py -p _test_limit -n 6

``tests/conftest.py`` does not register it, so a run of the whole directory
has no limit, and the tests that start processes kill them themselves
(``_torch_cli_runs.launch``).  ``LIMIT_S`` is sized for the port's files;
the JAX package's files hold tests that run longer than it.
"""

import faulthandler
import os
import signal
import sys
import threading
import time
import traceback

import pytest

# about 3x the slowest of the port's tests on six xdist workers under load
# (test_torch_parallel_straddle.py's module fixture: 116-132 s with an empty
# compile cache); test_train.py::test_pretrain_converges_toward_oracle of the
# JAX package took 1255 s
LIMIT_S = 400.0
GRACE_S = 30.0
BACKSTOP_S = 2 * GRACE_S

_RUNNER_FILES = tuple(os.sep + d + os.sep for d in ("_pytest", "pluggy", "execnet", "xdist"))
_state = {"deadline": None, "armed": False, "phase": None, "stderr": None}


def pytest_configure(config):
    # pytest's capture is suspended while plugins configure: fd 2 is the
    # worker's own stderr here, where the backstop's stacks must go
    if _state["stderr"] is None:
        _state["stderr"] = os.dup(2)


def _stacks():
    """Every thread's stack, without the frames of pytest, its plugins and
    this file."""
    frames = sys._current_frames()
    out = []
    for t in threading.enumerate():
        if t.ident in frames:
            stack = [fs for fs in traceback.extract_stack(frames[t.ident])
                     if fs.filename != __file__
                     and not any(s in fs.filename for s in _RUNNER_FILES)]
            out.append("--- thread %s ---\n%s" % (t.name, "".join(traceback.format_list(stack))))
    return "\n".join(out)


def _on_alarm(signum, frame):
    if not _state["armed"]:
        return
    _state["armed"] = False
    pytest.fail("test limit of %g s exceeded (in %s); the stacks:\n%s"
                % (LIMIT_S, _state["phase"], _stacks()), pytrace=False)


def _arm(phase):
    if _state["deadline"] is None or threading.current_thread() is not threading.main_thread():
        return False
    _state["phase"] = phase
    _state["armed"] = True
    signal.signal(signal.SIGALRM, _on_alarm)
    left = _state["deadline"] - time.monotonic()
    signal.setitimer(signal.ITIMER_REAL, max(left, GRACE_S if phase == "teardown" else 0.001))
    return True


def _disarm():
    _state["armed"] = False
    signal.setitimer(signal.ITIMER_REAL, 0)


def _phase(phase):
    @pytest.hookimpl(wrapper=True, tryfirst=True)
    def wrapper(item):
        armed = _arm(phase)
        try:
            return (yield)
        finally:
            if armed:
                _disarm()
    return wrapper


pytest_runtest_setup = _phase("setup")
pytest_runtest_call = _phase("call")
pytest_runtest_teardown = _phase("teardown")


def _descendants(pid):
    """The pids of ``pid``'s children, their children and so on (``/proc``)."""
    children = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open("/proc/%s/stat" % entry) as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        children.setdefault(ppid, []).append(int(entry))
    out, todo = [], [pid]
    while todo:
        for child in children.get(todo.pop(), ()):
            out.append(child)
            todo.append(child)
    return out


def _resource_tracker_pid():
    mod = sys.modules.get("multiprocessing.resource_tracker")
    return getattr(getattr(mod, "_resource_tracker", None), "_pid", None)


def _kill_new_processes(before):
    """SIGKILL every descendant of this process not in ``before`` (but the
    resource tracker), and reap those that were its children."""
    new = [p for p in _descendants(os.getpid())
           if p not in before and p != _resource_tracker_pid()]
    for pid in new:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    for pid in new:
        try:
            os.waitpid(pid, 0)
        except ChildProcessError:  # a grandchild, or reaped by its Popen
            pass
    return new


@pytest.hookimpl(wrapper=True, tryfirst=True)
def pytest_runtest_protocol(item, nextitem):
    before = set(_descendants(os.getpid()))
    _state["deadline"] = time.monotonic() + LIMIT_S
    faulthandler.dump_traceback_later(LIMIT_S + BACKSTOP_S, exit=True, file=_state["stderr"])
    try:
        return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()
        _state["deadline"] = None
        killed = _kill_new_processes(before)
        if killed:
            os.write(_state["stderr"], b"%s left processes %s running; killed them\n"
                     % (item.nodeid.encode(), str(killed).encode()))
