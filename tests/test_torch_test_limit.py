"""The time limit of ``tests/_test_limit.py``, on a pytest run of its own.

A child pytest, with the plugin and its limit set to 2 s, runs a file whose
first test starts a process and sleeps past the limit.  That test fails with
the limit's message and the sleeping line in its stack, its fixture's
finalizer still runs, and the next test runs and finds the process gone.
Once in one process and once in an xdist worker, as a run with ``-n`` runs
its tests.
"""

import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))

CHILD = '''
import os
import subprocess
import sys
import time

import pytest

PIDFILE = os.path.join(os.path.dirname(__file__), "pid")


@pytest.fixture
def finalized():
    yield
    open(os.path.join(os.path.dirname(__file__), "finalized"), "w").close()


def test_sleeps_past_the_limit(finalized):
    p = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(600)"])
    with open(PIDFILE, "w") as f:
        f.write(str(p.pid))
    time.sleep(600)  # the line the stack shows


def test_the_next_test_runs_and_the_process_is_gone():
    pid = int(open(PIDFILE).read())
    assert not os.path.exists("/proc/%d" % pid)
'''


@pytest.mark.parametrize("workers", [[], ["-p", "xdist", "-n", "1"]], ids=["serial", "xdist"])
def test_a_test_past_the_limit_fails_alone_and_leaves_no_process(tmp_path, workers):
    (tmp_path / "conftest.py").write_text("import _test_limit\n_test_limit.LIMIT_S = 2.0\n")
    (tmp_path / "test_child.py").write_text(CHILD)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([HERE, os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-p", "_test_limit", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-q", *workers, "test_child.py"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120).stdout
    assert "1 failed, 1 passed" in out, out
    assert "test limit of 2 s exceeded (in call)" in out, out
    assert "--- thread MainThread ---" in out and "time.sleep(600)  # the line" in out, out
    assert (tmp_path / "finalized").exists()
    pid = int((tmp_path / "pid").read_text())
    assert not os.path.exists("/proc/%d" % pid)
