"""Shared set-up of the CPU tests that run ``main_torch.py`` in several
processes (gloo): ``tests/test_torch_multiprocess.py``,
``tests/test_torch_multiprocess_coordinator.py``,
``tests/test_torch_multiprocess_resume.py`` and
``tests/test_torch_cluster_env.py``.

The n = 3 configuration of ``tests/test_multihost.py`` with the SR Hutchinson
flags, its widths cut for the CPU.
"""

import os
import subprocess
import sys

import numpy as np

from coulombgas_tpu_torch.io.checkpoint import load_data
from main_torch import free_port

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TIMEOUT_S = 240
CONFIG = ["--cpu", "--n", "3", "--dim", "2", "--rs", "10.0", "--Theta", "0.15", "--Emax", "4",
          "--batch", "16", "--acc_steps", "2", "--epoch", "2", "--mc_therm", "1",
          "--mc_steps", "4", "--pre_epoch", "2", "--pre_batch", "32", "--sr", "--hutchinson",
          "--ckpt_every", "2", "--nlayers", "1", "--modelsize", "8", "--nheads", "2",
          "--nhidden", "12", "--spsize", "8", "--tpsize", "8"]
SOLVERS = {"plain": [], "host64": ["--sr_solver", "host64"]}


def coordinator(world):
    """The flags of ``--multihost --coordinator`` for ``world`` processes."""
    return ["--multihost", "--coordinator", "localhost:%d" % free_port(),
            "--num_processes", str(world)]


def launch(folder, extra=(), ranks=(None,), envs=None):
    """Run ``main_torch.py`` once per entry of ``ranks`` (None: no
    --process_id), all at once, process i with ``envs[i]`` added to its
    environment where given; returns their outputs, failing on a non-zero
    exit of any.  Every wait has a timeout."""
    cmd = [sys.executable, os.path.join(REPO, "main_torch.py"), *CONFIG,
           "--folder", str(folder) + os.sep, *extra]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(cmd + ([] if r is None else ["--process_id", str(r)]),
                              cwd=REPO, env=dict(env, **(envs[i] if envs else {})),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i, r in enumerate(ranks)]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, "process %d failed:\n%s" % (r, out[-4000:])
    return outs


def checksums(outs):
    return [line.split()[-1] for out in outs for line in out.splitlines()
            if line.startswith("final params checksum:")]


def run_dirs(folder):
    return [d for d in folder.iterdir() if d.is_dir() and d.name.startswith("n_3_")]


def check_run_directory(run):
    dirs = run_dirs(run["folder"])
    assert len(dirs) == 1 and "_batch_16_ndevices_2_accsteps_2" in dirs[0].name


def check_data_txt(run):
    data = np.loadtxt(run_dirs(run["folder"])[0] / "data.txt", ndmin=2)
    assert data.shape == (2, 12) and np.isfinite(data).all()
    assert list(data[:, 0]) == [1, 2]
    diag = np.loadtxt(run_dirs(run["folder"])[0] / "sr_diag.txt", ndmin=2)
    assert diag.shape == (2, 5) and ((diag[:, 2] > 0) & (diag[:, 2] <= 1)).all()


def check_checkpoint(run):
    ckpt = load_data(run_dirs(run["folder"])[0] / "epoch_000002.pkl")
    assert ckpt["x"].shape == (16, 3, 2) and np.isfinite(ckpt["x"]).all()
    assert len(ckpt["torch_generators"]) == 2
    assert not np.array_equal(ckpt["torch_generators"][0], ckpt["torch_generators"][1])
    np.testing.assert_array_equal(ckpt["torch_generator"], ckpt["torch_generators"][0])
    # the two halves are the two ranks' walkers: no half repeats the other
    assert not np.array_equal(ckpt["x"][:8], ckpt["x"][8:])


def check_checksums(run):
    sums = checksums(run["outs"])
    assert len(sums) == 2 and sums[0] == sums[1]


def check_pretrained_once(run):
    text = "\n".join(run["outs"])
    assert text.count("No pretrained model found; running free-fermion pretraining") == 1
    assert text.count("Pretrained free-fermion model: rank 0's") == 1
    assert text.count("rank 1 of 2 (gloo)") == 1
    pre = list(run["folder"].glob("freefermion/pretraining/*/*/params_van.pkl"))
    assert len(pre) == 1
