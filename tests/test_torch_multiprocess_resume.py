"""Process groups and resumes of ``main_torch.py`` on the CPU (gloo), in
``tests/_torch_cli_runs.py``'s configuration:

  * a run inside a gloo group of world size 1
    (``--multihost --coordinator ... --num_processes 1 --process_id 0``) is
    bit for bit the run without a group: the same ``data.txt`` rows, the
    same checksum;
  * a one-process checkpoint resumes with two ranks (the global walkers cut
    in halves, each rank's stream seeded anew from (seed, epoch, rank), said
    in a line), and a two-rank checkpoint resumes with one process;
  * a two-rank checkpoint resumed with two ranks continues exactly: each
    rank takes back its own stream, and the epoch after the checkpoint
    equals the uninterrupted run's, row and checksum.
"""

import shutil

import numpy as np
import pytest

import _torch_cli_runs as cr

RESEED = "generator streams do not fit"


def _rows(run_dir):
    return (run_dir / "data.txt").read_text().splitlines()


def _only_run_dir(folder, world):
    dirs = [d for d in cr.run_dirs(folder) if "_ndevices_%d_" % world in d.name]
    assert len(dirs) == 1, dirs
    return dirs[0]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    one = tmp_path_factory.mktemp("one")
    out["alone"] = cr.launch(one, ["--ckpt_every", "1"])
    world1 = tmp_path_factory.mktemp("world1")
    out["world1"] = cr.launch(world1, ["--ckpt_every", "1", *cr.coordinator(1)], ranks=(0,))
    out["world1_dir"] = _only_run_dir(world1, 1)
    # the one-process checkpoint of epoch 2, resumed by two ranks to epoch 4
    alone_dir = _only_run_dir(one, 1)
    two_dir = alone_dir.parent / alone_dir.name.replace("_ndevices_1_", "_ndevices_2_")
    two_dir.mkdir()
    shutil.copy(alone_dir / "epoch_000002.pkl", two_dir)
    resume = ["--ckpt_every", "1", "--epoch_finished", "2", "--epoch", "4"]
    out["two"] = cr.launch(one, [*resume, *cr.coordinator(2)], ranks=(0, 1))
    # two ranks again from that run's epoch-3 checkpoint, in a copy
    again = tmp_path_factory.mktemp("again")
    shutil.copytree(one / "freefermion", again / "freefermion")
    again_dir = again / two_dir.name
    again_dir.mkdir()
    shutil.copy(two_dir / "epoch_000003.pkl", again_dir)
    out["again"] = cr.launch(again, ["--epoch_finished", "3", "--epoch", "4",
                                     *cr.coordinator(2)], ranks=(0, 1))
    out["again_dir"], out["two_dir"], out["alone_dir"] = again_dir, two_dir, alone_dir
    # the two-rank checkpoint of epoch 4, resumed by one process to epoch 5
    shutil.copy(two_dir / "epoch_000004.pkl", alone_dir)
    out["back"] = cr.launch(one, ["--epoch_finished", "4", "--epoch", "5"])
    return out


def test_a_world_of_one_has_the_checksum_of_the_run_without_a_group(runs):
    assert "rank 0 of 1 (gloo)" in runs["world1"][0]
    assert "rank 0 of" not in runs["alone"][0]
    assert cr.checksums(runs["world1"]) == cr.checksums(runs["alone"])


def test_a_world_of_one_writes_the_rows_of_the_run_without_a_group(runs):
    assert _rows(runs["world1_dir"]) == _rows(runs["alone_dir"])[:2]


def test_a_one_process_checkpoint_resumes_with_two_ranks(runs):
    outs = runs["two"]
    assert all(RESEED in out and "epoch 2" in out for out in outs)
    data = np.loadtxt(runs["two_dir"] / "data.txt", ndmin=2)
    assert list(data[:, 0]) == [3, 4] and np.isfinite(data).all()


def test_two_ranks_resumed_from_one_process_end_equal(runs):
    sums = cr.checksums(runs["two"])
    assert len(sums) == 2 and sums[0] == sums[1]


def test_two_ranks_take_back_their_own_streams(runs):
    assert not any(RESEED in out for out in runs["again"])
    assert _rows(runs["again_dir"]) == _rows(runs["two_dir"])[1:]


def test_a_two_rank_checkpoint_resumed_by_two_ranks_continues_exactly(runs):
    assert cr.checksums(runs["again"]) == cr.checksums(runs["two"])


def test_a_two_rank_checkpoint_resumes_with_one_process(runs):
    out = runs["back"][0]
    assert RESEED in out and "epoch 4" in out
    rows = _rows(runs["alone_dir"])
    assert [int(r.split()[0]) for r in rows] == [1, 2, 5]
    assert np.isfinite(np.array(rows[-1].split(), float)).all()
