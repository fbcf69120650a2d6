"""``main_torch.py --cpu --num_devices 2``: one command, two spawned ranks
in a gloo group; the port's counterpart of ``tests/test_multihost.py``.

Under the ``plain`` and the ``host64`` solver (``tests/_torch_cli_runs.py``'s
configuration): the free-fermion pretraining runs once (rank 0), one run
directory named ``ndevices_2`` holds one ``data.txt`` row per epoch and a
checkpoint with the global walkers and both ranks' generator states, and the
two ranks end with equal parameter checksums.
"""

import pytest

import _torch_cli_runs as cr


@pytest.fixture(scope="module", params=["plain", "host64"])
def run(request, tmp_path_factory):
    folder = tmp_path_factory.mktemp("num_devices_" + request.param)
    outs = cr.launch(folder, ["--num_devices", "2", *cr.SOLVERS[request.param]])
    return {"folder": folder, "outs": outs}


def test_one_run_directory_named_ndevices_2(run):
    cr.check_run_directory(run)


def test_data_txt_has_one_row_per_epoch(run):
    cr.check_data_txt(run)


def test_checkpoint_holds_the_global_walkers(run):
    cr.check_checkpoint(run)


def test_checksums_are_equal_across_ranks(run):
    cr.check_checksums(run)


def test_rank_0_pretrained_once_and_sent_the_van(run):
    cr.check_pretrained_once(run)
