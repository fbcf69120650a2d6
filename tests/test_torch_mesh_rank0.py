"""What the port's data parallelism takes from rank 0 (CPU, gloo, two ranks).

``mesh.wait_for_rank0`` holds the other ranks while rank 0 alone works (the
free-fermion pretraining), for longer than any collective's ``TIMEOUT``;
``mesh.replicate_update`` gives every rank rank 0's SR update and
diagnostics, of the kinds each rank had.
"""

import os
import pickle
import time

import pytest
import torch

import main_torch
from coulombgas_tpu_torch.parallel import mesh

JOIN_TIMEOUT_S = 60
SHORT_TIMEOUT_S = 2.0
RANK0_WORK_S = 2.5 * SHORT_TIMEOUT_S


def _rank(rank, world, port, out):
    torch.set_num_threads(1)
    mesh.TIMEOUT = mesh.datetime.timedelta(seconds=SHORT_TIMEOUT_S)
    mesh.make_mesh("tcp://localhost:%d" % port, rank, world, "cpu")
    try:
        t0 = time.time()
        if rank == 0:
            # the work starts once rank 1 waits, so that rank 1 waits for all
            # of it however late the machine let it start
            while not os.path.exists(out + ".waiting"):
                time.sleep(0.05)
            time.sleep(RANK0_WORK_S)
        else:
            open(out + ".waiting", "w").close()
            mesh.wait_for_rank0("work", poll=0.1)
        mesh.release("work")
        waited = time.time() - t0
        mesh.barrier()
        upd_van = torch.full((3,), float(rank), dtype=torch.float64)
        upd_flow = torch.full((2, 2), 10.0 + rank, dtype=torch.float32)
        d = {"F_mean": 1.0 + rank}
        diag = {"gnorm_van": torch.tensor(0.5 + rank, dtype=torch.float32)}
        d, diag = mesh.replicate_update(upd_van, upd_flow, d, diag)
    finally:
        mesh.destroy()
    with open("%s.rank%d" % (out, rank), "wb") as f:
        pickle.dump({"waited": waited, "upd_van": upd_van, "upd_flow": upd_flow,
                     "d": d, "diag": diag}, f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import torch.multiprocessing as mp

    out = os.path.join(str(tmp_path_factory.mktemp("rank0")), "res")
    ctx = mp.start_processes(_rank, args=(2, main_torch.free_port(), out), nprocs=2,
                             join=False, start_method="spawn")
    deadline = time.time() + JOIN_TIMEOUT_S
    while not ctx.join(timeout=max(deadline - time.time(), 0.1)):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError("ranks did not finish in %d s" % JOIN_TIMEOUT_S)
    res = []
    for r in range(2):
        with open("%s.rank%d" % (out, r), "rb") as f:
            res.append(pickle.load(f))
    return res


def test_the_wait_for_rank0_outlasts_the_collective_timeout(ranks):
    assert ranks[1]["waited"] > SHORT_TIMEOUT_S


@pytest.mark.parametrize("key", ["upd_van", "upd_flow"])
def test_replicate_update_copies_rank0s_update(ranks, key):
    assert torch.equal(ranks[1][key], ranks[0][key])
    assert ranks[1][key].dtype == ranks[0][key].dtype
    assert float(ranks[0][key].flatten()[0]) == (0.0 if key == "upd_van" else 10.0)


def test_replicate_update_keeps_the_kinds_of_the_stats(ranks):
    for r in ranks:
        assert r["d"] == {"F_mean": 1.0}
        assert set(r["diag"]) == {"gnorm_van"}
        got = r["diag"]["gnorm_van"]
        assert torch.is_tensor(got) and got.dtype == torch.float32 and float(got) == 0.5


def test_without_a_group_replicate_update_is_the_identity():
    upd = torch.ones(2)
    d = {"F_mean": 3.0}
    assert mesh.replicate_update(upd, upd, d) == (d,)
    mesh.wait_for_rank0("nothing")
    mesh.release("nothing")
