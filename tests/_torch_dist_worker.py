"""Ranks of the port's CPU data-parallel tests.

``run(world, job, tmp)`` starts ``world`` processes (spawn) that join a gloo
process group on a free port of this host; each runs ``step`` for every case
of ``job`` on its contiguous share of the global batch and pickles what it
computed.  ``step`` with no process group is the one-process run of the same
case.  This module imports torch and the port only, so that a rank does not
pay for JAX.
"""

import os
import pickle
import sys
import time

import torch

import main_torch
from coulombgas_tpu_torch.io.checkpoint import to_host
from coulombgas_tpu_torch.io.convert import (
    flow_from_numpy, flow_to_numpy, van_from_numpy, van_to_numpy,
)
from coulombgas_tpu_torch.parallel import mesh
from coulombgas_tpu_torch.train.train import init_accumulators, reduce_accumulators

JOIN_TIMEOUT_S = 120


def step(argv, trees, x, si, v, out_folder):
    """One accumulate and apply of ``main_torch.py`` with ``argv`` on this
    rank's share of the global ``x``, ``si`` and Hutchinson probe ``v``,
    the models holding ``trees`` (numpy pytrees of both packages' layout)."""
    args = main_torch.parse_args(argv)
    tr = main_torch.build_trainer(args, out_folder)
    van_from_numpy(trees[0], tr.van)
    flow_from_numpy(trees[1], tr.flow)
    x, si, v = (torch.from_numpy(mesh.shard_batch(a).copy()) for a in (x, si, v))
    acc = init_accumulators(tr.van, tr.flow, sr=args.sr)
    acc = tr.accumulate(tr.van, tr.flow, si.long(), x, None, acc, v=v)
    acc, _ = reduce_accumulators(acc)
    reduced = to_host(acc)
    d, diag = main_torch.apply_step(tr, acc, 1, {})
    return {"d": d, "diag": diag, "acc": reduced,
            "van": van_to_numpy(tr.van), "flow": flow_to_numpy(tr.flow)}


def _rank(rank, world, port, job_path):
    torch.set_num_threads(1)
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    mesh.make_mesh("tcp://localhost:%d" % port, rank, world, "cpu")
    try:
        out = [step(c["argv"], job["trees"], job["x"], job["si"], c["v"], job["out"])
               for c in job["cases"]]
    finally:
        mesh.destroy()
    # what this rank imported of JAX or the JAX package (nothing, we hold)
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "coulombgas_tpu"))
    for res in out:
        res["modules"] = foreign
    with open("%s.rank%d" % (job_path, rank), "wb") as f:
        pickle.dump(out, f)


def run(world, job, tmp) -> list:
    """Every rank's results, in rank order (a list of per-case dicts each)."""
    import torch.multiprocessing as mp

    os.makedirs(str(tmp), exist_ok=True)
    job_path = os.path.join(str(tmp), "job_%d.pkl" % world)
    with open(job_path, "wb") as f:
        pickle.dump(dict(job, out=str(tmp)), f)
    ctx = mp.start_processes(_rank, args=(world, main_torch.free_port(), job_path), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.time() + JOIN_TIMEOUT_S
    while not ctx.join(timeout=max(deadline - time.time(), 0.1)):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError("ranks did not finish in %d s" % JOIN_TIMEOUT_S)
    out = []
    for r in range(world):
        with open("%s.rank%d" % (job_path, r), "rb") as f:
            out.append(pickle.load(f))
    return out
