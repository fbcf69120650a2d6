"""One rank of a CPU run of the four-card cell, under gloo (spawned by
``test_vmcbench_ranks.py``)."""

import argparse
import time

import torch

import harness
import runner
from _cpu_cell import cpu_cell


def rank_main(rank, world, port, fault, queue):
    torch.set_num_threads(1)
    cell = cpu_cell("n29.sr_hutchinson.dp4")
    if fault == "no_exchange":  # the accumulators' all-reduce left out
        init = harness.Driver.__init__

        def broken(self, *a, **kw):
            init(self, *a, **kw)
            self.reduce = lambda acc, accept_sum, leave_out=(): (acc, accept_sum)

        harness.Driver.__init__ = broken
    args = argparse.Namespace(workload=cell.name, seed=2**31 + 11, seconds=0.01, trace=0)
    result, lines = runner.run(args, rank, world, port, time.time(), cell=cell)
    if rank == 0:
        queue.put((result, lines))
