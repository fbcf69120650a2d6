"""The four-card cell's path on the CPU: two gloo ranks, each half of the
global batch; rank 0 gathers every rank's samples and checks them.  With
the exchange between the ranks left out, ``correct`` comes out false."""

import multiprocessing

import pytest

from _ranks import rank_main


def _world(fault, world=2):
    from main_torch import free_port

    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=rank_main, args=(r, world, port, fault, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        result, lines = queue.get(timeout=600)
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.kill()
    assert all(not p.is_alive() for p in procs)
    return result, lines


@pytest.mark.parametrize("fault,correct", [(None, True), ("no_exchange", False)])
def test_ranks(fault, correct):
    result, lines = _world(fault)
    assert result["correct"] is correct, lines
    assert result["device"]["count"] == 2
