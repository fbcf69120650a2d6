"""Microbatch chunks that straddle ranks' shares, on the CPU under gloo, f64.

``--batch 24 --num_devices 4 --microbatch 4``: shares of 6, so chunks 1 and
4 each lie across two ranks (walkers 4-7 across ranks 0 and 1, 16-19 across
2 and 3) while the others lie inside one.  ``--batch 18 --num_devices 3
--microbatch 9``: shares of 6, chunk 0 is 6 walkers of rank 0 and 3 of rank
1, chunk 1 the other 3 of rank 1 and 6 of rank 2: unequal pieces, and rank 1
in two overlapping groups.  One accumulate and apply of ``main_torch.py``'s
functions (Adam and SR ``plain``; ``tests/_torch_parallel_cases.py``)
agrees with one process holding the whole batch and with the JAX package's
accumulate and apply over a CPU mesh of as many devices with the same
microbatch, to ``tests/test_train.py``'s tolerances; the replicas end bit
for bit equal.  Beside them: the layout of the chunks, and the one-process
accumulate against the parent's arithmetic (weights ``1 / chunks``), bit
for bit.
"""

import numpy as np
import pytest
import torch

import _torch_parallel_cases as pc
from coulombgas_tpu_torch.parallel import mesh
from coulombgas_tpu_torch.train.train import (
    chunk_layout, init_accumulators, make_accumulate_and_apply,
)

from _torch_helpers import hutchinson_probe, training_stacks

# (ranks, microbatch, global batch)
LAYOUTS = {"c5": (4, 4, 24), "unequal_pieces": (3, 9, 18)}
CASES = [(o, lay) for lay in LAYOUTS for o in ("adam", "plain")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return pc.parallel_runs(tmp_path_factory.mktemp("straddle"), CASES, LAYOUTS, CASES)


@pytest.mark.parametrize("opt,layout", CASES)
def test_straddling_chunks_agree_with_one_process(runs, opt, layout):
    pc.check_one_process(runs, (opt, layout))


@pytest.mark.parametrize("opt,layout", CASES)
def test_straddling_chunks_agree_with_the_jax_mesh(runs, opt, layout):
    pc.check_jax_mesh(runs, (opt, layout))


@pytest.mark.parametrize("opt,layout", CASES)
def test_straddling_replicas_end_bit_for_bit_equal(runs, opt, layout):
    pc.check_replicas(runs, (opt, layout))


@pytest.mark.parametrize("batch,micro,world,want", [
    (24, 4, 4, [((0, 0, 4),), ((0, 4, 6), (1, 0, 2)), ((1, 2, 6),), ((2, 0, 4),),
                ((2, 4, 6), (3, 0, 2)), ((3, 2, 6),)]),
    (18, 9, 3, [((0, 0, 6), (1, 0, 3)), ((1, 3, 6), (2, 0, 6))]),
    (16, 8, 4, [((0, 0, 4), (1, 0, 4)), ((2, 0, 4), (3, 0, 4))]),
    (16, None, 2, [((0, 0, 8), (1, 0, 8))]),
    (16, 4, 1, [((0, 0, 4),), ((0, 4, 8),), ((0, 8, 12),), ((0, 12, 16),)]),
])
def test_chunk_layout_cuts_the_global_batch_as_the_jax_package(batch, micro, world, want):
    """Chunks of the global batch in order; each piece is (rank, start, stop)
    within that rank's share, and the pieces tile every share once."""
    layout = chunk_layout(batch, micro, world)
    assert layout == want
    share = batch // world
    for r in range(world):
        spans = [(s, e) for chunk in layout for rr, s, e in chunk if rr == r]
        assert spans[0][0] == 0 and spans[-1][1] == share
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


def _parent_accumulate(whole, van, flow, si, x, v, micro):
    """The parent's one-process chunked accumulate: each chunk's
    contribution added with weight ``1.0 / nchunks`` (``+=`` for the
    observables, ``add_(alpha=)`` for the tensors)."""
    batch = x.shape[0]
    nchunks = batch // micro
    acc = init_accumulators(van, flow)
    for s in range(0, batch, micro):
        sl = slice(s, s + micro)
        c = whole(van, flow, si[sl], x[sl], None, init_accumulators(van, flow), v=v[sl])
        w = 1.0 / nchunks
        for k in acc["data"]:
            acc["data"][k] += w * c["data"][k]
        for key in ("grads", "classical_score", "quantum_score"):
            dst = acc[key][0] + acc[key][1] if key == "grads" else acc[key]
            src = c[key][0] + c[key][1] if key == "grads" else c[key]
            for a, b in zip(dst, src):
                a.add_(b, alpha=w)
    return acc


@pytest.mark.parametrize("micro", [3, 4])
def test_one_process_accumulate_is_the_parents_bit_for_bit(micro):
    """Without a process group the pieces are the parent's chunks and each
    weighs piece / batch, the same float as the parent's 1 / chunks: the
    accumulators are the parent's bits."""
    st = training_stacks(n=pc.N, dim=pc.DIM, batch=12, Emax=pc.EMAX)
    van, flow, loss = st["van"], st["flow"], st["loss"]
    x, si = torch.from_numpy(st["x"]), torch.from_numpy(st["si"]).long()
    v = torch.from_numpy(np.asarray(hutchinson_probe(pc.KEY, st["x"].shape, 12 // micro)))
    whole, _ = make_accumulate_and_apply(loss, 1)
    want = _parent_accumulate(whole, van, flow, si, x, v, micro)
    pieces = mesh.window_groups(chunk_layout(12, micro, 1))
    assert [p[2] for p in pieces] == [None] * (12 // micro)
    acc, _ = make_accumulate_and_apply(loss, 1, pieces=pieces)
    got = acc(van, flow, si, x, None, init_accumulators(van, flow), v=v)
    for k in want["data"]:
        assert torch.equal(got["data"][k], want["data"][k]), k
    for key in ("grads", "classical_score", "quantum_score"):
        flat = lambda t: list(t[0]) + list(t[1]) if key == "grads" else list(t)  # noqa: E731
        for a, b in zip(flat(got[key]), flat(want[key])):
            assert torch.equal(a, b), key
