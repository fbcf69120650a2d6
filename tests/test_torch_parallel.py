"""Data parallelism of the port on the CPU: two ranks in a gloo group, f64.

One accumulate and apply of ``main_torch.py``'s functions on the same global
batch (``tests/_torch_parallel_cases.py``), for Adam, SR ``plain`` and SR
``host64``: the whole batch as one clip window, a microbatch that divides the
local batch (chunks inside a rank's half), and a chunk that spans both ranks.
Two ranks, each holding its contiguous half, agree with one process holding
all of it, and with the JAX package's accumulate and apply jitted over a
two-device CPU mesh, to ``tests/test_train.py``'s tolerances; the replicas
end bit for bit equal and no rank imported JAX.
"""

import pytest

import _torch_parallel_cases as pc

# (ranks, microbatch)
LAYOUTS = {"whole": (2, None), "local_chunks": (2, 4), "chunk_spans_both": (2, 16)}
CASES = [(o, lay) for lay in LAYOUTS for o in pc.OPTIMIZERS]
# the JAX package's chunks are chunks of the global batch: a chunk of both
# halves is its whole-batch program; the port's local chunks are held
# against one process
JAX_CASES = [c for c in CASES if c[1] != "local_chunks"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return pc.parallel_runs(tmp_path_factory.mktemp("parallel"), CASES, LAYOUTS, JAX_CASES)


@pytest.mark.parametrize("opt,layout", CASES)
def test_two_ranks_agree_with_one_process(runs, opt, layout):
    pc.check_one_process(runs, (opt, layout))


@pytest.mark.parametrize("opt,layout", JAX_CASES)
def test_two_ranks_agree_with_the_jax_two_device_mesh(runs, opt, layout):
    pc.check_jax_mesh(runs, (opt, layout))


@pytest.mark.parametrize("opt,layout", CASES)
def test_replicas_end_bit_for_bit_equal(runs, opt, layout):
    pc.check_replicas(runs, (opt, layout))


def test_a_chunk_of_both_halves_is_the_whole_batch(runs):
    """The window of a chunk of both halves is the whole batch's; chunks
    inside a half give other clipped weights, and another step."""
    for opt in pc.OPTIMIZERS:
        whole = pc.flat_params(runs["one"][opt, "whole"])
        both = pc.flat_params(runs["one"][opt, "chunk_spans_both"])
        local = pc.flat_params(runs["one"][opt, "local_chunks"])
        assert all((whole[k] == both[k]).all() for k in whole)
        assert any((whole[k] != local[k]).any() for k in whole)


def _ranks_per_chunk(batch, micro, world):
    """The most ranks that share one microbatch chunk's clip window."""
    from coulombgas_tpu_torch.train.train import chunk_layout

    return max(len(chunk) for chunk in chunk_layout(batch, micro, world))


@pytest.mark.parametrize("batch,micro,world,want", [
    (16, None, 2, 2), (16, 16, 2, 2), (16, 32, 2, 2), (16, 4, 2, 1), (16, 8, 2, 1),
    (16, 8, 4, 2), (16, 4, 4, 1), (24, 12, 4, 2), (16, None, 1, 1), (16, 4, 1, 1),
])
def test_ranks_per_chunk(batch, micro, world, want):
    assert _ranks_per_chunk(batch, micro, world) == want


# what main.py refuses: a batch the devices cannot share equally
# (main.py:330) and a microbatch that does not divide the batch (the JAX
# accumulate's assert); None: main.py trains, and a chunk may straddle two
# ranks' shares, with the most ranks a chunk spans
@pytest.mark.parametrize("batch,micro,world,want", [
    pytest.param(b, m, w, want, id="%d-%s-%d" % (b, m, w)) for b, m, w, want in [
        (15, None, 2, None), (24, 4, 4, 2), (24, 9, 3, None), (18, 9, 3, 2), (12, 4, 2, 2),
        (16, 6, 2, None), (24, 20, 4, None), (24, 48, 4, 4)]
])
def test_ranks_per_chunk_refuses_what_the_ranks_cannot_share(batch, micro, world, want):
    if want is None:
        with pytest.raises(ValueError):
            _ranks_per_chunk(batch, micro, world)
    else:
        assert _ranks_per_chunk(batch, micro, world) == want
