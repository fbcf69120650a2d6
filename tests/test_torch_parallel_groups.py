"""Data parallelism of the port on the CPU: four ranks, microbatch chunks of
two ranks each, f64.

At batch 16 over four ranks a microbatch of 8 spans two ranks' shares of 4:
the clip window of each chunk is reduced over its own sub-group of two
consecutive ranks.  One SR accumulate and apply (``plain`` and ``host64``;
``tests/_torch_parallel_cases.py``) agrees with one process holding the
whole batch and with the JAX package's accumulate and apply over a
four-device CPU mesh with the same microbatch, to ``tests/test_train.py``'s
tolerances; the replicas end bit for bit equal.
"""

import pytest

import _torch_parallel_cases as pc

LAYOUTS = {"chunks_of_two_ranks": (4, 8)}
CASES = [("plain", "chunks_of_two_ranks"), ("host64", "chunks_of_two_ranks")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return pc.parallel_runs(tmp_path_factory.mktemp("groups"), CASES, LAYOUTS, CASES)


@pytest.mark.parametrize("opt,layout", CASES)
def test_four_ranks_agree_with_one_process(runs, opt, layout):
    pc.check_one_process(runs, (opt, layout))


@pytest.mark.parametrize("opt,layout", CASES)
def test_four_ranks_agree_with_the_jax_four_device_mesh(runs, opt, layout):
    pc.check_jax_mesh(runs, (opt, layout))


@pytest.mark.parametrize("opt,layout", CASES)
def test_four_replicas_end_bit_for_bit_equal(runs, opt, layout):
    pc.check_replicas(runs, (opt, layout))
