"""The control of each one-card cell's comparison, on the card: the
reference put in the program's place in the nearest precision below the
configuration's (float32 with TF32 matrix products against the program's
float32 without them) must come out as not correct, and the program must
come out correct, on the same samples.  A run at 512 walkers a round (a
test's size); ``calibrate.py`` reads the same at the cells' own sizes.

    python -m pytest vmcbench/tests/test_vmcbench_control.py -q   # on a CUDA card
"""

import pytest
import torch

import calibrate
import check
import harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"] if w["chips"] == 1]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs TF32 matrix products on the card")
    torch.cuda.set_device(0)


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_program_passes(card, name):
    cell = harness.Cell(name)
    cell.mix.update(batch=512)
    recs = {r["side"]: r for r in calibrate.readings(cell, 2**31 + 101, True)}
    ok, lines = check.verdict(recs["program"]["numbers"], cell.limits)
    assert ok, lines
    bad, lines = check.verdict(recs["control"]["numbers"], cell.limits)
    assert not bad, lines
    bad, lines = check.verdict(recs["fault:half"]["numbers"], cell.limits)
    assert not bad, lines
