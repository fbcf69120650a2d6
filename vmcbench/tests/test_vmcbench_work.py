"""The work counts against hand counts at tiny shapes."""

import pytest

import work


def test_flow_counts_by_hand():
    # n 2, dim 1, depth 1, S 2: sp layer 2*2*(2*1+3)*2 = 40, Jsp/A 2*4*1*(1+3)*2 = 64,
    # final layer 2*2*2*1 = 8 and J 2*4*1*2*1 = 16
    assert work.flow_flops(1, 2, 1, 1, 2, 3) == 128
    assert work.flow_flops(5, 2, 1, 1, 2, 3) == 5 * 128
    # sp.0: (2*1+3)*2 + 2, final: 2*1 + 1
    assert work.flow_params(1, 1, 2, 3) == 15
    assert work.flow_bytes(1, 2, 1, 1, 2, 3) == 4 * (2 * 2 + 4 + 15)


def test_fused_and_k3_counts_by_hand():
    nbytes, flops = work.fused_counts(1, 2, 1)
    assert nbytes == 4 * (4 + 4 + 1)
    assert flops == pytest.approx(8 + 32 + 8 / 3 + 32 / 3 + 8)
    tb, to = work.k3_bound(3, 4)
    assert tb == pytest.approx(4 * 3 * 11 / work.PEAK_BYTES_PER_S * 1e3)
    assert to == pytest.approx(3 * 64 / 3 / work.PEAK_F32_FLOPS * 1e3)


def test_d2_and_large_counts_scale_with_batch():
    assert work.d2_flops(4, 3, 2, 4, 4, True)[0] == 4 * work.d2_flops(1, 3, 2, 4, 4, True)[0]
    assert work.d2_flops(1, 3, 2, 4, 4, True)[0] > work.d2_flops(1, 3, 2, 4, 4, False)[0]
    assert work.large_flops(2, 3, 2, 4, 4)[1] == 2 * work.large_flops(1, 3, 2, 4, 4)[1]


def test_van_counts_by_hand():
    # one layer, D 2, H 3, M 4, dim 1
    assert work.van_params(4, 1, 1, 2, 3) == (2 + 2) + (4 * 6 + 9 + 8) + (8 + 4) + 4
    # n 2: embed 2*2*1*2, layer 2*(8*4 + 4*6) + 4*3*2, out 2*2*2*4
    assert work.van_forward_flops(2, 4, 1, 1, 2, 3) == 8 + (2 * 56 + 24) + 32
    # one decode step (t = 0): 2*1*2 + 2*2*4 + (8*4 + 4*6 + 4*1*2)
    assert work.van_decode_flops(2, 4, 1, 1, 2, 3) == 4 + 16 + 64


def test_epoch_count_term_by_term():
    cfg = {"n": 2, "dim": 1, "depth": 1, "spsize": 2, "tpsize": 3, "num_states": 4,
           "nlayers": 1, "modelsize": 2, "nhidden": 3, "mc_steps": 3, "Gmax": 1}
    mix = {"batch": 5, "acc_steps": 2, "sr": False, "hutchinson": True}
    w = work.epoch_flops(cfg, mix)
    k2 = work.fused_counts(1, 2, 1)[1]
    assert w["mcmc"] == pytest.approx(10 * 4 * (128 + k2))
    assert w["van_decode"] == 10 * work.van_decode_flops(2, 4, 1, 1, 2, 3)
    assert w["total"] == pytest.approx(sum(v for k, v in w.items() if k != "total"))
    exact = work.epoch_flops(cfg, dict(mix, hutchinson=False))
    assert exact["accumulate"] > w["accumulate"]
    sr = work.epoch_flops(cfg, dict(mix, sr=True))
    assert "scores" in sr and "solve" in sr and "loss_grads" not in sr
    assert work.kgrid_size(2, 1) == 4 and work.kgrid_size(3, 1) == 6
