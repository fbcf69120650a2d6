"""The host side of the batched log-det kernel K3 (``ops/cuda_logdet.py``):
its launch plan, its schedule of matrices over groups, its packed storage and
``chol_logdet_fits``, all answered on the CPU without ``nvcc`` or a card.

The C launcher (``csrc/chol_logdet.cu``) refuses a plan whose shared bytes,
threads or barrier ids it cannot run; these tests hold the plan to the same
limits at the batch sizes and matrix sizes the port calls it with.
"""

import numpy as np
import pytest

from coulombgas_tpu_torch.ops import _build, cuda_logdet as k3

BATCHES = (1, 3, 31, 512, 2047, 4096)
MS = (1, 2, 26, 58, 114, 171, 241)


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("m", MS)
def test_plan_covers_every_matrix_once_within_the_limits(m, batch):
    plan = k3.k3_plan(m, batch)
    assert (plan.m, plan.batch) == (m, batch)
    # every matrix exactly once, each group's in ascending order
    sched = k3.k3_schedule(plan)
    assert len(sched) == plan.grid * plan.groups
    assert sorted(b for mats in sched for b in mats) == list(range(batch))
    assert all(mats == sorted(mats) for mats in sched)
    # the launcher's limits
    threads = 32 * plan.warps * plan.groups
    assert threads <= k3.K3_BLOCK <= 1024
    assert plan.smem == k3.k3_smem_bytes(m, plan.groups) <= _build.SMEM_LIMIT_BYTES
    if plan.warps > 1:  # named barriers 1 .. groups; a one-warp group uses __syncwarp
        assert plan.groups <= 15
    # persistent: no more blocks than the batch needs or an SM holds
    assert 1 <= plan.grid <= max(1, -(-batch // plan.groups))
    assert plan.grid <= k3.H100_SMS * plan.blocks_per_sm
    assert 1 <= plan.blocks_per_sm <= k3.K3_BLOCKS_PER_SM
    assert (plan.blocks_per_sm * (plan.smem + k3.SM_BLOCK_RESERVED) <= k3.SM_SMEM_BYTES
            and plan.blocks_per_sm * threads <= k3.SM_THREADS)


def test_plan_picks_the_measured_shapes_of_the_port():
    """Warps a group by m, and a plan that keeps every SM busy at the batch
    sizes the port runs (one matrix a group where the card holds the batch)."""
    assert [k3.k3_warps(m) for m in (26, 58, 64, 65, 114, 128, 129, 171, 241)] == [
        1, 1, 1, 4, 4, 4, 8, 8, 8]
    for m, batch in ((58, 2048), (26, 2048), (114, 512)):
        plan = k3.k3_plan(m, batch)
        assert max(len(mats) for mats in k3.k3_schedule(plan)) == 1
    plan = k3.k3_plan(171, 512)
    assert plan.grid == k3.H100_SMS * plan.blocks_per_sm  # the whole card
    # the plans offered are those that fit: at m 241 one group a block of
    # one warp (two would need 267 KB), and no group wider than a block
    assert [p.groups for p in k3.k3_plans(241, 64, warps=1)] == [1]
    assert all(p.smem <= _build.SMEM_LIMIT_BYTES for p in k3.k3_plans(241, 64))
    with pytest.raises(ValueError):
        k3.k3_plans(58, 64, warps=16)


def test_fits_every_m_up_to_the_ceiling_without_the_library(monkeypatch):
    def no_library(name):
        raise AssertionError("chol_logdet_fits asked for the built library")

    monkeypatch.setattr(k3, "load_library", no_library)
    assert all(k3.chol_logdet_fits(m) for m in range(0, 242))
    assert k3.chol_logdet_fits(k3.K3_MAX_M) and not k3.chol_logdet_fits(k3.K3_MAX_M + 1)
    assert not k3.chol_logdet_fits(400)
    assert k3.chol_logdet_fits(400, "cpu")  # the plain version takes any size
    for m in range(0, k3.K3_MAX_M + 1):
        plan = k3.k3_plan(m, 512)
        assert plan.smem <= _build.SMEM_LIMIT_BYTES, m
    with pytest.raises(ValueError):
        k3.k3_plan(k3.K3_MAX_M + 1, 1)


@pytest.mark.parametrize("m", [1, 2, 5, 26, 58, 114, 171, 241, 256])
def test_packed_rows_tile_the_lower_triangle(m):
    """Row r = 4t + i holds columns 0 .. 4t + 3, rows follow each other with
    no gap or overlap, every row starts 16-byte aligned, and the rows up to
    the padded size fill ``k3_matrix_floats``."""
    mp = 4 * ((m + 3) // 4)
    pos = 0
    for r in range(mp):
        assert k3.k3_row(r) == pos and pos % 4 == 0
        length = 4 * (r // 4) + 4
        assert length >= r + 1  # the lower triangle of the row fits
        pos += length
    assert pos == k3.k3_matrix_floats(m)
    # the tile (tr, tc) the kernel addresses as 8 tr (tr + 1) + 4 tc with
    # row stride 4 (tr + 1) is rows 4 tr .. 4 tr + 3, columns 4 tc .. 4 tc + 3
    for tr in range(mp // 4):
        for i in range(4):
            assert k3.k3_row(4 * tr + i) == 8 * tr * (tr + 1) + i * 4 * (tr + 1)


def prow(k0, w, W, s, lane):
    """csrc/chol_logdet.cu:cg_k3_prow: the panel row of (warp, slot, lane)."""
    if s == 0:
        return k0 + lane if lane < 8 else k0 + 24 * w + lane
    return k0 + 8 + 24 * W + 32 * ((s - 1) * W + w) + lane


@pytest.mark.parametrize("warps", [1, 2, 4, 8])
def test_panel_rows_are_each_held_once(warps):
    """Every warp holds the panel's own 8 rows in lanes 0..7 of its first
    slot; every row below, up to the padded size, is held by exactly one
    (warp, slot, lane) within ``k3_slots`` slots, at every panel of every m;
    the slots stay within the kernel's 8."""
    for m in list(range(1, 70)) + [114, 171, 241, 256]:
        mp, S = 4 * ((m + 3) // 4), k3.k3_slots(m, warps)
        assert 1 <= S <= 8
        for k0 in range(0, m, 8):
            held = [prow(k0, w, warps, s, lane) for w in range(warps) for s in range(S)
                    for lane in range(32) if s > 0 or lane >= 8]
            assert len(set(held)) == len(held)
            assert sorted(r for r in held if r < mp) == list(range(k0 + 8, mp)), (m, k0)
            assert all(prow(k0, w, warps, 0, lane) == k0 + lane
                       for w in range(warps) for lane in range(8))


def tri_tile(q):
    """csrc/chol_blocked.cuh:cg_tri_tile in f32, as the kernel computes it."""
    r = int(np.float32((np.sqrt(np.float32(8.0) * np.float32(q) + np.float32(1.0))
                        - np.float32(1.0)) * np.float32(0.5)))
    while r * (r + 1) // 2 > q:
        r -= 1
    while (r + 1) * (r + 2) // 2 <= q:
        r += 1
    return r, q - r * (r + 1) // 2


def test_trailing_tiles_are_each_taken_once():
    """The trailing update's tile index q -> (tr, tc) is a bijection onto the
    lower triangle of tiles at every trailing size up to m 256 (64 tiles)."""
    for nt in range(1, 65):
        tiles = [tri_tile(q) for q in range(nt * (nt + 1) // 2)]
        assert sorted(tiles) == [(r, c) for r in range(nt) for c in range(r + 1)]
