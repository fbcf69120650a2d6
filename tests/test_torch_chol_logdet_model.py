"""The batched log-det kernel K3 (``csrc/chol_logdet.cu``) as a numpy model,
against the one-step-at-a-time eliminations it replaces: the port's
``chol_logdet_ref`` and the JAX package's ``chol_logdet_ref`` in f64, and the
JAX package's Pallas kernel in interpret mode in f32.

The model follows the kernel as a whole: the plan's schedule of matrices over
persistent groups, each group's one packed buffer (rows of 4 x 4 tiles, row
r holding columns 0 .. 4 floor(r/4) + 3) and U/V reused from matrix to
matrix and filled with NaN before the first, so that a value the fetch does
not write (the zeros above the diagonal in the diagonal tiles, the pad rows)
would show; the panel of 8 columns as the warps hold it in registers (rows
k0 .. k0+3 only up to column k0+3; every warp's replica of the diagonal block
takes the same steps, so one stands for all), its pivot steps with their
deflation, U and V; and the trailing update of the lower tiles.  Each element
takes the same operations in the same order as in the kernel, so the model
agrees with the references to 1e-9 in f64 where no pivot is near the floor,
and exactly where every pivot deflates.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coulombgas_tpu.ops import logdet as jl
from coulombgas_tpu.ops.pallas_logdet import chol_logdet_pallas
from coulombgas_tpu_torch.ops import cuda_logdet as k3
from coulombgas_tpu_torch.ops import logdet as tl

FLOOR = tl.PIVOT_FLOOR
NB = 8


class Layout:
    """Flat indices of the packed matrix for one m."""

    def __init__(self, m):
        self.m, self.mp = m, 4 * ((m + 3) // 4)
        off = np.array([k3.k3_row(r) for r in range(self.mp)])
        r = np.concatenate([np.full(4 * (i // 4) + 4, i) for i in range(self.mp)])
        c = np.concatenate([np.arange(4 * (i // 4) + 4) for i in range(self.mp)])
        self.off, self.r, self.c, self.flat = off, r, c, off[r] + c
        self.floats = k3.k3_matrix_floats(m)
        assert self.flat.tolist() == list(range(self.floats))

    def fetch(self, buf, A):
        """The lower triangle by cp.async, zeros elsewhere: every float of
        the buffer is written."""
        lower = (self.r < self.m) & (self.c <= self.r)
        rr, cc = np.minimum(self.r, self.m - 1), np.minimum(self.c, self.m - 1)
        buf[self.flat] = np.where(lower, A[rr, cc], 0)


def panel(L, buf, k0, acc, dtype):
    """The panel: returns (P, invd, acc); P[j] is row k0 + j, padded to at
    least 8 rows (lanes past mp hold zeros)."""
    m, mp = L.m, L.mp
    P = np.zeros((max(mp - k0, NB), NB), dtype)
    for j in range(mp - k0):
        r = k0 + j
        if r < m:
            P[j, :4] = buf[L.off[r] + k0:L.off[r] + k0 + 4]
            if r >= k0 + 4:
                P[j, 4:] = buf[L.off[r] + k0 + 4:L.off[r] + k0 + 8]
    invd = np.zeros(NB, dtype)
    rows = np.arange(P.shape[0])
    log_floor = dtype(math.log(FLOOR)) if dtype is np.float64 else np.log(np.float32(FLOOR))
    for kk in range(NB):
        if k0 + kk >= m:
            break
        d = P[kk, kk]
        colk = P[kk + 1:NB, kk].copy()
        bad = d < FLOOR
        acc = acc + (log_floor if bad else np.log(d))
        inv = dtype(0) if bad else dtype(1) / d
        invd[kk] = inv
        below = rows > kk
        ark = np.where(below, P[:, kk] * inv, dtype(0))
        if bad:
            P[below, kk] = 0
        P[:, kk + 1:] -= ark[:, None] * colk[None, :]
    return P, invd, acc


def write_uv(L, P, invd, k0, pair):
    """U and V of rows k0 + 8 .. mp - 1 into ``pair`` (2, 8, mp)."""
    rows = np.arange(k0 + NB, L.mp)
    pair[1][:, rows] = P[rows - k0].T
    pair[0][:, rows] = P[rows - k0].T * invd[:, None]


def trailing(L, buf, pair, k1):
    """The trailing block (rows and columns >= k1, tiles of the lower
    triangle, their upper parts included) loses sum_k U[k][r] V[k][c], k
    ascending."""
    sel = (L.r >= k1) & (L.c >= k1)
    f, r, c = L.flat[sel], L.r[sel], L.c[sel]
    for kk in range(NB):
        buf[f] -= pair[0][kk, r] * pair[1][kk, c]


def eliminate(L, buf, uv, dtype):
    """The kernel's cg_k3_eliminate on the packed buffer; uv (2, 8, mp)."""
    m = L.m
    acc = dtype(0)
    for k0 in range(0, m, NB):
        P, invd, acc = panel(L, buf, k0, acc, dtype)
        if k0 + NB >= m:
            break
        write_uv(L, P, invd, k0, uv)
        trailing(L, buf, uv, k0 + NB)
    return acc


def model(A, plan, dtype=np.float64):
    """The kernel on the batch A (B, m, m) with ``plan``: each group's
    buffer and U/V, NaN at first, reused for all of its matrices."""
    A = np.asarray(A, dtype)
    B, m, _ = A.shape
    L = Layout(m)
    out = np.full(B, np.nan, dtype)
    for mats in k3.k3_schedule(plan):
        buf = np.full(L.floats, np.nan, dtype)
        uv = np.full((2, NB, L.mp), np.nan, dtype)
        for b in mats:
            L.fetch(buf, A[b])
            out[b] = eliminate(L, buf, uv, dtype)
    return out


def _spd(rng, m):
    X = rng.normal(size=(m, m + 3))
    return X @ X.T / m + 0.1 * np.eye(m)


def _zero(A, cols):
    A = A.copy()
    A[cols, :] = 0
    A[:, cols] = 0
    return A


def _cases(m, seed):
    """Two regular matrices; one zero row and column at a panel's first,
    middle and last column (8, 12, 15; below m 16 the last column); two in
    one panel; the zero matrix."""
    rng = np.random.default_rng(seed)
    A = _spd(rng, m)
    cols = [8, 12, 15] if m > 15 else [m - 1]
    out = [A, _spd(rng, m)] + [_zero(A, [c]) for c in cols]
    out.append(_zero(A, [8, 15] if m > 15 else [0, m - 1]))
    out.append(np.zeros_like(A))
    # the upper triangle is never read: poison it
    out = np.stack(out)
    iu = np.triu_indices(m, 1)
    out[:, iu[0], iu[1]] = np.nan
    return out, cols


def _sym(As):
    """The symmetric matrices of the poisoned stack, for the references."""
    low = np.tril(np.nan_to_num(As, nan=0.0))
    return low + np.tril(low, -1).transpose(0, 2, 1)


_jax_ref = jl.chol_logdet_ref  # eager: jit would unroll m steps and take longer to compile


@pytest.mark.parametrize("m", [26, 58, 114, 171])
def test_model_matches_the_one_step_eliminations(m):
    As, cols = _cases(m, seed=m)
    # one group a block on 2 SMs: each group takes 3 or 4 matrices
    plan = next(p for p in k3.k3_plans(m, len(As), 2, k3.k3_warps(m)) if p.groups == 1)
    got = model(As, plan)
    S = _sym(As)
    for ref in (tl.chol_logdet_ref(torch.from_numpy(S)).numpy(), np.asarray(_jax_ref(jnp.asarray(S)))):
        np.testing.assert_allclose(got, ref, rtol=1e-11, atol=1e-9)
    # every pivot of the zero matrix deflates: the same sum in the same order
    assert got[-1] == tl.chol_logdet_ref(torch.from_numpy(S[-1:])).numpy()[0]
    # a zero row and column costs log(FLOOR) and leaves the rest's log det
    for case, c in zip(S[2:2 + len(cols)], cols):
        keep = [i for i in range(m) if i != c]
        want = np.linalg.slogdet(case[np.ix_(keep, keep)])[1] + math.log(FLOOR)
        assert abs(model(case[None], k3.k3_plan(m, 1))[0] - want) < 1e-8


def test_model_is_the_same_under_every_plan_and_batch():
    """Every plan of 1, 2, 4 and 8 warps on 1, 3 and 132 SMs, a batch of one
    and a ragged one: the same bits for each matrix (the arithmetic of a matrix
    depends on m alone, and a group's buffers carry nothing over)."""
    m = 37
    rng = np.random.default_rng(5)
    As = np.stack([_spd(rng, m) for _ in range(9)])
    want = model(As, k3.k3_plan(m, 9))
    for sms in (1, 3, 132):
        for plan in k3.k3_plans(m, 9, sms):
            np.testing.assert_array_equal(model(As, plan), want)
    np.testing.assert_array_equal(model(As[:1], k3.k3_plan(m, 1)), want[:1])
    np.testing.assert_array_equal(model(As[:8], k3.k3_plan(m, 8, 2)), want[:8])


def test_model_f32_matches_the_pallas_kernel_in_interpret_mode():
    """The model in f32 against the TPU kernel in interpret mode (m 26, the
    n 13 accumulate's J J^T; a deflated column and the zero matrix in the
    batch), at the tolerances of tests/test_logdet.py."""
    m = 26
    As, _ = _cases(m, seed=3)
    S = _sym(As).astype(np.float32)
    ref = np.asarray(chol_logdet_pallas(jnp.asarray(S), interpret=True))
    got = model(As.astype(np.float32), k3.k3_plan(m, len(As)), np.float32)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    assert np.isfinite(got).all() and got[-1] < -40 * m
