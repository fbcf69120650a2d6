"""A numpy model of the depth-2 closure kernels' row algorithm
(``csrc/flow_d2.cu``: K5, u and J, and K6, which adds the flow's coordinate
Laplacian, two instantiations of one kernel body), against the port's
``ferminet_apply_and_jac_d2`` / ``ferminet_apply_jac_lap_d2`` and the JAX
package's Pallas kernels ``flow_u_jac_pallas_d2`` / ``flow_u_jac_lap_pallas_d2``
in interpret mode, in f64 (1e-10).

The kernel gives each particle row i a warp.  Lane L owns the pairs (i, L)
and (i, L + 32), so n <= 64, and makes a pair's features (cos and sin of
k2 r, |sin(k1 r)| and its gradient, and for K6 its Laplacian, all from one
sincos of the folded half angle) and its tp layer in registers.  A walker's
block runs three phases between two barriers:

  1. a warp per row: the row sums over j of the features, then sig0, sp1
     and D of the row; K6 also sums the pair Laplacians of tp0 and the 3 x 3
     outer products of A0[i][j]'s entries per coordinate, which give
     sum_j |A0[i][j] W3_0|^2 as a quadratic form, and forms Lsp1 of the row;
  2. a warp per column l: G_l = D_l - (1/n) sum_k sig0_k (A0[k][l] W3_0),
     with A0[k][l] taken from the pair (l, k) the warp holds (cos and |sin|
     are even in r, sin and the gradient of |sin| odd); and mean_i sp1 with
     the row-independent part of the final sp layer; K6 also V_l = G_l W2 / n
     and mean_i(Lsp1) W2;
  3. a warp per row: the tp layer once per pair (sigmoid and softplus), its
     row sum, sig1, u, the row's matrices M, K, N, R, and the J blocks (i, l)
     of the row, the diagonal block taking minus the lanes' sum of A1 N.  K6
     sums the pairs' Laplacians of tp1 beside the softplus and, after the J
     blocks, U[i][l] = -(A0[i][l] Pq_i + A1[i][l] W3) / n per pair: the lanes
     sum (U + V_l)^2 and U, T_i = -sum_l U[i][l] (translation invariance),
     and lap of the row follows.

Sums over the lanes are the fixed-order shuffle tree of ``_tree``.  The
model does all of this lane by lane, from the packed weights.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coulombgas_tpu.ops.pallas_flow_jac import flow_u_jac_lap_pallas_d2, flow_u_jac_pallas_d2
from coulombgas_tpu_torch.models.ferminet_jac import (
    ferminet_apply_and_jac_d2, ferminet_apply_jac_lap_d2,
)

from _torch_helpers import box, flow_pair, t
from _warp_model import (
    WARP, _butterfly, _packed, _pair, _sigmoid, _softplus, _tree, _tree_sums, _unpack,
)


def row_model(p, x, S, T, L, lap=False):
    """(u, J) of one walker x (n, dim) by the kernel's row algorithm; with
    ``lap`` also the flow's coordinate Laplacian (nd,), as K6 computes it."""
    n, dim = x.shape
    nd, C0 = n * dim, 2 * dim + 1
    w0, b0, w1f, b1, wt, bt, wf, bf = _unpack(p, dim, S, T)
    w30 = w0[2 * dim:]
    W1, W2, W3 = w1f[:S], w1f[S:2 * S], w1f[2 * S:]
    k1, k2 = np.pi / L, 2 * np.pi / L
    cap = 16 if (S, T) == (16, 16) else 32  # the kernel's width caps SM, TM
    lanes = np.arange(WARP)
    slots = (lanes, lanes + WARP)  # lane L owns columns L and L + 32

    def aw(al, be, ga, d):  # (A0 W3_0)[:, d, :] for the lanes' pairs
        return al[:, d:d + 1] * w30[d] + be[:, d:d + 1] * w30[dim + d] + ga[:, d:d + 1] * w30[2 * dim]

    def ltp(e, hd, cols, i):  # the pair's Laplacian of tp0 (32, C0), zero at j == i
        other = (cols != i)[:, None]
        return np.concatenate([-2 * k2 * k2 * e[:, :2 * dim] * other, 2 * hd[:, None]], axis=1)

    # ---- phase 1: a warp per row --------------------------------------------
    sig0, sp1, D = np.zeros((n, S)), np.zeros((n, S)), np.zeros((n, dim, S))
    Lsp1 = np.zeros((n, S))
    for i in range(n):
        part = np.zeros((WARP, C0 + 3 * dim))
        partL = np.zeros((WARP, C0 + 6 * dim))
        for cols in slots:
            e, al, be, ga, hd = _pair(x, i, cols, k1, k2, L)
            part += np.concatenate([e, al, be, ga], axis=1)
            # per coordinate the pair's 3 x 3 outer product of (alpha, beta, gamma)
            outer = [np.stack([al[:, d] ** 2, be[:, d] ** 2, ga[:, d] ** 2, al[:, d] * be[:, d],
                               al[:, d] * ga[:, d], be[:, d] * ga[:, d]], axis=1) for d in range(dim)]
            partL += np.concatenate([ltp(e, hd, cols, i)] + outer, axis=1)
        sums = _tree_sums(part)
        tp0m = sums[:C0] / n
        sA = sums[C0:].reshape(3, dim)  # alpha, beta, gamma summed over j
        pre0 = b0 + tp0m @ w30
        sig0[i], sp1[i] = _sigmoid(pre0), _softplus(pre0)
        sumsL = _tree_sums(partL)
        lt, sq = (sumsL[:C0] / n) @ w30, np.zeros(S)
        for d in range(dim):
            wa, wb, wg = w30[d], w30[dim + d], w30[2 * dim]
            saw = sA[0, d] * wa + sA[1, d] * wb + sA[2, d] * wg
            D[i, d] = sig0[i] * saw / n
            m = sumsL[C0 + 6 * d:C0 + 6 * d + 6]  # sum_j |A0[i][j] W3_0|^2 by the outer products
            sq += saw * saw + m[0] * wa * wa + m[1] * wb * wb + m[2] * wg * wg \
                + 2 * (m[3] * wa * wb + m[4] * wa * wg + m[5] * wb * wg)
        Lsp1[i] = sig0[i] * lt + sig0[i] * (1 - sig0[i]) * sq / n**2

    # ---- phase 2: a warp per column l, from the mirrored pairs (l, k) --------
    G, V = np.zeros((n, dim, S)), np.zeros((n, dim, S))
    for l in range(n):
        acc = np.zeros((WARP, dim, S))
        for cols in slots:
            _, al, be, ga, _ = _pair(x, l, cols, k1, k2, L)
            # A0[k][l] from (l, k): alpha and gamma odd in r, beta even
            sg = sig0[np.minimum(cols, n - 1)] * (cols < n)[:, None]
            for d in range(dim):
                acc[:, d] += sg * aw(-al, be, -ga, d)
        for d in range(dim):
            G[l, d] = D[l, d] - _tree_sums(acc[:, d], cap) / n
        V[l] = G[l] @ W2 / n  # the mean part of the final layer's JfW
    spmean, Lmean = np.zeros(S), np.zeros(S)
    for i in range(n):  # one thread a feature, ascending i
        spmean += sp1[i]
        Lmean += Lsp1[i]
    spmean /= n
    base1 = b1 + spmean @ W2  # the row-independent part of the final layer
    baseL = (Lmean / n) @ W2  # and of its Laplacian

    # ---- phase 3: a warp per row ----------------------------------------------
    u, lap_u = np.zeros((n, dim)), np.zeros((n, dim))
    J = np.zeros((nd, nd))
    for i in range(n):
        pairs, part, partL = [], np.zeros((WARP, T)), np.zeros((WARP, T))
        for cols in slots:
            e, al, be, ga, hd = _pair(x, i, cols, k1, k2, L)
            pre = bt + e @ wt  # the tp layer, once per pair
            sigt = _sigmoid(pre)
            pairs.append((cols, sigt, al, be, ga))
            part += _softplus(pre) * (cols < n)[:, None]
            # the pair's Laplacian of tp1: sigt (Ltp0 wt) + sigt (1 - sigt) 2 |A0 wt|^2
            awt = [al[:, d:d + 1] * wt[d] + be[:, d:d + 1] * wt[dim + d] + ga[:, d:d + 1] * wt[2 * dim]
                   for d in range(dim)]
            partL += sigt * (ltp(e, hd, cols, i) @ wt) + sigt * (1 - sigt) * 2 * sum(a * a for a in awt)
        tp1m = _tree_sums(part, cap) / n
        pre1 = base1 + sp1[i] @ W1 + tp1m @ W3
        sig1 = _sigmoid(pre1)
        spfin = sp1[i] + _softplus(pre1)
        for b in range(dim):  # lane s holds spfin[s] wf[s][b]
            u[i, b] = x[i, b] + bf[b] + _butterfly(np.pad(spfin * wf[:, b], (0, WARP - S)))
        M = wf + W1 @ (sig1[:, None] * wf)
        R = W2 @ (sig1[:, None] * wf) / n
        N = -W3 @ (sig1[:, None] * wf) / n
        K = -w30 @ (sig0[i][:, None] * M) / n
        dg = D[i] @ M
        blocks, a1n = [], []
        for cols, sigt, al, be, ga in pairs:
            accN = (wt[None] * sigt[:, None, :]) @ N  # (lanes, C0, dim)
            A1N = al[:, :, None] * accN[:, :dim] + be[:, :, None] * accN[:, dim:2 * dim] \
                + ga[:, :, None] * accN[:, 2 * dim:2 * dim + 1]
            A0K = al[:, :, None] * K[:dim] + be[:, :, None] * K[dim:2 * dim] \
                + ga[:, :, None] * K[2 * dim:2 * dim + 1]
            GR = np.einsum("las,sb->lab", G[np.minimum(cols, n - 1)], R)
            blocks.append((cols, A0K + A1N + GR))
            a1n.append(A1N)
        sumA1N = np.array([[_butterfly(a1n[0][:, a, b] + a1n[1][:, a, b])
                            for b in range(dim)] for a in range(dim)])
        for cols, blk in blocks:
            for L_ in lanes:
                l = cols[L_]
                if l >= n:
                    continue
                out = blk[L_] + ((np.eye(dim) + dg - sumA1N) if l == i else 0.0)
                for a in range(dim):
                    for b in range(dim):
                        J[i * dim + b, l * dim + a] = out[a, b]
        if not lap:
            continue
        # the Laplacian: lane s2 keeps Lsp1 + sig1 (Lf W1f) and sig1 (1 - sig1)
        Ltp1m = _tree_sums(partL, cap) / n
        keep = Lsp1[i] + sig1 * (baseL + Lsp1[i] @ W1 + Ltp1m @ W3)
        # U[i][l] = -(A0[i][l] Pq_i + A1[i][l] W3) / n with Pq_i = diag(sig0_i) W3_0 W1;
        # the lanes sum (U + V_l)^2 over their pairs l and U itself, whose sum
        # over l is -T_i (the features do not move when every particle does)
        Pq = (w30 * sig0[i]) @ W1
        q, us = np.zeros((WARP, S)), np.zeros((WARP, dim, S))
        for cols, sigt, al, be, ga in pairs:
            valid = (cols < n)[:, None]
            for d in range(dim):
                awt = al[:, d:d + 1] * wt[d] + be[:, d:d + 1] * wt[dim + d] + ga[:, d:d + 1] * wt[2 * dim]
                X = al[:, d:d + 1] * Pq[d] + be[:, d:d + 1] * Pq[dim + d] + ga[:, d:d + 1] * Pq[2 * dim] \
                    + (sigt * awt) @ W3
                U = -X / n
                q += ((U + V[np.minimum(cols, n - 1), d]) ** 2) * valid
                us[:, d] += U * valid
        Tm = -np.stack([_tree_sums(us[:, d], cap) for d in range(dim)])
        sq1 = _tree_sums(q, cap) + (Tm * (Tm + 2 * V[i])).sum(0)
        Lfin = keep + sig1 * (1 - sig1) * sq1
        for b in range(dim):
            lap_u[i, b] = _butterfly(np.pad(Lfin * wf[:, b], (0, WARP - S)))
    return (u, J, lap_u.reshape(nd)) if lap else (u, J)


CASES = [(7, 2, 16, 16), (13, 2, 8, 12), (7, 3, 8, 12), (13, 3, 16, 16)]


@pytest.mark.parametrize("n,dim,S,T", CASES, ids=["n%d_dim%d_%d_%d" % c for c in CASES])
def test_row_model_equals_both_packages(n, dim, S, T):
    cfg, params, flow = flow_pair(2, S, T, n, dim, seed=n, stddev=0.3)
    rng = np.random.default_rng(n + dim)
    x = rng.uniform(0, box(n, dim), (3, n, dim))
    x[1, 1] = x[1, 0]  # coincident particles: zero pair distance
    p = _packed(flow)
    got = [row_model(p, xb, S, T, cfg.L) for xb in x]
    u_m = np.stack([g[0] for g in got])
    J_m = np.stack([g[1] for g in got])
    assert np.isfinite(J_m).all()
    with torch.no_grad():
        u_p, J_p = ferminet_apply_and_jac_d2(flow, t(x))
    np.testing.assert_allclose(u_m, u_p.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(J_m, J_p.numpy(), rtol=0, atol=1e-10)
    u_k, J_k = flow_u_jac_pallas_d2(params, cfg, jnp.asarray(x), interpret=True)
    np.testing.assert_allclose(u_m, np.moveaxis(np.asarray(u_k), -1, 0), rtol=0, atol=1e-10)
    np.testing.assert_allclose(J_m, np.moveaxis(np.asarray(J_k), -1, 0), rtol=0, atol=1e-10)


@pytest.mark.parametrize("V", [1, 2, 8, 16, 32])
def test_the_shuffle_tree_sums_every_value_in_a_fixed_order(V):
    a = np.random.default_rng(V).normal(size=(WARP, V))
    np.testing.assert_allclose(_tree_sums(a), a.sum(0), rtol=1e-13, atol=1e-13)
    held = _tree(a)  # lane L holds value L >> (5 - log2 V), all lanes of a group alike
    np.testing.assert_array_equal(held.reshape(V, -1), held.reshape(V, -1)[:, :1].repeat(WARP // V, 1))


@pytest.mark.parametrize("n,dim,S,T", CASES, ids=["n%d_dim%d_%d_%d" % c for c in CASES])
def test_row_model_laplacian_equals_both_packages(n, dim, S, T):
    """K6: the row model's (u, J, lap) against ``ferminet_apply_jac_lap_d2``
    and the Pallas ``flow_u_jac_lap_pallas_d2`` in interpret mode."""
    cfg, params, flow = flow_pair(2, S, T, n, dim, seed=n, stddev=0.3)
    rng = np.random.default_rng(n + dim)
    x = rng.uniform(0, box(n, dim), (3, n, dim))
    x[1, 1] = x[1, 0]  # coincident particles: zero pair distance
    p = _packed(flow)
    got = [row_model(p, xb, S, T, cfg.L, lap=True) for xb in x]
    want = {"port": None, "jax": None}
    with torch.no_grad():
        want["port"] = [a.numpy() for a in ferminet_apply_jac_lap_d2(flow, t(x))]
    out = flow_u_jac_lap_pallas_d2(params, cfg, jnp.asarray(x), interpret=True)
    want["jax"] = [np.moveaxis(np.asarray(a), -1, 0) for a in out]
    for k, name in enumerate(("u", "J", "lap")):
        m = np.stack([g[k] for g in got])
        assert np.isfinite(m).all(), name
        for ref, w in want.items():
            np.testing.assert_allclose(m, w[k].reshape(m.shape), rtol=0, atol=1e-10,
                                       err_msg="%s vs %s" % (name, ref))
