"""A numpy model of the carried-form depth-2 flow kernel K4
(``csrc/flow_large.cu``: one launch, a block of 8 warps per walker), against
the JAX package's analytic Jacobian ``ferminet_apply_and_jac`` at depth 2
and its row-chunked Pallas kernels ``flow_u_jac_pallas_large`` in interpret
mode, in f64 (1e-10).

Warp w of a walker's block takes the rows (and in phase 2 the columns) w,
w + 8, ...  Lane L owns the pairs (., L) and (., L + 32), so n <= 64, and
makes their features in registers.  Three phases between two barriers:

  1. a warp per row i: the sums over j of tp0 and of A0's entries (a
     shuffle tree) -> sig0_i, sp1_i and D_i = Jsp1[i][i];
  2. a warp per column l: jmean[l] = (1/n) sum_k Jsp1[k][l], lane k
     rebuilding Jsp1[k][l] = -sig0_k (A0[k][l] W30) / n (D_l at k = l), the
     lanes summed by a shuffle tree, then jW[l] = jmean[l] W1b; one warp
     sums mean_i sp1 in ascending i;
  3. a warp per row i: the tp layer per pair, the lanes' sums of tp1 and
     A1 (shuffle trees) -> sig1_i, u_i, sum_l AW1[i][l]; then per pair
     Jsp[i][l] = Jsp1 + sig1 (jW[l] + delta sum AW1 / n + Jsp1 W1a
     - A1 W1c / n) with Jsp1[i][l] rebuilt from the pair, and J's block
     (i, l) = delta + Jsp[i][l] Wf.

The model does all of this lane by lane, from the packed weights, in the
kernel's order of sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import coulombgas_tpu as cg
from coulombgas_tpu.ops.pallas_flow_jac import flow_u_jac_pallas_large

from _torch_helpers import box, flow_pair
from _warp_model import (
    WARP, _butterfly, _packed, _pair, _sigmoid, _softplus, _tree_sums, _unpack,
)

WARPS = 8


def _rows_of_warps(n):
    """The rows (or columns) each warp takes, in the order it takes them."""
    return [range(w, n, WARPS) for w in range(WARPS)]


def large_model(p, x, S, T, L):
    """(u, J) of one walker x (n, dim) by K4's algorithm."""
    n, dim = x.shape
    nd, C0 = n * dim, 2 * dim + 1
    assert n <= 2 * WARP
    w0, b0, w1f, b1, wt, bt, wf, bf = _unpack(p, dim, S, T)
    w30 = w0[2 * dim:]
    W1a, W1b, W1c = w1f[:S], w1f[S:2 * S], w1f[2 * S:]
    k1, k2 = np.pi / L, 2 * np.pi / L
    cap = 16 if (S, T) == (16, 16) else 32  # the kernel's width caps SM, TM
    lanes = np.arange(WARP)
    slots = (lanes, lanes + WARP)  # lane L owns columns L and L + 32

    def a0w(al, be, ga, d, W):  # (A0 W)[:, d, :] for the lanes' pairs
        return al[:, d:d + 1] * W[d] + be[:, d:d + 1] * W[dim + d] + ga[:, d:d + 1] * W[2 * dim]

    # ---- phase 1: a warp per row --------------------------------------------
    sig0, sp1, D = np.zeros((n, S)), np.zeros((n, S)), np.zeros((n, dim, S))
    for rows in _rows_of_warps(n):
        for i in rows:
            part = np.zeros((WARP, C0 + 3 * dim))
            for cols in slots:
                e, al, be, ga, _ = _pair(x, i, cols, k1, k2, L)
                part += np.concatenate([e, al, be, ga], axis=1)
            sums = _tree_sums(part)
            pre0 = b0 + (sums[:C0] / n) @ w30
            sig0[i], sp1[i] = _sigmoid(pre0), _softplus(pre0)
            sA = sums[C0:].reshape(3, dim)  # alpha, beta, gamma summed over j
            for d in range(dim):
                D[i, d] = sig0[i] * (sA[0, d] * w30[d] + sA[1, d] * w30[dim + d]
                                     + sA[2, d] * w30[2 * dim]) / n

    # ---- phase 2: a warp per column l, jmean[l] = mean_k Jsp1[k][l] -----------
    jW = np.zeros((n, dim, S))
    for cols_of_warp in _rows_of_warps(n):
        for l in cols_of_warp:
            acc = np.zeros((WARP, dim, S))
            for ks in slots:
                # the kernel forms the pair (k, l); here its mirror (l, k):
                # alpha and gamma are odd in r, beta even, exactly
                _, al, be, ga, _ = _pair(x, l, ks, k1, k2, L)
                al, ga = -al, -ga
                kk = np.minimum(ks, n - 1)
                for d in range(dim):
                    v = -(sig0[kk] * a0w(al, be, ga, d, w30)) / n
                    v[ks == l] = D[l, d]
                    acc[:, d] += v * (ks < n)[:, None]
            jmean = np.stack([_tree_sums(acc[:, d], cap) for d in range(dim)]) / n
            jW[l] = jmean @ W1b
    spmean = np.zeros(S)
    for i in range(n):  # one thread a feature, ascending i
        spmean += sp1[i]
    B1 = b1 + (spmean / n) @ W1b

    # ---- phase 3: a warp per row ----------------------------------------------
    u, J = np.zeros((n, dim)), np.zeros((nd, nd))
    for rows in _rows_of_warps(n):
        for i in rows:
            pairs, part, pa = [], np.zeros((WARP, T)), np.zeros((WARP, dim, T))
            for cols in slots:
                e, al, be, ga, _ = _pair(x, i, cols, k1, k2, L)
                valid = (cols < n)[:, None]
                pre = bt + e @ wt  # the tp layer, once per pair
                sigt = _sigmoid(pre) * valid
                part += _softplus(pre) * valid
                for d in range(dim):
                    pa[:, d] += sigt * a0w(al, be, ga, d, wt)
                pairs.append((cols, sigt, al, be, ga))
            tp1m = _tree_sums(part, cap) / n
            sA1 = np.stack([_tree_sums(pa[:, d], cap) for d in range(dim)])  # sum_l A1[i][l]
            pre1 = B1 + sp1[i] @ W1a + tp1m @ W1c
            sig1 = _sigmoid(pre1)
            spfin = sp1[i] + _softplus(pre1)
            for b in range(dim):  # lane s holds spfin[s] wf[s][b]
                u[i, b] = x[i, b] + bf[b] + _butterfly(np.pad(spfin * wf[:, b], (0, WARP - S)))
            sAW1 = sA1 @ W1c  # (dim, S)
            for cols, sigt, al, be, ga in pairs:
                for d_lane in lanes:
                    l = cols[d_lane]
                    if l >= n:
                        continue
                    diag = l == i
                    one = (lanes == d_lane)
                    aw = np.stack([a0w(al[one], be[one], ga[one], d, w30)[0] for d in range(dim)])
                    j1 = D[i] if diag else -(sig0[i] * aw) / n  # Jsp1[i][l] (dim, S)
                    acc = jW[l] + (sAW1 / n if diag else 0.0)
                    acc = acc + j1 @ W1a
                    awt = np.stack([a0w(al[one], be[one], ga[one], d, wt)[0] for d in range(dim)])
                    acc = acc + (-(sigt[d_lane] * awt) / n) @ W1c  # - A1[i][l] W1c / n
                    Jsp = j1 + sig1 * acc
                    blk = Jsp @ wf  # blk[a, b]
                    for a in range(dim):
                        for b in range(dim):
                            J[i * dim + b, l * dim + a] = blk[a, b] + (1.0 if diag and a == b else 0.0)
    return u, J


def _case(n, dim, S, T, batch):
    cfg, params, flow = flow_pair(2, S, T, n, dim, seed=n + S, stddev=0.3)
    rng = np.random.default_rng(n + dim + batch)
    x = rng.uniform(0, box(n, dim), (batch, n, dim))
    x[0, 1] = x[0, 0]  # coincident particles: zero pair distance
    return cfg, params, _packed(flow), x


def _jax_u_jac(params, cfg, x):
    fn = jax.jit(jax.vmap(lambda q: cg.ferminet_apply_and_jac(params, cfg, q)))
    return [np.asarray(a) for a in fn(jnp.asarray(x))]


CASES = [(7, 2, 16, 16, 1), (13, 2, 8, 12, 3), (7, 3, 8, 12, 3), (13, 3, 16, 16, 1)]


@pytest.mark.parametrize("n,dim,S,T,batch", CASES,
                         ids=["n%d_dim%d_%d_%d_b%d" % c for c in CASES])
def test_large_model_equals_jax_analytic_jacobian(n, dim, S, T, batch):
    """u and J element by element, a batch of 1 or 3 walkers, the first with
    two coincident particles."""
    cfg, params, p, x = _case(n, dim, S, T, batch)
    got = [large_model(p, xb, S, T, cfg.L) for xb in x]
    u_m = np.stack([g[0] for g in got])
    J_m = np.stack([g[1] for g in got])
    assert np.isfinite(u_m).all() and np.isfinite(J_m).all()
    u_j, J_j = _jax_u_jac(params, cfg, x)
    np.testing.assert_allclose(u_m, u_j, rtol=0, atol=1e-10)
    np.testing.assert_allclose(J_m, J_j, rtol=0, atol=1e-10)


def test_large_model_equals_pallas_large_kernels_interpret():
    """The TPU kernels themselves (two launches that meet through XLA means
    over rows), in interpret mode at f64."""
    n, dim, S, T = 7, 2, 16, 16
    cfg, params, p, x = _case(n, dim, S, T, 3)
    got = [large_model(p, xb, S, T, cfg.L) for xb in x]
    u_k, J_k = flow_u_jac_pallas_large(params, cfg, jnp.asarray(x), interpret=True)
    np.testing.assert_allclose(np.stack([g[0] for g in got]), np.moveaxis(np.asarray(u_k), -1, 0),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(np.stack([g[1] for g in got]), np.moveaxis(np.asarray(J_k), -1, 0),
                               rtol=0, atol=1e-10)

