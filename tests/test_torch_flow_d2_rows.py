"""A numpy model of the depth-2 closure kernel's row algorithm
(``csrc/flow_d2.cu``, K5), against the port's ``ferminet_apply_and_jac_d2``
and the JAX package's Pallas kernel ``flow_u_jac_pallas_d2`` in interpret
mode, in f64 (1e-10).

The kernel gives each particle row i a warp.  Lane L owns the pairs (i, L)
and (i, L + 32), so n <= 64, and makes a pair's features (cos and sin of
k2 r, |sin(k1 r)| and its gradient, all from one sincos of the folded half
angle) and its tp layer in registers.  A walker's block runs three phases
between two barriers:

  1. a warp per row: the row sums over j of the features, then sig0, sp1
     and D of the row;
  2. a warp per column l: G_l = D_l - (1/n) sum_k sig0_k (A0[k][l] W3_0),
     with A0[k][l] taken from the pair (l, k) the warp holds (cos and |sin|
     are even in r, sin and the gradient of |sin| odd); and mean_i sp1 with
     the row-independent part of the final sp layer;
  3. a warp per row: the tp layer once per pair (sigmoid and softplus), its
     row sum, sig1, u, the row's matrices M, K, N, R, and the J blocks (i, l)
     of the row, the diagonal block taking minus the lanes' sum of A1 N.

Sums over the lanes are the fixed-order shuffle tree of ``_tree``.  The
model does all of this lane by lane, from the packed weights.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coulombgas_tpu.ops.pallas_flow_jac import flow_u_jac_pallas_d2
from coulombgas_tpu_torch.models.ferminet_jac import ferminet_apply_and_jac_d2

from _torch_helpers import box, flow_pair, t

WARP = 32


def _sigmoid(v):
    return 1.0 / (1.0 + np.exp(-v))


def _softplus(v):
    return np.logaddexp(v, 0.0)


def _pow2(v):
    return 1 << max(0, int(v - 1).bit_length())


def _tree(a):
    """The kernel's warp reduction of V values a lane, a (32, V) with V a
    power of two <= 32: halving rounds at lane offsets 16, 8, ... (a lane
    with the offset's bit keeps the upper half of its values and adds the
    partner's upper half; the other the lower halves), then butterfly rounds
    over the remaining offsets.  Returns (32,): lane L holds the sum over
    the lanes of value L >> (5 - log2 V)."""
    a = np.array(a, dtype=np.float64)
    lane = np.arange(WARP)
    o = 16
    while a.shape[1] > 1:
        h = a.shape[1] // 2
        hi = (lane & o) != 0
        keep = np.where(hi[:, None], a[:, h:], a[:, :h])
        send = np.where(hi[:, None], a[:, :h], a[:, h:])
        a = keep + send[lane ^ o]
        o //= 2
    a = a[:, 0]
    while o >= 1:
        a = a + a[lane ^ o]
        o //= 2
    return a


def _tree_sums(a, V=None):
    """The sums of a (32, v) by ``_tree`` over V >= v values (zero-padded;
    by default v rounded up to a power of two), read from the lanes that
    hold them."""
    v = a.shape[1]
    V = V or _pow2(v)
    held = _tree(np.pad(a, ((0, 0), (0, V - v))))
    return held[::WARP // V][:v]


def _butterfly(a):
    """xor-butterfly sum of one value a lane (32,): every lane gets it."""
    lane = np.arange(WARP)
    for o in (16, 8, 4, 2, 1):
        a = a + a[lane ^ o]
    return a[0]


def _packed(flow):
    """The flow's weights in the kernels' packed order, f64."""
    parts = []
    for lin in [*flow.sp, *flow.tp, flow.final]:
        parts += [lin.w.detach().reshape(-1), lin.b.detach().reshape(-1)]
    return torch.cat(parts).double().numpy()


def _unpack(p, dim, S, T):
    C0, off, out = 2 * dim + 1, 0, []
    for rows, cols in ((2 * dim + C0, S), (2 * S + T, S), (C0, T), (S, dim)):
        out.append(p[off:off + rows * cols].reshape(rows, cols))
        off += rows * cols
        out.append(p[off:off + cols])
        off += cols
    assert off == p.size
    return out


def _pair(x, i, L_, k1, k2, Lbox):
    """Features of the pairs (i, j), j = the lanes' columns: e (32, C0) and
    the A0 entries alpha, beta, gamma (32, dim); zero for j == i and for a
    lane without a pair."""
    n, dim = x.shape
    j = np.minimum(L_, n - 1)
    r = x[i] - x[j]
    r = r - Lbox * np.rint(r / Lbox)  # the features have period L in r
    s1, c1 = np.sin(k1 * r), np.cos(k1 * r)
    c2, s2 = 1.0 - 2.0 * s1 * s1, 2.0 * s1 * c1
    self_ = (L_ == i)[:, None]
    d = np.where(self_[:, 0], 0.0, np.sqrt((s1 * s1).sum(1)))
    safe = np.where(d > 0, d, 1.0)
    gam = np.where(self_, 0.0, k1 * s1 * c1 / safe[:, None])
    e = np.concatenate([c2, s2, d[:, None]], axis=1)
    alpha = np.where(self_, 0.0, -k2 * s2)
    beta = np.where(self_, 0.0, k2 * c2)
    valid = (L_ < n)[:, None]
    return e * valid, alpha * valid, beta * valid, gam * valid


def row_model(p, x, S, T, L):
    """(u, J) of one walker x (n, dim) by the kernel's row algorithm."""
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

    # ---- phase 1: a warp per row --------------------------------------------
    sig0, sp1, D = np.zeros((n, S)), np.zeros((n, S)), np.zeros((n, dim, S))
    for i in range(n):
        part = np.zeros((WARP, C0 + 3 * dim))
        for cols in slots:
            e, al, be, ga = _pair(x, i, cols, k1, k2, L)
            part += np.concatenate([e, al, be, ga], axis=1)
        sums = _tree_sums(part)
        tp0m = sums[:C0] / n
        sA = sums[C0:].reshape(3, dim)  # alpha, beta, gamma summed over j
        pre0 = b0 + tp0m @ w30
        sig0[i], sp1[i] = _sigmoid(pre0), _softplus(pre0)
        for d in range(dim):
            saw = sA[0, d] * w30[d] + sA[1, d] * w30[dim + d] + sA[2, d] * w30[2 * dim]
            D[i, d] = sig0[i] * saw / n

    # ---- phase 2: a warp per column l, from the mirrored pairs (l, k) --------
    G = np.zeros((n, dim, S))
    for l in range(n):
        acc = np.zeros((WARP, dim, S))
        for cols in slots:
            _, al, be, ga = _pair(x, l, cols, k1, k2, L)
            # A0[k][l] from (l, k): alpha and gamma odd in r, beta even
            sg = sig0[np.minimum(cols, n - 1)] * (cols < n)[:, None]
            for d in range(dim):
                acc[:, d] += sg * aw(-al, be, -ga, d)
        for d in range(dim):
            G[l, d] = D[l, d] - _tree_sums(acc[:, d], cap) / n
    spmean = np.zeros(S)
    for i in range(n):  # one thread a feature, ascending i
        spmean += sp1[i]
    spmean /= n
    base1 = b1 + spmean @ W2  # the row-independent part of the final layer

    # ---- phase 3: a warp per row ----------------------------------------------
    u = np.zeros((n, dim))
    J = np.zeros((nd, nd))
    for i in range(n):
        pairs, part = [], np.zeros((WARP, T))
        for cols in slots:
            e, al, be, ga = _pair(x, i, cols, k1, k2, L)
            pre = bt + e @ wt  # the tp layer, once per pair
            pairs.append((cols, _sigmoid(pre), al, be, ga))
            part += _softplus(pre) * (cols < n)[:, None]
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
    return u, J


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
