"""A numpy model of the flow kernel's column algorithm (``csrc/flow_jac.cu``,
K1), against the port's ``ferminet_apply_and_jac`` (f64) and the JAX
package's Pallas kernel ``flow_u_jac_pallas`` in interpret mode (f32).

The kernel's forward pass forms, per row l and layer k, the mean of
tp_k[l][j] over j and the row sum sum_j A_k[l][j] (a table the columns
share); then a warp per column particle l carries Jsp[:, l] through the
layers, rebuilding the pair block A_k[i][l] of every row i from the pair's
layer-0 features through k tp layers, and keeps no pair stream.  The model
does the same, column by column, from the same packed weights.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coulombgas_tpu.ops.pallas_flow_jac import flow_u_jac_pallas
from coulombgas_tpu_torch.models.ferminet_jac import ferminet_apply_and_jac
from coulombgas_tpu_torch.ops import cuda_flow_jac

from _torch_helpers import box, flow_pair, t


def _sigmoid(v):
    return 1.0 / (1.0 + np.exp(-v))


def _softplus(v):
    return np.logaddexp(v, 0.0)


def _unpack(p, depth, dim, S, T):
    """The packed weights (sp_w, sp_b per layer; tp_w, tp_b per layer; final)."""
    C0, off = 2 * dim + 1, 0
    sp, tp = [], []

    def take(rows, cols):
        nonlocal off
        w = p[off:off + rows * cols].reshape(rows, cols)
        off += rows * cols
        b = p[off:off + cols]
        off += cols
        return w, b

    for k in range(depth):
        sp.append(take((2 * dim + C0) if k == 0 else (2 * S + T), S))
    for k in range(depth - 1):
        tp.append(take(C0 if k == 0 else T, T))
    final = take(S, dim)
    assert off == p.size
    return sp, tp, final


def column_model(p, x, depth, S, T, L):
    """(u, J) of one walker x (n, dim) by the kernel's column algorithm."""
    n, dim = x.shape
    sp_w, tp_w, (Wf, bf) = _unpack(p, depth, dim, S, T)
    k1, k2 = np.pi / L, 2 * np.pi / L
    eye = np.eye(n, dtype=bool)

    def feats(r, same):  # layer-0 features of pairs with separation r (..., dim)
        s1 = np.sin(k1 * r)
        dist = np.where(same, 0.0, np.sqrt((s1 ** 2).sum(-1)))
        safe = np.where(dist > 0, dist, 1.0)
        on = np.where(same, 0.0, 1.0)[..., None]
        return {"c2": np.cos(k2 * r), "s2": np.sin(k2 * r), "dist": dist,
                "a0": -on * k2 * np.sin(k2 * r), "a1": on * k2 * np.cos(k2 * r),
                "a2": on * k1 * s1 * np.cos(k1 * r) / safe[..., None]}

    def stream(f, k):
        """t_k (..., C) and A_k (..., dim, C) of the pairs, rebuilt from layer 0."""
        t = np.concatenate([f["c2"], f["s2"], f["dist"][..., None]], -1)
        A = np.zeros(t.shape[:-1] + (dim, 2 * dim + 1))
        for d in range(dim):
            A[..., d, d] = f["a0"][..., d]
            A[..., d, dim + d] = f["a1"][..., d]
            A[..., d, 2 * dim] = f["a2"][..., d]
        for m in range(k):
            W, b = tp_w[m]
            pre = t @ W + b
            tn, An = _softplus(pre), _sigmoid(pre)[..., None, :] * (A @ W)
            t, A = (tn, An) if m == 0 else (t + tn, A + An)
        return t, A

    # forward pass: per row, the mean of tp_k over j and the row sum of A_k
    fall = feats(x[:, None, :] - x[None, :, :], eye)
    sp = np.zeros((n, dim))
    sig, rowA = [], []
    for k in range(depth):
        t_k, A_k = stream(fall, k)
        tpm = t_k.mean(axis=1)
        rowA.append(A_k.sum(axis=1))  # sum_j A_k[l][j], (n, dim, C)
        W, b = sp_w[k]
        pre = np.concatenate([sp, np.broadcast_to(sp.mean(0), sp.shape), tpm], -1) @ W + b
        sig.append(_sigmoid(pre))
        sp = _softplus(pre) if k == 0 else sp + _softplus(pre)
    u = x + sp @ Wf + bf

    # the Jacobian, a column particle l at a time
    J = np.zeros((n * dim, n * dim))
    for l in range(n):
        f = feats(x - x[l], np.arange(n) == l)  # the pairs (i, l), all rows i
        jsp = np.zeros((n, dim, S))
        S_in = dim
        for k in range(depth):
            W = sp_w[k][0]
            W1, W2, W3 = W[:S_in], W[S_in:2 * S_in], W[2 * S_in:]
            acc = np.zeros((n, dim, S))  # Jsp is zero before layer 0
            if k > 0:
                acc += jsp.mean(axis=0) @ W2 + jsp @ W1
            acc[l] += rowA[k][l] @ W3 / n
            acc -= stream(f, k)[1] @ W3 / n
            jn = sig[k][:, None, :] * acc
            jsp = jn if k == 0 else jsp + jn
            S_in = S
        blk = np.einsum("ias,sb->iba", jsp, Wf)  # J[(i,b),(l,a)]
        blk[l] += np.eye(dim)
        J[:, l * dim:(l + 1) * dim] = blk.reshape(n * dim, dim)
    return u, J


def _packed64(flow):
    p = np.concatenate([q.detach().double().numpy().ravel()
                        for lin in [*flow.sp, *flow.tp, flow.final] for q in (lin.w, lin.b)])
    assert np.array_equal(p.astype(np.float32), cuda_flow_jac.pack_flow_params(flow).numpy())
    return p


@pytest.mark.parametrize("depth,dim,S,T,n", [(2, 2, 16, 16, 7), (3, 2, 6, 8, 5), (1, 3, 3, 5, 4)])
def test_column_model_matches_the_plain_version(depth, dim, S, T, n):
    _, _, flow = flow_pair(depth, S, T, n, dim)
    x = np.random.default_rng(n).uniform(0, box(n, dim), (3, n, dim))
    x[2, 1] = x[2, 0]  # coincident particles: the guarded zero distance
    with torch.no_grad():
        u_ref, J_ref = ferminet_apply_and_jac(flow, t(x))
    p = _packed64(flow)
    for b in range(3):
        u, J = column_model(p, x[b], depth, S, T, flow.cfg.L)
        np.testing.assert_allclose(u, u_ref[b].numpy(), atol=1e-12)
        np.testing.assert_allclose(J, J_ref[b].numpy(), atol=1e-12)


def test_column_model_matches_the_pallas_kernel_interpret():
    """n 7, depth 2 at the production widths, against the TPU kernel itself
    (interpret mode, f32): atol 1e-5, as in tests/test_flow_jac_pallas.py."""
    cfg, params, flow = flow_pair(2, 16, 16, 7, 2, dtype=np.float32, stddev=0.05)
    x = np.random.default_rng(3).uniform(0, box(7, 2), (4, 7, 2)).astype(np.float32)
    u_t, J_t = flow_u_jac_pallas(params, cfg, jnp.asarray(x), interpret=True)
    p = _packed64(flow)
    for b in range(4):
        u, J = column_model(p, x[b].astype(np.float64), 2, 16, 16, flow.cfg.L)
        np.testing.assert_allclose(u, np.asarray(u_t)[..., b], atol=1e-5)
        np.testing.assert_allclose(J, np.asarray(J_t)[..., b], atol=1e-5)
