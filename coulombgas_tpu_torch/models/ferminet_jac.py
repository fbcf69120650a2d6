"""Analytic coordinate Jacobian (and Laplacian) of the FermiNet flow.

Generic AD of J = d flow(x)/dx fans n*dim tangents through the whole network.
The flow's structure closes the Jacobian analytically:

  * the two-particle stream is PAIR-LOCAL through every layer
    (tp'_ij = tp_ij + softplus(tp_ij W)), so its derivative lives entirely in
    ONE (n, n, dim, C) block A_ij = d tp_ij / d x_i — the conjugate block is
    B_ij = d tp_ij / d x_j = -A_ij exactly, so it is never materialized;
  * only the mean-field terms (mean_i sp, mean_j tp) couple particles, and
    their derivatives are rank-structured:  d(mean_j tp_ij)/dx_l =
    (1/n)(delta_{il} sum_j A_ij + B_il);
  * the single-particle stream's dense Jacobian Jsp (n, n, dim, S) updates by
    one matmul per layer.

Counterpart of ``coulombgas_tpu/models/ferminet_jac.py`` with the batch
written out: x is ``(..., n, dim)``, J is ``(..., nd, nd)`` with rows (i, b)
and columns (l, a).  These are also the plain versions of the flow kernel in
``ops/cuda_flow_jac.py``; the depth-2 closed forms ``*_d2`` are the plain
versions of the closure kernels in ``ops/cuda_flow_d2.py``.
"""

from __future__ import annotations

import torch

from .ferminet import FermiNet, _sp_feature, softplus

__all__ = ["ferminet_apply_and_jac", "ferminet_apply_jac_lap",
           "ferminet_apply_and_jac_d2", "ferminet_apply_jac_lap_d2",
           "select_flow_jac"]


def select_flow_jac(flow_cfg, impl: str = "auto"):
    """Pick the flow fwd+Jacobian / fwd+Jac+Laplacian implementation pair.

    Returns ``(flow_jac, flow_jac_lap)`` of signature ``f(flow, x)``.
    ``"carried"`` is the layer-recursive form carrying the dense
    (n, n, dim, S) single-particle Jacobian state (any depth); ``"auto"``
    resolves to it.  ``"d2"`` is the depth-2 closed form that never builds
    that state (exact for ``flow_cfg.depth == 2`` only).
    """
    if impl == "auto":
        impl = "carried"
    if impl == "d2":
        if flow_cfg.depth != 2:
            raise ValueError("flow_jac 'd2' requires depth == 2 (got %d)" % flow_cfg.depth)
        return ferminet_apply_and_jac_d2, ferminet_apply_jac_lap_d2
    if impl == "carried":
        return ferminet_apply_and_jac, ferminet_apply_jac_lap
    raise ValueError("unknown flow_jac impl: %r" % (impl,))


def _pair_feature_grads(x, L):
    """d tp0_ij / d r_ij for the periodic pair features, plus tp0 itself.

    Returns (tp0 (..., n,n,C), g (..., n,n,dim,C)) with C = 2*dim+1 —
    derivative axis BEFORE the feature axis — and the diagonal (i == j) of g
    zeroed: r_ii is identically 0, so tp0_ii is constant in x.
    """
    n, dim = x.shape[-2:]
    k2, k1 = 2 * torch.pi / L, torch.pi / L
    rij = x[..., :, None, :] - x[..., None, :, :]
    c2, s2 = torch.cos(k2 * rij), torch.sin(k2 * rij)
    eye_n = torch.eye(n, dtype=x.dtype, device=x.device)
    s1 = torch.sin(k1 * rij)
    dij = ((s1 + eye_n[..., None]) ** 2).sum(dim=-1).sqrt() * (1.0 - eye_n)
    tp0 = torch.cat([c2, s2, dij[..., None]], dim=-1)

    eye_d = torch.eye(dim, dtype=x.dtype, device=x.device)
    g_cos = -k2 * s2[..., None, :] * eye_d
    g_sin = k2 * c2[..., None, :] * eye_d
    safe_d = torch.where(dij > 0, dij, torch.ones_like(dij))
    g_d = k1 * s1 * torch.cos(k1 * rij) / safe_d[..., None]
    g = torch.cat([g_cos, g_sin, g_d[..., None]], dim=-1)  # (..., n,n,dim,C)
    off = (1.0 - eye_n)[..., None, None]
    return tp0, g * off


def _pair_feature_lap(x, L):
    """Sum_a d^2 tp0_ij / d r_a^2 for the periodic pair features.

    The coordinate Laplacian of tp0 is 2x this.  Diagonal (i == j) zeroed.
    """
    n = x.shape[-2]
    k2, k1 = 2 * torch.pi / L, torch.pi / L
    rij = x[..., :, None, :] - x[..., None, :, :]
    h_cos = -(k2**2) * torch.cos(k2 * rij)
    h_sin = -(k2**2) * torch.sin(k2 * rij)
    eye_n = torch.eye(n, dtype=x.dtype, device=x.device)
    s, c = torch.sin(k1 * rij), torch.cos(k1 * rij)
    d = ((s + eye_n[..., None]) ** 2).sum(dim=-1).sqrt() * (1.0 - eye_n)
    safe_d = torch.where(d > 0, d, torch.ones_like(d))[..., None]
    # d = |s|: d''_a = (s'_a^2 + s_a s''_a)/d - (s_a s'_a)^2 / d^3
    sp_, spp = k1 * c, -(k1**2) * s
    h_d = ((sp_**2 + s * spp) / safe_d - (s * sp_) ** 2 / safe_d**3).sum(dim=-1)
    h = torch.cat([h_cos, h_sin, h_d[..., None]], dim=-1)  # (..., n, n, C)
    return h * (1.0 - eye_n)[..., None]


def _jfw(Jsp, A, w, spsize, eye_n, n):
    """(d f / d x) @ W without materializing the concatenated Jf.

    Jsp (..., n,n,dim,S): d sp_{i,s} / d x_{l,d} stored [i,l,d,s];
    A (..., n,n,dim,C) = d tp_ij / d x_i (the other pair block is -A).
    Returns (..., n,n,dim,S') = sum_q (d f_{i,q} / d x_{l,d}) W[q, :].
    """
    w1, w2, w3 = w[:spsize], w[spsize:2 * spsize], w[2 * spsize:]
    out = Jsp @ w1
    out = out + Jsp.mean(dim=-4, keepdim=True) @ w2  # broadcast over i
    # d(mean_j tp_ij)/dx_l = (1/n)(delta_il sum_j A + B_il) with B = -A
    AW = A @ w3
    diag = eye_n[:, :, None, None] * AW.sum(dim=-3)[..., :, None, :, :]
    return out + (diag - AW) / n


def _assemble_jac(Jsp, wf, n, dim):
    """J[(i,b),(l,a)] = delta_il delta_ab + sum_s Jsp[i,l,a,s] wf[s,b]."""
    J = torch.einsum("...ilas,sb->...ibla", Jsp, wf)
    nd = n * dim
    J = J.reshape(*J.shape[:-4], nd, nd)
    return J + torch.eye(nd, dtype=J.dtype, device=J.device)


def ferminet_apply_and_jac(flow: FermiNet, x):
    """Forward + analytic Jacobian: x (..., n, dim) -> (z, J (..., nd, nd)).

    J[mu, alpha] = d z_flat[mu] / d x_flat[alpha], equal (to roundoff) to
    generic AD of ``ferminet_apply`` but with pair-local propagation.
    """
    n, dim = x.shape[-2:]
    depth, L = flow.cfg.depth, flow.cfg.L
    eye_n = torch.eye(n, dtype=x.dtype, device=x.device)

    tp, A = _pair_feature_grads(x, L)
    sp = torch.zeros_like(x)
    Jsp = x.new_zeros(*x.shape[:-2], n, n, dim, dim)  # [i,l,d,s]

    def sp_step(layer, sp_in, tp_in, Jsp, A):
        pre = layer(_sp_feature(sp_in, tp_in))
        JfW = _jfw(Jsp, A, layer.w, sp_in.shape[-1], eye_n, n)
        Jact = torch.sigmoid(pre)[..., :, None, None, :] * JfW
        return softplus(pre), Jact

    for i in range(depth - 1):
        sp_new, Jsp_new = sp_step(flow.sp[i], sp, tp, Jsp, A)
        pre_tp = flow.tp[i](tp)
        A_new = torch.sigmoid(pre_tp)[..., None, :] * (A @ flow.tp[i].w)
        tp_new = softplus(pre_tp)
        if i == 0:  # the first layer replaces the streams
            sp, Jsp, tp, A = sp_new, Jsp_new, tp_new, A_new
        else:
            sp, Jsp = sp + sp_new, Jsp + Jsp_new
            tp, A = tp + tp_new, A + A_new

    sp_new, Jsp_new = sp_step(flow.sp[-1], sp, tp, Jsp, A)
    sp, Jsp = sp + sp_new, Jsp + Jsp_new

    z = x + flow.final(sp)
    return z, _assemble_jac(Jsp, flow.final.w, n, dim)


def ferminet_apply_jac_lap(flow: FermiNet, x):
    """Forward + analytic Jacobian + analytic coordinate Laplacian.

    Returns (z (..., n, dim), J (..., nd, nd), lap_z (..., nd)) with
    lap_z[mu] = sum_alpha d^2 z_flat[mu] / d x_flat[alpha]^2, propagated in
    closed form alongside the Jacobian state:

        softplus(pre):  L_out = sigmoid(pre) * (L_in W)
                              + sigmoid'(pre) * sum_{l,a} (d pre / d x_la)^2
    """
    n, dim = x.shape[-2:]
    depth, L = flow.cfg.depth, flow.cfg.L
    eye_n = torch.eye(n, dtype=x.dtype, device=x.device)

    tp, A = _pair_feature_grads(x, L)
    Ltp = 2.0 * _pair_feature_lap(x, L)  # (..., n, n, C)
    sp = torch.zeros_like(x)
    Jsp = x.new_zeros(*x.shape[:-2], n, n, dim, dim)
    Lsp = torch.zeros_like(x)

    def lap_of_f(Lsp, Ltp):
        return _sp_feature(Lsp, Ltp)

    def sp_step(layer, sp_in, tp_in, Jsp, A, Lf):
        pre = layer(_sp_feature(sp_in, tp_in))
        sig = torch.sigmoid(pre)
        JfW = _jfw(Jsp, A, layer.w, sp_in.shape[-1], eye_n, n)
        Jact = sig[..., :, None, None, :] * JfW
        Lact = sig * (Lf @ layer.w) + (sig * (1 - sig)) * (JfW**2).sum(dim=(-3, -2))
        return softplus(pre), Jact, Lact

    for i in range(depth - 1):
        Lf = lap_of_f(Lsp, Ltp)
        sp_new, Jsp_new, Lsp_new = sp_step(flow.sp[i], sp, tp, Jsp, A, Lf)

        w_tp = flow.tp[i].w
        pre_tp = flow.tp[i](tp)
        sig_tp = torch.sigmoid(pre_tp)
        AW = A @ w_tp  # BW = -AW, so (BW^2) = (AW^2)
        A_new = sig_tp[..., None, :] * AW
        Ltp_new = sig_tp * (Ltp @ w_tp) + (sig_tp * (1 - sig_tp)) * (
            2.0 * (AW**2).sum(dim=-2)
        )
        tp_new = softplus(pre_tp)

        if i == 0:
            sp, Jsp, Lsp = sp_new, Jsp_new, Lsp_new
            tp, A, Ltp = tp_new, A_new, Ltp_new
        else:
            sp, Jsp, Lsp = sp + sp_new, Jsp + Jsp_new, Lsp + Lsp_new
            tp, A, Ltp = tp + tp_new, A + A_new, Ltp + Ltp_new

    Lf = lap_of_f(Lsp, Ltp)
    sp_new, Jsp_new, Lsp_new = sp_step(flow.sp[-1], sp, tp, Jsp, A, Lf)
    sp, Jsp, Lsp = sp + sp_new, Jsp + Jsp_new, Lsp + Lsp_new

    z = x + flow.final(sp)
    J = _assemble_jac(Jsp, flow.final.w, n, dim)
    lap_z = Lsp @ flow.final.w  # x-term is linear
    return z, J, lap_z.reshape(*lap_z.shape[:-2], n * dim)


def _d2_closure(flow: FermiNet, x, with_lap: bool):
    """Depth-2 flow, Jacobian and (optionally) Laplacian in closed structured
    form — no carried (n, n, dim, S) state.

    After layer 0 the single-particle Jacobian is

        Jsp1_{il} = delta_il D_i + P_{il},   P_{il} = -(1/n) sig0_i * (A0_{il} W3_0)

    and the final layer only ever contracts it with weight matrices and
    row-wise sigmoid factors, so the coordinate Jacobian reduces to

        J_{il} = delta_il (I + D_i M_i - SumA1_i N_i)        [diagonal blocks]
               + A0_{il} K_i + A1_{il} N_i                   [pair terms]
               + G_l R_i                                     [rank-S mean term]

    with per-row matrices M_i, K_i, N_i, R_i and one (n, dim, S) mean
    accumulator G.  For the Laplacian the squared-first-derivative sums of the
    softplus chain rule decompose over the same blocks,

        JfW1_{il} = delta_il T_i + U_il + V_l

    (T diagonal, U pair-transient, V mean).
    """
    if flow.cfg.depth != 2:
        raise ValueError("the structured closure is specialized to depth 2 (got %d)"
                         % flow.cfg.depth)
    n, dim = x.shape[-2:]
    nd = n * dim
    L = flow.cfg.L

    tp0, A0 = _pair_feature_grads(x, L)  # (..., n,n,C0), (..., n,n,dim,C0)

    # ---- layer 0 (the sp stream enters as zeros of width dim) -----------------
    w3_0 = flow.sp[0].w[2 * dim:]  # the only block reached by non-zero features
    pre0 = tp0.mean(dim=-2) @ w3_0 + flow.sp[0].b  # (..., n, S)
    sig0 = torch.sigmoid(pre0)
    sp1 = softplus(pre0)
    AW0 = A0 @ w3_0                              # (..., n, n, dim, S) transient
    sumAW0 = AW0.sum(dim=-3)                     # (..., n, dim, S)
    D = sig0[..., :, None, :] * sumAW0 / n       # diagonal block of Jsp1

    # ---- pair-local tp layer ----------------------------------------------
    wt = flow.tp[0].w
    pre_tp = flow.tp[0](tp0)
    sigt = torch.sigmoid(pre_tp)
    tp1 = softplus(pre_tp)
    AWt = A0 @ wt
    A1 = sigt[..., None, :] * AWt                # (..., n, n, dim, C1)

    # ---- final sp layer ------------------------------------------------------
    S = sp1.shape[-1]
    w1f = flow.sp[1].w
    W1, W2, W3 = w1f[:S], w1f[S:2 * S], w1f[2 * S:]
    pre1 = flow.sp[1](_sp_feature(sp1, tp1))
    sig1 = torch.sigmoid(pre1)                   # (..., n, S')
    sp_fin = sp1 + softplus(pre1)
    wf = flow.final.w
    z = x + flow.final(sp_fin)

    # ---- per-row contraction matrices ------------------------------------
    M = wf + torch.einsum("st,...it,tb->...isb", W1, sig1, wf)       # (I + W1 diag(sig1)) wf
    K = -torch.einsum("cs,...is,...isb->...icb", w3_0, sig0, M) / n  # (..., n, C0, dim)
    N = -torch.einsum("ct,...it,tb->...icb", W3, sig1, wf) / n       # (..., n, C1, dim)
    R = torch.einsum("st,...it,tb->...isb", W2, sig1, wf) / n        # (..., n, S, dim)

    # ---- mean accumulator G_l = sum_k Jsp1_{kl} = D_l + sum_k P_{kl} ------
    SP = -torch.einsum("...klds,...ks->...lds", AW0, sig0) / n
    G = D + SP                                   # (..., n, dim, S)

    # ---- assemble J ---------------------------------------------------------
    sumA1 = A1.sum(dim=-3)
    Jblk = (torch.einsum("...ildc,...icb->...ibld", A0, K)
            + torch.einsum("...ildc,...icb->...ibld", A1, N)
            + torch.einsum("...lds,...isb->...ibld", G, R))
    diag = (torch.einsum("...ids,...isb->...ibd", D, M)
            - torch.einsum("...idc,...icb->...ibd", sumA1, N))
    eye_n = torch.eye(n, dtype=x.dtype, device=x.device)
    Jblk = Jblk + torch.einsum("il,...ibd->...ibld", eye_n, diag)
    J = Jblk.reshape(*x.shape[:-2], nd, nd) + torch.eye(nd, dtype=x.dtype, device=x.device)
    if not with_lap:
        return z, J

    # ---- Laplacian -----------------------------------------------------------
    Ltp0 = 2.0 * _pair_feature_lap(x, L)         # (..., n, n, C0)
    sq0 = ((sumAW0**2).sum(dim=-2) + (AW0**2).sum(dim=(-3, -2))) / n**2  # (..., n, S)
    Lsp1 = sig0 * (Ltp0.mean(dim=-2) @ w3_0) + sig0 * (1 - sig0) * sq0
    Ltp1 = sigt * (Ltp0 @ wt) + sigt * (1 - sigt) * (2.0 * (AWt**2).sum(dim=-2))

    T = D @ W1 + (sumA1 @ W3) / n                # (..., n, dim, S')
    # U_il = P_il W1 - (1/n) A1_il W3
    U = -((sig0[..., :, None, None, :] * AW0) @ W1 + A1 @ W3) / n
    V = (G @ W2) / n                             # indexed by l; V_i is its row i
    sq1 = (((T + V) ** 2 - V**2).sum(dim=-2)                       # diagonal l = i part
           + (U**2).sum(dim=(-3, -2))                              # pair part
           + 2.0 * torch.einsum("...ilds,...lds->...is", U, V)     # cross term
           + (V**2).sum(dim=(-3, -2))[..., None, :])               # sum_l V_l^2
    Lsp_fin = Lsp1 + sig1 * (_sp_feature(Lsp1, Ltp1) @ w1f) + sig1 * (1 - sig1) * sq1
    lap_z = Lsp_fin @ wf
    return z, J, lap_z.reshape(*lap_z.shape[:-2], nd)


def ferminet_apply_and_jac_d2(flow: FermiNet, x):
    """Depth-2 forward + Jacobian in closed form: x (..., n, dim) ->
    (z, J (..., nd, nd)).  Equal (to roundoff) to ``ferminet_apply_and_jac``."""
    return _d2_closure(flow, x, with_lap=False)


def ferminet_apply_jac_lap_d2(flow: FermiNet, x):
    """Depth-2 forward + Jacobian + coordinate Laplacian in closed form:
    (z, J (..., nd, nd), lap_z (..., nd)).  Equal (to roundoff) to
    ``ferminet_apply_jac_lap``."""
    return _d2_closure(flow, x, with_lap=True)
