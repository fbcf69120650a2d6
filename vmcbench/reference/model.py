"""The model of the reference: orbitals, the VAN, the flow, log Psi and its
coordinate derivatives, and the Ewald potential, in plain ``torch``.

Parameters are plain dictionaries ``{name: tensor}`` with the names of the
published parameter trees flattened with dots (``sp.0.w``,
``layers.1.attn.q.b``).  Every function takes a leading batch dimension.

log Psi_k(x) = log det[L^(-dim/2) exp(i k_j . z_i)] + 1/2 log|det dz/dx|,
z = flow(x).  Both log-dets are LU ``slogdet``s.  The flow's Jacobian and
coordinate Laplacian are propagated in closed form through the layers (the
flow is pair-local); the Slater part's gradient and Laplacian are closed
forms over one matrix inverse; the 1/2 log|det J| term is differentiated by
reverse-mode AD: its exact Laplacian in reverse passes over the coordinate
basis, or the Hutchinson estimate v^T H v with a probe handed in.
"""

from __future__ import annotations

import math
import pickle

import numpy as np
import torch

# ---- orbitals ------------------------------------------------------------------


def sp_orbitals(dim: int, Emax: int) -> np.ndarray:
    """Integer plane-wave indices with sum n^2 <= Emax, sorted by energy
    (numpy's default sort: its tie order fixes which state a token means)."""
    n_max = int(np.floor(np.sqrt(Emax)))
    rng = np.arange(-n_max, n_max + 1)
    grids = np.meshgrid(*([rng] * dim))
    indices = np.stack([g.ravel() for g in grids], axis=-1)
    Es = np.sum(indices**2, axis=-1)
    keep = Es <= Emax
    indices, Es = indices[keep], Es[keep]
    return indices[np.argsort(Es)]


def twisted_momenta(dim: int, Emax: int, twist) -> np.ndarray:
    """(M, dim) twisted indices n + theta, highest twisted energy first: the
    token table of the VAN and the momenta of the Slater matrix."""
    twisted = np.asarray(sp_orbitals(dim, Emax), dtype=float) + np.asarray(twist, dtype=float)
    order = np.argsort(np.sum(twisted**2, axis=-1))
    return twisted[order][::-1].copy()


def box(n: int, dim: int, Theta: float):
    """(L, beta) of the box holding n electrons at density rs = 1."""
    if dim == 2:
        return math.sqrt(math.pi * n), 1 / (4 * Theta)
    return (4 / 3 * math.pi * n) ** (1 / 3), 1 / ((4.5 * math.pi) ** (2 / 3) * Theta)


# ---- parameters -------------------------------------------------------------------


def flatten_tree(tree, prefix: str = "") -> dict:
    """Nested dicts and lists of arrays -> {"a.0.w": array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flatten_tree(v, "%s.%s" % (prefix, k) if prefix else str(k)))
    return out


def tree_order(named: dict) -> dict:
    """``named`` in the order of a parameter tree's leaves: dictionary keys
    sorted, list entries in order (the raveled order of the Fisher
    matrices)."""
    def key(name):
        return [(0, int(p), "") if p.isdigit() else (1, 0, p) for p in name.split(".")]
    return {k: named[k] for k in sorted(named, key=key)}


def load_van(path: str) -> dict:
    """The VAN's parameters from a pickled parameter tree of numpy arrays,
    in tree order."""
    with open(path, "rb") as f:
        return tree_order(flatten_tree(pickle.load(f)))


def flow_shapes(dim: int, depth: int, S: int, T: int) -> dict:
    """{name: shape} of the flow's parameters, in the order they are drawn."""
    shapes, sp_in, tp_in = {}, dim, 2 * dim + 1
    for i in range(depth):
        shapes["sp.%d.w" % i] = (2 * sp_in + tp_in, S)
        shapes["sp.%d.b" % i] = (S,)
        sp_in = S
        if i < depth - 1:
            shapes["tp.%d.w" % i] = (tp_in, T)
            shapes["tp.%d.b" % i] = (T,)
            tp_in = T
    shapes["final.w"] = (S, dim)
    shapes["final.b"] = (dim,)
    return shapes


# ---- the VAN ----------------------------------------------------------------------

_NEG = -1e30


def _lin(P, name, x):
    return x @ P[name + ".w"] + P[name + ".b"]


def van_logits(P: dict, tokens, layers: int, heads: int):
    """(B, n, M) logits of a causal transformer over token vectors (B, n,
    dim); row i depends on tokens < i only, row 0 is ``x1hat``."""
    B, n, _ = tokens.shape
    h = torch.tanh(_lin(P, "embed", tokens))
    D = h.shape[-1]
    hd = D // heads
    causal = torch.tril(torch.ones(n, n, dtype=torch.bool, device=tokens.device))
    for li in range(layers):
        pre = "layers.%d." % li
        q = _lin(P, pre + "attn.q", h).reshape(B, n, heads, hd)
        k = _lin(P, pre + "attn.k", h).reshape(B, n, heads, hd)
        v = _lin(P, pre + "attn.v", h).reshape(B, n, heads, hd)
        a = torch.einsum("bthd,bThd->bhtT", q, k) / math.sqrt(hd)
        a = torch.softmax(torch.where(causal, a, a.new_full((), _NEG)), dim=-1)
        h = h + _lin(P, pre + "attn.o", torch.einsum("bhtT,bThd->bthd", a, v).reshape(B, n, D))
        h = h + _lin(P, pre + "mlp.fc2", torch.tanh(_lin(P, pre + "mlp.fc1", h)))
    logits = _lin(P, "out", torch.tanh(h))
    first = P["x1hat"].expand(B, 1, -1)
    return torch.cat([first, logits[:, :-1]], dim=1)


def van_log_prob(P: dict, table, states, layers: int, heads: int):
    """log p of ordered occupation states (B, n): row i allows index m iff
    m > states[i - 1] and m <= M - n + i."""
    B, n = states.shape
    M = table.shape[0]
    logits = van_logits(P, table[states], layers, heads)
    m = torch.arange(M, device=states.device)
    band = m[None, :] <= (M - n + torch.arange(n, device=states.device))[:, None]
    prev = torch.cat([states.new_full((B, 1), -1), states[:, :-1]], dim=1)
    allowed = (m > prev[..., None]) & band
    logp = torch.log_softmax(torch.where(allowed, logits, logits.new_full((), _NEG)), dim=-1)
    return torch.gather(logp, -1, states[..., None])[..., 0].sum(dim=-1)


# ---- the flow -----------------------------------------------------------------------


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _features(sp, tp):
    return torch.cat([sp, sp.mean(dim=-2, keepdim=True).expand_as(sp), tp.mean(dim=-2)], dim=-1)


def _pair(x, L):
    """Pair features tp0 (..., n, n, C), their derivative in r_ij (..., n, n,
    dim, C) and half their coordinate Laplacian (..., n, n, C), the diagonal
    of the last two zeroed (r_ii is identically 0)."""
    n, dim = x.shape[-2:]
    k2, k1 = 2 * math.pi / L, math.pi / L
    r = x[..., :, None, :] - x[..., None, :, :]
    c2, s2 = torch.cos(k2 * r), torch.sin(k2 * r)
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    s1, c1 = torch.sin(k1 * r), torch.cos(k1 * r)
    d = ((s1 + eye[..., None]) ** 2).sum(dim=-1).sqrt() * (1.0 - eye)
    tp0 = torch.cat([c2, s2, d[..., None]], dim=-1)
    eye_d = torch.eye(dim, dtype=x.dtype, device=x.device)
    safe = torch.where(d > 0, d, torch.ones_like(d))[..., None]
    g = torch.cat([-k2 * s2[..., None, :] * eye_d, k2 * c2[..., None, :] * eye_d,
                   (k1 * s1 * c1 / safe)[..., None]], dim=-1)
    off = (1.0 - eye)
    d1, d2 = k1 * c1, -(k1**2) * s1
    h_d = ((d1**2 + s1 * d2) / safe - (s1 * d1) ** 2 / safe**3).sum(dim=-1)
    h = torch.cat([-(k2**2) * c2, -(k2**2) * s2, h_d[..., None]], dim=-1)
    return tp0, g * off[..., None, None], h * off[..., None]


def flow_apply(P: dict, x, depth: int, L: float):
    """z = flow(x), x (..., n, dim)."""
    sp = torch.zeros_like(x)
    tp = _pair(x, L)[0]
    for i in range(depth - 1):
        sp_new = _softplus(_lin(P, "sp.%d" % i, _features(sp, tp)))
        tp_new = _softplus(_lin(P, "tp.%d" % i, tp))
        sp = sp_new if i == 0 else sp + sp_new
        tp = tp_new if i == 0 else tp + tp_new
    sp = sp + _softplus(_lin(P, "sp.%d" % (depth - 1), _features(sp, tp)))
    return x + _lin(P, "final", sp)


def flow_jac(P: dict, x, depth: int, L: float, lap: bool = False):
    """(z, J (..., nd, nd)[, lap_z (..., nd)]): the flow, its coordinate
    Jacobian J[(i,b),(l,a)] = dz_ib / dx_la and, with ``lap``, its coordinate
    Laplacian, carried through the layers in closed form.  The pair stream's
    derivative is one block A_ij = d tp_ij / d x_i (d tp_ij / d x_j = -A_ij);
    the single-particle stream carries a dense Jsp (..., n, n, dim, S)."""
    n, dim = x.shape[-2:]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    tp, A, h = _pair(x, L)
    Ltp = 2.0 * h
    sp = torch.zeros_like(x)
    Jsp = x.new_zeros(*x.shape[:-2], n, n, dim, dim)
    Lsp = torch.zeros_like(x)

    def jf_w(Jsp, A, w, s_in):
        """(d features / dx) @ w, (..., n, n, dim, S')."""
        out = Jsp @ w[:s_in] + Jsp.mean(dim=-4, keepdim=True) @ w[s_in:2 * s_in]
        AW = A @ w[2 * s_in:]
        diag = eye[:, :, None, None] * AW.sum(dim=-3)[..., :, None, :, :]
        return out + (diag - AW) / n

    def sp_layer(name, sp, tp, Jsp, A, Lsp, Ltp):
        w = P[name + ".w"]
        pre = _lin(P, name, _features(sp, tp))
        sig = torch.sigmoid(pre)
        JfW = jf_w(Jsp, A, w, sp.shape[-1])
        Lnew = None
        if lap:
            Lnew = sig * (_features(Lsp, Ltp) @ w) + sig * (1 - sig) * (JfW**2).sum(dim=(-3, -2))
        return _softplus(pre), sig[..., :, None, None, :] * JfW, Lnew

    for i in range(depth - 1):
        sp_n, Jsp_n, Lsp_n = sp_layer("sp.%d" % i, sp, tp, Jsp, A, Lsp, Ltp)
        wt = P["tp.%d.w" % i]
        pre_t = _lin(P, "tp.%d" % i, tp)
        sig_t = torch.sigmoid(pre_t)
        AW = A @ wt
        A_n = sig_t[..., None, :] * AW
        Ltp_n = (sig_t * (Ltp @ wt) + sig_t * (1 - sig_t) * 2.0 * (AW**2).sum(dim=-2)
                 if lap else None)
        tp_n = _softplus(pre_t)
        if i == 0:
            sp, Jsp, Lsp, tp, A, Ltp = sp_n, Jsp_n, Lsp_n, tp_n, A_n, Ltp_n
        else:
            sp, Jsp, tp, A = sp + sp_n, Jsp + Jsp_n, tp + tp_n, A + A_n
            if lap:
                Lsp, Ltp = Lsp + Lsp_n, Ltp + Ltp_n
    sp_n, Jsp_n, Lsp_n = sp_layer("sp.%d" % (depth - 1), sp, tp, Jsp, A, Lsp, Ltp)
    sp, Jsp = sp + sp_n, Jsp + Jsp_n
    wf = P["final.w"]
    z = x + _lin(P, "final", sp)
    nd = n * dim
    J = torch.einsum("...ilas,sb->...ibla", Jsp, wf).reshape(*x.shape[:-2], nd, nd)
    J = J + torch.eye(nd, dtype=x.dtype, device=x.device)
    if not lap:
        return z, J
    return z, J, ((Lsp + Lsp_n) @ wf).reshape(*x.shape[:-2], nd)


# ---- log Psi ------------------------------------------------------------------------


def slater_matrix(k, z, L):
    """D_ij = L^(-dim/2) exp(i k_j . z_i), k the momenta 2 pi / L * indices."""
    dim = z.shape[-1]
    ang = z @ k.transpose(-1, -2)
    cdtype = torch.complex128 if z.dtype == torch.float64 else torch.complex64
    return (L ** (-dim / 2) * torch.complex(torch.cos(ang), torch.sin(ang))).to(cdtype)


def logpsi(P: dict, x, k, depth: int, L: float):
    """(B, 2) = [Re log Psi, Im log Psi], both log-dets by LU."""
    z, J = flow_jac(P, x, depth, L)
    sign, logabs = torch.linalg.slogdet(slater_matrix(k, z, L))
    return torch.stack([logabs + 0.5 * torch.linalg.slogdet(J)[1], torch.angle(sign)], dim=-1)


def slater_grad_lap(k, z, J, lap_z, L):
    """Gradient (B, n, dim) and Laplacian (B,) in x of log det D(z(x)),
    complex: with E^a = (D K_a) D^-1, d log D / dz_ia = i E^a_ii and
    d^2 / dz_ia dz_lb = -delta_il [(D K_a K_b) D^-1]_ii + E^a_il E^b_li,
    contracted with J J^T and the flow's Laplacian."""
    B, n, dim = z.shape
    D = slater_matrix(k, z, L)
    Minv = torch.linalg.inv(D)
    kc = k.to(D.dtype)
    E = (D[:, None] * kc.transpose(-1, -2)[:, :, None, :]) @ Minv[:, None]
    g = 1j * torch.diagonal(E, dim1=-2, dim2=-1).transpose(-1, -2)
    F = torch.einsum("zij,zacj->zaci", D * Minv.transpose(-1, -2),
                     torch.einsum("zja,zjc->zacj", kc, kc))
    gf = g.reshape(B, n * dim)
    grad = (J.to(D.dtype).transpose(-1, -2) @ gf[..., None])[..., 0].reshape(B, n, dim)
    C = (J @ J.transpose(-1, -2)).reshape(B, n, dim, n, dim).to(D.dtype)
    t2 = torch.einsum("zail,zcli,zialc->z", E, E, C)
    t1 = -(F * torch.einsum("ziaic->zaci", C)).sum(dim=(1, 2, 3))
    return grad, (lap_z.to(D.dtype) * gf).sum(dim=-1) + t1 + t2


def ljd_grad_lap(P: dict, x, depth: int, L: float, probe=None, columns: int = 4):
    """Gradient (B, n, dim) and Laplacian (B,) in x of 1/2 log|det J(x)|: the
    exact trace of its Hessian by reverse passes over the nd coordinate
    basis vectors, ``columns`` of them a batched pass, or with ``probe`` v
    (B, n, dim) the Hutchinson estimate v^T H v."""
    B, n, dim = x.shape
    nd = n * dim
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        f = 0.5 * torch.linalg.slogdet(flow_jac(P, xg, depth, L)[1])[1]
        (g,) = torch.autograd.grad(f.sum(), xg, create_graph=True)
        if probe is not None:
            (hv,) = torch.autograd.grad((g * probe).sum(), xg)
            return g.detach(), (hv * probe).sum(dim=(-2, -1))
        gf = g.reshape(B, nd)
        lap = x.new_zeros(B)
        eye = torch.eye(nd, dtype=x.dtype, device=x.device)
        for s in range(0, nd, columns):
            cols = eye[s:s + columns]
            c = cols.shape[0]
            (h,) = torch.autograd.grad(gf, xg, cols[:, None, :].expand(c, B, nd),
                                       retain_graph=s + c < nd, is_grads_batched=True)
            h = h.reshape(c, B, nd)
            lap = lap + h[torch.arange(c), :, torch.arange(s, s + c)].sum(dim=0)
    return g.detach(), lap


def grad_laplacian(P: dict, x, k, depth: int, L: float, probe=None, columns: int = 4):
    """Gradient (B, n, dim) and Laplacian (B,) of log Psi in x, complex."""
    with torch.no_grad():
        z, J, lap_z = flow_jac(P, x, depth, L, lap=True)
        g_s, l_s = slater_grad_lap(k, z, J, lap_z, L)
    g_j, l_j = ljd_grad_lap(P, x, depth, L, probe, columns)
    return g_s + g_j, l_s + l_j


# ---- the potential ------------------------------------------------------------------


def kpoints(dim: int, Gmax: int) -> np.ndarray:
    rng = np.arange(-Gmax, Gmax + 1)
    G = np.stack([g.ravel() for g in np.meshgrid(*([rng] * dim), indexing="ij")], axis=-1)
    G2 = np.sum(G**2, axis=-1)
    return G[(G2 <= Gmax**2) & (G2 > 0)]


def _kernel(dim, kappa, Gn):
    if dim == 3:
        return torch.exp(-(math.pi**2) * Gn**2 / kappa**2) / (math.pi * Gn**2), -math.pi / kappa**2
    return torch.special.erfc(math.pi * Gn / kappa) / Gn, -2 * math.sqrt(math.pi) / kappa


def madelung(dim: int, kappa, G) -> float:
    g_k, g_0 = _kernel(dim, kappa, torch.linalg.vector_norm(
        torch.as_tensor(G, dtype=torch.float64), dim=-1))
    return float(g_k.sum() + g_0 - 2 * kappa / math.sqrt(math.pi))


def potential(x, kappa, G, L, rs):
    """Coordinate-dependent Ewald energy (B,) in Ry / rs^2 of walkers in a
    box of size L: short range over the pairs' nearest images, long range by
    the structure factor."""
    u = x / L
    n, dim = u.shape[-2:]
    Gt = torch.as_tensor(G, dtype=u.dtype, device=u.device)
    r = u[..., :, None, :] - u[..., None, :, :]
    r = r - torch.round(r)
    iu = torch.triu(torch.ones(n, n, dtype=torch.bool, device=u.device), diagonal=1)
    d = torch.sqrt(torch.where(iu, (r**2).sum(dim=-1), torch.ones((), dtype=u.dtype,
                                                                   device=u.device)))
    short = torch.where(iu, torch.special.erfc(kappa * d) / d, torch.zeros_like(d)).sum(dim=(-2, -1))
    g_k, g_0 = _kernel(dim, kappa, torch.linalg.vector_norm(Gt, dim=-1))
    th = 2 * math.pi * (u @ Gt.T)
    S2 = torch.cos(th).sum(dim=-2) ** 2 + torch.sin(th).sum(dim=-2) ** 2
    long = (g_k * (S2 - n)).sum(dim=-1) / 2 + g_0 * (n * (n - 1) // 2)
    return 2 * rs / L * (short + long)
