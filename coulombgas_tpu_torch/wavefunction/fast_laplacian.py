"""Analytic gradient/Laplacian of the Slater part of log Psi.

Because the plane-wave Slater matrix D_ij = c e^{i k_j . u_i} has row-local
derivatives (dD/du_{i,a} only touches row i), both derivative orders of
log det D in u close analytically over ONE matrix inverse:

    E^a   = (D ∘ K_a) D^{-1}                      (dim complex matmuls)
    d log phi / du_{i,a}        = i E^a_{ii}
    d^2 log phi / du_{ia} du_{lb} = -delta_{il} F^{ab}_{ii} + E^a_{il} E^b_{li}
    with F^{ab}_{ii} = [(D ∘ K_a K_b) D^{-1}]_{ii}

(K_a broadcasts k_{j,a} over rows).  Chain rule through the flow u(x):

    lap_x log phi = sum_mu (lap_x u)_mu g_mu + sum_{mu nu} C_{mu nu} H_{mu nu},
    C = J J^T,  J = du/dx,

where J and the flow coordinate Laplacian cost only flow forwards (no
determinants).  No parameter gradient is required through this path (the loss
differentiates log psi only; E_loc enters as a constant), so the Slater part
is plain linear algebra, not AD.

Counterpart of ``coulombgas_tpu/wavefunction/fast_laplacian.py``, with the
batch written out.  The 1/2 log|det J| term is differentiated by reverse-mode
AD (``logpsi.coordinate_derivatives``): the Hutchinson estimate, or the exact
trace of its Hessian in batched passes over the coordinate basis or one column
at a time.
"""

from __future__ import annotations

import torch

from ..config import complex_dtype
from ..models.slater import planewave_matrix
from ..ops.logdet import logdet_spd_single
from .logpsi import (columns_per_pass, coordinate_derivatives, draw_probe, flow_jacobian,
                     momenta_table)

__all__ = ["make_logpsi_grad_laplacian_analytic", "flow_laplacian", "SINGULAR"]

# linalg.inv's refusal of a singular Slater matrix, kept as a device assert
SINGULAR = "linalg.inv: a Slater matrix is singular"


def flow_laplacian(flow_apply, flow, x):
    """The flow's coordinate Laplacian lap_u (B, nd), sum_alpha
    d^2 u_mu / dx_alpha^2, by a forward-over-forward pass per basis vector
    (the reference's ``dir_second`` fan-out), ``logpsi.columns_per_pass``
    basis vectors a batched pass."""
    B, n, dim = x.shape
    nd = n * dim
    eye = torch.eye(nd, dtype=x.dtype, device=x.device)

    def flat(xf):
        return flow_apply(flow, xf.reshape(n, dim)).reshape(-1)

    def one(xf):
        def dir_second(e):
            first = lambda q: torch.func.jvp(flat, (q,), (e,))[1]  # noqa: E731
            return torch.func.jvp(first, (xf,), (e,))[1]

        return torch.func.vmap(dir_second, chunk_size=columns_per_pass(nd))(eye).sum(dim=0)

    return torch.func.vmap(one)(x.reshape(B, nd))


def make_logpsi_grad_laplacian_analytic(sp_indices, L, flow_jac_lap=None,
                                        hutchinson: bool = True, flow_jac=None,
                                        flow_jac_lap_batched=None, forloop: bool = False,
                                        flow_apply=None):
    """Batched (grad, laplacian) of log Psi with the analytic Slater part.

    ``flow_jac_lap(flow, x) -> (u, J (B, nd, nd), lap_u (B, nd))`` supplies
    the analytic flow Jacobian and coordinate Laplacian.  The 1/2 log|det J|
    term is the differentiable Gram-Cholesky 1/4 log det(J J^T): exact
    gradient, and the Hutchinson v^T H v estimate of its Laplacian, or with
    ``hutchinson=False`` the exact trace of its Hessian — in batched passes
    over the nd basis vectors, ``logpsi.columns_per_pass`` a pass, or with
    ``forloop`` one column at a time.  That term is
    differentiated twice and needs J alone: ``flow_jac(flow, x) -> (u, J)``,
    when given, spares it the Laplacian's propagation (default: the first two
    results of ``flow_jac_lap``).  ``flow_jac_lap_batched(flow, x) -> (u, J,
    lap_u)``, when given, replaces the primal flow evaluation of the Slater
    part — the slot consumed outside autograd — by one call for the whole
    batch (the depth-2 closure kernel, ``ops.cuda_flow_d2``); the log|det J|
    term keeps the differentiable ``flow_jac``.

    With neither ``flow_jac_lap`` nor ``flow_jac``, ``flow_apply(flow, x)``
    alone is differentiated: J by ``jacfwd``, lap_u by the forward-over-forward
    fan-out (``flow_laplacian``), and log|det J| by ``jacfwd`` and ``slogdet``.

    Returns ``fn(x, flow, state_indices, generator=None, v=None) ->
    (grad (B, n, dim) complex, laplacian (B,) complex)``.  The Hutchinson
    probe ``v`` (B, n, dim) is drawn from ``generator`` on x's device unless
    handed in.  The results carry no autograd graph.  ``fn.graph_safe``: on
    the Hutchinson route with the analytic flow Jacobian (``flow_jac`` or
    ``flow_jac_lap``) and no batched kernel, every launch is on the current
    stream and nothing is read back to the host, so the SR accumulate may
    capture the call in a CUDA graph (``train.train.accumulate_graph_blocker``).
    """
    table = momenta_table(sp_indices)
    if flow_jac is None and flow_jac_lap is not None:
        flow_jac = lambda flow, x: flow_jac_lap(flow, x)[:2]  # noqa: E731
    if flow_jac is None and flow_apply is None:
        raise ValueError("make_logpsi_grad_laplacian_analytic needs flow_jac_lap, flow_jac "
                         "or flow_apply")

    def primal(flow, x):
        if flow_jac_lap_batched is not None:
            return flow_jac_lap_batched(flow, x)
        if flow_jac_lap is not None:
            return flow_jac_lap(flow, x)
        # forward mode alone, under the caller's no_grad: with grad mode on,
        # the fan-out would also record a graph to the flow's parameters
        u, J = (flow_jac or (lambda f, q: flow_jacobian(flow_apply, f, q)))(flow, x)
        return u, J, flow_laplacian(flow_apply, flow, x)

    def logjacdet(flow, x):
        """1/2 log|det J| (B, 1)."""
        if flow_jac is not None:
            _, J = flow_jac(flow, x)
            return 0.25 * logdet_spd_single(J @ J.transpose(-1, -2))[:, None]
        return 0.5 * torch.linalg.slogdet(flow_jacobian(flow_apply, flow, x)[1])[1][:, None]

    @torch.no_grad()
    def slater_part(x, flow, state_indices):
        B, n, dim = x.shape
        cdtype = complex_dtype(x.dtype)
        k = 2 * torch.pi / L * table(x)[state_indices]  # (B, n, dim)
        u, J, lap_u = primal(flow, x)

        D = planewave_matrix(k, u, L)
        # LU inverse on purpose: the Gram form squares cond(D) and loses all
        # f32 digits on near-node walkers.  linalg.inv's check of a singular
        # matrix as a device assert: no host read
        M, info = torch.linalg.inv_ex(D)
        torch._assert_async((info == 0).all(), SINGULAR)
        kc = k.to(cdtype)
        # E^a = (D * k_{j,a}) M, stacked over a: (B, dim, n, n)
        DK = D[:, None, :, :] * kc.transpose(-1, -2)[:, :, None, :]
        E = DK @ M[:, None]
        g = 1j * torch.diagonal(E, dim1=-2, dim2=-1).transpose(-1, -2)  # (B, n, dim)
        # F^{ab}_{ii} = sum_j D_ij k_ja k_jb M_ji -> (B, dim, dim, n)
        DMt = D * M.transpose(-1, -2)
        kk = torch.einsum("zja,zjc->zacj", kc, kc)
        Fdiag = torch.einsum("zij,zacj->zaci", DMt, kk)

        g_flat = g.reshape(B, n * dim)
        Jc = J.to(cdtype)
        grad_logphi = (Jc.transpose(-1, -2) @ g_flat[..., None])[..., 0].reshape(B, n, dim)

        # Hessian contraction with C = J J^T
        C = (J @ J.transpose(-1, -2)).reshape(B, n, dim, n, dim)
        Cc = C.to(cdtype)
        term2 = torch.einsum("zail,zcli,zialc->z", E, E, Cc)
        Cdiag = torch.einsum("ziaic->zaci", Cc)
        term1 = -(Fdiag * Cdiag).sum(dim=(1, 2, 3))
        lap_logphi = (lap_u.to(cdtype) * g_flat).sum(dim=-1) + term1 + term2
        return grad_logphi, lap_logphi

    def logpsi_grad_laplacian(x, flow, state_indices, generator=None, v=None):
        grad_logphi, lap_logphi = slater_part(x, flow, state_indices)
        probe = draw_probe(x, generator, v) if hutchinson else None
        grad_ljd, lap_ljd = coordinate_derivatives(
            lambda q: logjacdet(flow, q), x, forloop, probe=probe)
        return grad_logphi + grad_ljd[:, 0], lap_logphi + lap_ljd[:, 0]

    logpsi_grad_laplacian.graph_safe = (hutchinson and flow_jac is not None
                                        and flow_jac_lap_batched is None)
    return logpsi_grad_laplacian
