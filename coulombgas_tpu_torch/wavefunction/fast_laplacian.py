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

Counterpart of ``coulombgas_tpu/wavefunction/fast_laplacian.py`` for the
``flow_jac_lap`` + Hutchinson configuration, with the batch written out.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import complex_dtype
from ..models.slater import planewave_matrix
from ..ops.logdet import logdet_spd_single

__all__ = ["make_logpsi_grad_laplacian_analytic"]


def make_logpsi_grad_laplacian_analytic(sp_indices, L, flow_jac_lap,
                                        hutchinson: bool = True, flow_jac=None,
                                        flow_jac_lap_batched=None):
    """Batched (grad, laplacian) of log Psi with the analytic Slater part.

    ``flow_jac_lap(flow, x) -> (u, J (B, nd, nd), lap_u (B, nd))`` supplies
    the analytic flow Jacobian and coordinate Laplacian.  The 1/2 log|det J|
    term is the differentiable Gram-Cholesky 1/4 log det(J J^T): exact
    gradient, Hutchinson v^T H v estimate of its Laplacian (the exact column
    loop, ``hutchinson=False``, is not ported yet).  That term is
    differentiated twice and needs J alone: ``flow_jac(flow, x) -> (u, J)``,
    when given, spares it the Laplacian's propagation (default: the first two
    results of ``flow_jac_lap``).  ``flow_jac_lap_batched(flow, x) -> (u, J,
    lap_u)``, when given, replaces the primal flow evaluation of the Slater
    part — the slot consumed outside autograd — by one call for the whole
    batch (the depth-2 closure kernel, ``ops.cuda_flow_d2``); the Hutchinson
    term keeps the differentiable ``flow_jac``.

    Returns ``fn(x, flow, state_indices, generator=None, v=None) ->
    (grad (B, n, dim) complex, laplacian (B,) complex)``.  The Hutchinson
    probe ``v`` (B, n, dim) is drawn from ``generator`` on x's device unless
    handed in.  The results carry no autograd graph.
    """
    if not hutchinson:
        raise NotImplementedError(
            "hutchinson=False (exact Laplacian of log|det J|) is not ported yet")
    sp_indices = np.asarray(sp_indices)
    if flow_jac is None:
        flow_jac = lambda flow, x: flow_jac_lap(flow, x)[:2]  # noqa: E731
    primal = flow_jac_lap_batched or flow_jac_lap

    @torch.no_grad()
    def slater_part(x, flow, state_indices):
        B, n, dim = x.shape
        cdtype = complex_dtype(x.dtype)
        table = torch.as_tensor(sp_indices, dtype=x.dtype, device=x.device)
        k = 2 * torch.pi / L * table[state_indices]  # (B, n, dim)
        u, J, lap_u = primal(flow, x)

        D = planewave_matrix(k, u, L)
        # LU inverse on purpose: the Gram form squares cond(D) and loses all
        # f32 digits on near-node walkers.
        M = torch.linalg.inv(D)
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

    def logjacdet_part(x, flow, v):
        """Gradient of 1/2 log|det J| and v^T (Hessian) v, by two reverse
        passes: the walkers are independent, so the gradient of the batch sum
        is the per-walker gradient, and so is the gradient of sum(grad * v)."""
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            _, J = flow_jac(flow, xg)
            ljd = 0.25 * logdet_spd_single(J @ J.transpose(-1, -2))
            (grad,) = torch.autograd.grad(ljd.sum(), xg, create_graph=True)
            (hvp,) = torch.autograd.grad((grad * v).sum(), xg)
        return grad.detach(), (hvp * v).sum(dim=(-2, -1))

    def logpsi_grad_laplacian(x, flow, state_indices, generator=None, v=None):
        if v is None:
            v = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
        grad_logphi, lap_logphi = slater_part(x, flow, state_indices)
        grad_ljd, lap_ljd = logjacdet_part(x, flow, v)
        return grad_logphi + grad_ljd, lap_logphi + lap_ljd

    return logpsi_grad_laplacian
