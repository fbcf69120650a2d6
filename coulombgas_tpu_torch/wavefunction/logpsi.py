"""Assembly of log Psi and its derivatives (gradient, Laplacian, scores).

log Psi_k(x) = log det[planewave_k(z)] + 1/2 log det(dz/dx),  z = flow(x).

Counterpart of ``coulombgas_tpu/wavefunction/logpsi.py``: ``make_logpsi``
(``jacfwd`` of the flow and ``slogdet``), ``make_logpsi_fast``,
``make_logphi_logjacdet``, the generic-AD engines of
``make_logpsi_grad_laplacian`` (exact, full Hutchinson, split Hutchinson with
an exact Slater part), ``make_logp`` and ``make_quantum_score``.  Complex
results are carried as real pairs (Re, Im) so that autograd stays real.

Every function is batched over walkers, and walker b's values depend on
x[b] alone.  The per-walker Jacobians of the flow come from
``torch.func.vmap(jacfwd(...))``; the coordinate derivatives of a batched
function are taken in reverse mode through the batch sum, whose gradient is
the per-walker gradient (``coordinate_derivatives``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.convert import ravel_named, ravel_order
from ..models.per_sample import per_sample_jacobian
from ..models.slater import logslaterdet
from ..ops.logdet import logdet_spd_single

__all__ = [
    "make_logpsi",
    "make_logpsi_fast",
    "make_logphi_logjacdet",
    "make_logpsi_grad_laplacian",
    "make_logp",
    "make_quantum_score",
    "coordinate_derivatives",
    "columns_per_pass",
    "draw_probe",
    "flow_jacobian",
    "momenta_table",
    "to_complex",
]

# Basis vectors a batched pass takes, on every device: the exact Laplacian's
# reverse passes (``coordinate_derivatives``) and the flow's forward-over-forward
# fan-out (``fast_laplacian.flow_laplacian``).  A pass's transients grow with it
# and with the batch (1.9 GiB a vector for the analytic log|det J| term at
# n 29 / B 2048 on the H100); at 4 a pass that term took 4 % less time than at
# 1 and within 1.5 % of 8, for 11.6 GiB against 6.0 and 19.1
# (scripts/probe_exact_laplacian_torch.py).
COLUMNS_PER_PASS = 4


def columns_per_pass(total: int, forloop: bool = False) -> int:
    """Basis vectors per batched pass over ``total`` of them: one with
    ``forloop`` (least memory), else ``COLUMNS_PER_PASS``."""
    return 1 if forloop else max(1, min(total, COLUMNS_PER_PASS))


def flow_jacobian(flow_apply, flow, x):
    """(u (B, n, dim), J (B, nd, nd)) of ``flow_apply(flow, x)`` by forward
    mode, one ``jacfwd`` per walker; J[b, mu, alpha] = d u_mu / d x_alpha."""
    B, n, dim = x.shape

    def flat(xf):
        return flow_apply(flow, xf.reshape(n, dim)).reshape(-1)

    J = torch.func.vmap(torch.func.jacfwd(flat))(x.reshape(B, n * dim))
    return flow_apply(flow, x), J


def momenta_table(sp_indices):
    """``table(x)``: the (M, dim) array ``sp_indices`` as a tensor of x's
    dtype on x's device, made once per device and dtype, so that a call
    copies nothing from the host (a CUDA graph may hold it).  It is made
    outside any ``torch.func`` transform the call sits in (the scores'
    ``vmap(jacrev(...))``), so the cached tensor is a plain one."""
    sp_indices = np.asarray(sp_indices)
    tables = {}

    def table(x):
        if (x.device, x.dtype) not in tables:
            with torch._C._DisableFuncTorch():
                tables[x.device, x.dtype] = torch.as_tensor(sp_indices, dtype=x.dtype,
                                                            device=x.device)
        return tables[x.device, x.dtype]

    return table


def make_logpsi(flow_apply, sp_indices, L):
    """logpsi(x (B, n, dim), flow, state_idx (B, n)) -> (B, 2) =
    [Re log Psi, Im log Psi], with the flow Jacobian by ``jacfwd`` and
    log|det J| by an LU ``slogdet``: the generic form, no kernel.

    ``flow_apply(flow, x)`` is the normalizing flow; ``sp_indices`` the
    (M, dim) array of twisted momenta indexed by ``state_idx``.
    """
    table = momenta_table(sp_indices)

    def logpsi(x, flow, state_idx):
        z, J = flow_jacobian(flow_apply, flow, x)
        log_phi = logslaterdet(table(x)[state_idx], z, L)
        logjacdet = torch.linalg.slogdet(J)[1]
        return torch.stack([log_phi[..., 0] + 0.5 * logjacdet, log_phi[..., 1]], dim=-1)

    return logpsi


def make_logpsi_fast(flow_jac, sp_indices, L):
    """logpsi via the analytic flow Jacobian + differentiable Gram log-det.

    ``logpsi(x (B, n, dim), flow, state_idx (B, n)) -> (B, 2)`` =
    [Re log Psi, Im log Psi].  ``flow_jac(flow, x) -> (z, J (B, nd, nd))`` is
    the pair-local analytic Jacobian (models/ferminet_jac.py), and the
    1/2 log|det J| term is 1/4 log det(J J^T) through the pivot-free Cholesky
    with closed-form derivatives (ops/logdet.py).
    """
    table = momenta_table(sp_indices)

    def logpsi(x, flow, state_idx):
        z, J = flow_jac(flow, x)
        log_phi = logslaterdet(table(x)[state_idx], z, L)
        logjacdet = 0.5 * logdet_spd_single(J @ J.transpose(-1, -2))  # log|det J|
        return torch.stack([log_phi[..., 0] + 0.5 * logjacdet, log_phi[..., 1]], dim=-1)

    return logpsi


def make_logphi_logjacdet(flow_apply, sp_indices, L):
    """Split form of ``make_logpsi``: ``logphi(x, flow, state_idx) -> (B, 2)``,
    the Slater term, and ``logjacdet(x, flow) -> (B,)``, 1/2 log|det J|."""
    table = momenta_table(sp_indices)

    def logphi(x, flow, state_idx):
        return logslaterdet(table(x)[state_idx], flow_apply(flow, x), L)

    def logjacdet(x, flow):
        return 0.5 * torch.linalg.slogdet(flow_jacobian(flow_apply, flow, x)[1])[1]

    return logphi, logjacdet


def to_complex(pair):
    """(…, 2) real pair [Re, Im] -> complex."""
    return torch.complex(pair[..., 0], pair[..., 1])


def coordinate_derivatives(f, x, forloop: bool = False, probe=None):
    """Per-walker gradient and Laplacian in x of a batched real function.

    ``f(x (B, n, dim)) -> (B, C)``, row b depending on x[b] only.  Returns
    (grad (B, C, n, dim), lap (B, C)) without an autograd graph.  The
    Laplacian is the trace of each component's Hessian, in batched reverse
    passes over the C nd basis vectors, ``columns_per_pass`` of them a pass
    (one with ``forloop``).  With ``probe`` v (B, n, dim) it is the Hutchinson
    estimate v^T H v instead, one Hessian-vector product a component.

    The walkers are independent, so the gradient of the batch sum is the
    per-walker gradient, and so is the gradient of the batch sum of a
    component of it: both derivative orders are reverse passes, and they nest
    over the closed-form rules of ``ops.logdet`` without chaining through the
    elimination steps.  Grad mode is switched on whatever the caller's: under
    an outer ``no_grad`` PyTorch's backward of ``slogdet`` takes a branch that
    is not differentiable again.
    """
    B, n, dim = x.shape
    nd = n * dim
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        out = f(xg)
        C = out.shape[-1]
        g = torch.stack([torch.autograd.grad(out[:, c].sum(), xg, create_graph=True)[0]
                         for c in range(C)], dim=1)  # (B, C, n, dim)
        if probe is not None:
            hv = torch.stack([torch.autograd.grad((g[:, c] * probe).sum(), xg,
                                                  retain_graph=c < C - 1)[0]
                              for c in range(C)], dim=1)
            lap = (hv * probe[:, None]).sum(dim=(-2, -1))
            return g.detach(), lap
        gf = g.reshape(B, C * nd)
        lap = x.new_zeros(B, C * nd)  # the diagonal, component-major
        k = columns_per_pass(C * nd, forloop)
        eye = torch.eye(C * nd, dtype=x.dtype, device=x.device)
        for s in range(0, C * nd, k):
            cols = eye[s:s + k]  # (k, C nd)
            (h,) = torch.autograd.grad(gf, xg, cols[:, None, :].expand(-1, B, -1),
                                       retain_graph=s + k < C * nd, is_grads_batched=True)
            j = torch.arange(s, s + cols.shape[0], device=x.device)
            lap[:, s:s + cols.shape[0]] = h.reshape(-1, B, nd)[
                torch.arange(cols.shape[0], device=x.device), :, j % nd].T
    return g.detach(), lap.reshape(B, C, nd).sum(dim=-1)


def draw_probe(x, generator, v):
    """The Hutchinson probe: ``v`` if handed in, else a standard normal draw
    of x's shape from ``generator`` on x's device."""
    if v is None:
        v = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
    return v


def make_logpsi_grad_laplacian(logpsi, forloop: bool = False, hutchinson: bool = False,
                               logphi=None, logjacdet=None):
    """The generic-AD (grad, laplacian) engine of log Psi.

    ``logpsi(x, flow, state_idx) -> (B, 2)``, e.g. from ``make_logpsi`` or
    ``make_logpsi_fast``.  Returns ``fn(x, flow, state_indices,
    generator=None, v=None) -> (grad (B, n, dim) complex, laplacian (B,)
    complex)`` without an autograd graph.

    ``forloop`` takes the Hessian columns one at a time (least memory); the
    default takes ``columns_per_pass`` of them a batched pass.
    With ``hutchinson`` the Laplacian is the stochastic v^T H v estimate,
    the probe ``v`` (B, n, dim) drawn from ``generator`` on x's device
    unless handed in; given ``logphi(x, flow, state_idx) -> (B, 2)`` and
    ``logjacdet(x, flow) -> (B,)`` (``make_logphi_logjacdet``), only the
    Jacobian term is estimated and the Slater term's Laplacian is exact.
    """
    split = logphi is not None or logjacdet is not None

    def pair(g, lap):
        return torch.complex(g[:, 0], g[:, 1]), torch.complex(lap[:, 0], lap[:, 1])

    def grad_laplacian(x, flow, state_indices, generator=None, v=None):
        psi = lambda q: logpsi(q, flow, state_indices)  # noqa: E731
        if not hutchinson:
            return pair(*coordinate_derivatives(psi, x, forloop))
        v = draw_probe(x, generator, v)
        if not split:
            return pair(*coordinate_derivatives(psi, x, probe=v))
        g_phi, lap_phi = pair(*coordinate_derivatives(
            lambda q: logphi(q, flow, state_indices), x, forloop))
        g_ljd, lap_ljd = coordinate_derivatives(lambda q: logjacdet(q, flow)[:, None], x, probe=v)
        return g_phi + g_ljd[:, 0], lap_phi + lap_ljd[:, 0]

    return grad_laplacian


def make_logp(logpsi):
    """Coordinate density ``logp(x, flow, state_idx) -> (B,)`` = 2 Re log Psi,
    without a graph."""

    @torch.no_grad()
    def logp(x, flow, state_idx):
        return 2 * logpsi(x, flow, state_idx)[..., 0]

    return logp


def make_quantum_score(logpsi):
    """Per-sample d log Psi / d flow-params (complex), for the quantum Fisher.

    Returns ``score(x (B, n, dim), flow, state_idx (B, n)) -> S_q (B, P_flow)``
    complex, ``d Re log Psi + i d Im log Psi``, raveled in the JAX package's
    parameter order (``io.convert.ravel_order``)."""

    def quantum_score(x, flow, state_idx):
        jac = per_sample_jacobian(lambda f, xx, si: logpsi(xx, f, si), flow, x, state_idx)
        pair = ravel_named(jac, ravel_order(flow), batch_dims=2)  # (B, 2, P)
        return torch.complex(pair[:, 0], pair[:, 1])

    return quantum_score
