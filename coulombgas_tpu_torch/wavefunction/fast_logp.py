"""Fast MCMC coordinate density: logp = 2 Re log Psi without slogdet.

The Metropolis loop evaluates logp for the full walker batch at every sweep
and needs no derivatives there:

    2 Re log Psi = 2 Re log det D(u) + log |det J|
                 = log det (D^H D)   + 1/2 log det (J^T J)
      with u = flow(x), J = d flow / dx, D_ij = L^(-dim/2) e^{i k_j . u_i}.

Counterpart of ``coulombgas_tpu/wavefunction/fast_logp.py`` with the same
routes:

  1. ``use_flow_kernel`` and ``use_fused``: the flow kernel
     (``ops.cuda_flow_jac``) feeding the fused tail kernel
     (``ops.cuda_fused_logp``) back to back — the main path;
     with ``use_d2_flow`` the flow comes from the depth-2 closure kernel
     (``ops.cuda_flow_d2``) instead, and with ``use_large_flow`` from the
     row-chunked depth-2 kernels (``ops.cuda_flow_large``), again straight
     into the fused tail (the closure kernel wins when both are asked for);
  2. ``use_fused`` only: the plain analytic flow Jacobian feeding the fused
     tail kernel;
  3. neither: the plain flow Jacobian, Gram matrices by torch, and the
     stacked log-dets through ``ops.logdet.chol_logdet`` (the third kernel).

On CUDA tensors a requested kernel launches or raises; on CPU tensors every
wrapper takes its plain version, so the same closure serves the CPU tests.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.ferminet import FermiNet
from ..models.ferminet_jac import ferminet_apply_and_jac
from ..ops.cuda_flow_d2 import flow_u_jac_d2_cuda
from ..ops.cuda_flow_jac import flow_u_jac_cuda
from ..ops.cuda_flow_large import flow_u_jac_large_cuda
from ..ops.cuda_fused_logp import fused_logp_cuda
from ..ops.logdet import chol_logdet, gram_logabsdet, planewave_gram_embed

__all__ = ["make_logp_fast"]


def make_logp_fast(
    sp_indices,
    L: float,
    chunk: int | None = None,
    jacobian=None,
    use_fused: bool = True,
    use_flow_kernel: bool = True,
    use_large_flow: bool = False,
    use_d2_flow: bool = False,
):
    """Batched ``logp(x, flow, state_indices) -> (batch,)`` = 2 Re log Psi.

    ``sp_indices`` is the (M, dim) array of twisted momenta.
    ``jacobian(flow, x) -> (u, J (B, nd, nd))`` supplies the flow value and
    coordinate Jacobian on the routes without the flow kernel; it defaults to
    the analytic ``ferminet_apply_and_jac``.  ``chunk`` processes the batch in
    pieces of that many walkers.  No gradient is recorded.

    ``use_d2_flow`` asks for the depth-2 closure kernel, ``use_large_flow``
    for the row-chunked depth-2 kernels; with both, the closure kernel runs,
    as in the JAX package.  Either needs ``use_fused`` and a depth-2 flow
    within the kernel's shared-memory budget; otherwise the call raises
    ``ValueError`` — a requested kernel launches or the call fails, nothing
    else stands in for it.
    """
    if use_d2_flow and not use_fused:
        raise ValueError("use_d2_flow requires use_fused")
    if use_large_flow and not use_fused:
        raise ValueError("use_large_flow requires use_fused")
    if use_flow_kernel and not use_fused:
        raise ValueError("use_flow_kernel requires use_fused")
    sp_indices = np.asarray(sp_indices)
    jacobian = jacobian or ferminet_apply_and_jac

    tables = {}  # the momenta 2 pi / L * sp_indices, once per device and dtype

    def logp_impl(x, flow: FermiNet, state_indices):
        B, n, dim = x.shape
        nd = n * dim
        if (x.device, x.dtype) not in tables:
            tables[x.device, x.dtype] = 2 * np.pi / L * torch.as_tensor(
                sp_indices, dtype=x.dtype, device=x.device)
        k = tables[x.device, x.dtype][state_indices]
        if use_d2_flow:
            # raises for depth != 2 or a size beyond the kernel's budget
            u, J = flow_u_jac_d2_cuda(flow, x)
            return fused_logp_cuda(u, k, J, L)
        if use_large_flow:
            u, J = flow_u_jac_large_cuda(flow, x)  # raises as the closure kernel does
            return fused_logp_cuda(u, k, J, L)
        if use_flow_kernel:
            u, J = flow_u_jac_cuda(flow, x)
            return fused_logp_cuda(u, k, J, L)
        u, J = jacobian(flow, x)
        if use_fused:
            return fused_logp_cuda(u, k, J, L)
        ang = torch.einsum("bnd,bmd->bnm", u, k)
        c = L ** (-dim / 2)
        embed = planewave_gram_embed(c * torch.cos(ang), c * torch.sin(ang))
        if 2 * n == nd:
            # dim=2: the flow-Jacobian Gram has the same size — one call.
            gram_J = torch.einsum("bij,bkj->bik", J, J)
            ld = chol_logdet(torch.cat([embed, gram_J], dim=0))
            return 0.5 * ld[:B] + 0.5 * ld[B:]
        return 0.5 * chol_logdet(embed) + gram_logabsdet(J)

    @torch.no_grad()
    def logp(x, flow, state_indices):
        B = x.shape[0]
        if chunk is None or B <= chunk:
            return logp_impl(x, flow, state_indices)
        if B % chunk:
            raise ValueError("batch %d is not a multiple of chunk %d" % (B, chunk))
        return torch.cat([
            logp_impl(x[s:s + chunk], flow, state_indices[s:s + chunk])
            for s in range(0, B, chunk)
        ])

    return logp
