"""Fast MCMC coordinate density: logp = 2 Re log Psi without slogdet.

The Metropolis loop evaluates logp for the full walker batch at every sweep
and needs no derivatives there:

    2 Re log Psi = 2 Re log det D(u) + log |det J|
                 = log det (D^H D)   + 1/2 log det (J^T J)
      with u = flow(x), J = d flow / dx, D_ij = L^(-dim/2) e^{i k_j . u_i}.

Counterpart of ``coulombgas_tpu/wavefunction/fast_logp.py`` with the same
routes:

  1. the flow kernel (``ops.cuda_flow_jac``) feeding the fused tail kernel
     (``ops.cuda_fused_logp``) back to back — the main path; with
     ``use_d2_flow`` the flow comes from the depth-2 closure kernel
     (``ops.cuda_flow_d2``) instead, and with ``use_large_flow`` from the
     row-chunked depth-2 kernels (``ops.cuda_flow_large``), again straight
     into the fused tail (the closure kernel wins when both are asked for);
  2. the plain analytic flow Jacobian feeding the fused tail kernel;
  3. the plain flow Jacobian, Gram matrices by torch, and the stacked
     log-dets through ``ops.logdet.chol_logdet`` (the third kernel, or its
     plain elimination beyond the kernel's shared memory).

Left to the closure (``use_fused`` and ``use_flow_kernel`` None), the route
is chosen by size, once per shape and device, from the kernels' own answers
as the reference chooses from ``fused_fits`` and ``MAX_FLOW_N``: the fused
tail where ``fused_fits``, the flow kernel where it also ``flow_jac_fits``
(the flow kernel feeds the fused tail only).  An explicit ``True`` is a
request: the kernel launches or the call raises.  On CUDA tensors a kernel
launches or raises; on CPU tensors every wrapper takes its plain version,
which takes any size, so the same closure serves the CPU tests.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.ferminet import FermiNet
from ..models.ferminet_jac import ferminet_apply_and_jac
from ..ops import cuda_flow_d2, cuda_flow_jac, cuda_flow_large, cuda_fused_logp
from ..ops.cuda_flow_d2 import flow_u_jac_d2_cuda
from ..ops.cuda_flow_jac import flow_u_jac_cuda
from ..ops.cuda_flow_large import flow_u_jac_large_cuda
from ..ops.cuda_fused_logp import fused_logp_cuda
from ..ops.logdet import chol_logdet, gram_logabsdet, planewave_gram_embed

__all__ = ["make_logp_fast", "choose_route"]


def choose_route(n: int, dim: int, cfg, device, use_fused=None, use_flow_kernel=None):
    """``(flow_kernel, fused, why)`` for walkers (., n, dim) on ``device``:
    whether the flow kernel and the fused tail run, and why a kernel left to
    the closure does not.  ``None`` leaves a choice to the kernels' sizes; a
    kernel requested with ``True`` (the flow kernel requests the fused tail
    too) raises ``ValueError`` where it does not take the size."""
    size = "n %d, dim %d, widths %d/%d" % (n, dim, cfg.spsize, cfg.tpsize)
    fused = use_fused if use_fused is not None else (True if use_flow_kernel else None)
    why = ""
    if fused is not False:
        fits = cuda_fused_logp.fused_fits(n, dim, device)
        if fused and not fits:
            raise ValueError("fused_logp requested, but %s is beyond the kernel" % size)
        if not fits:
            why = "nd %d beyond the fused_logp kernel" % (n * dim)
        fused = fits
    kernel = use_flow_kernel
    if kernel is not False and fused:
        fits = cuda_flow_jac.flow_jac_fits(n, dim, cfg, device)
        if kernel and not fits:
            raise ValueError("the flow kernel was requested, but %s (depth %d) is beyond "
                             "it" % (size, cfg.depth))
        if not fits:
            why = "%s beyond the flow kernel" % size
        kernel = fits
    return bool(kernel), fused, why


def make_logp_fast(
    sp_indices,
    L: float,
    chunk: int | None = None,
    jacobian=None,
    use_fused: bool | None = None,
    use_flow_kernel: bool | None = None,
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
    else stands in for it.  ``use_fused`` and ``use_flow_kernel`` left at
    None are chosen by size (``choose_route``); ``logp.route(n, dim, cfg,
    device)`` names the route the closure takes there.  ``logp.graph_safe``
    is True: the sample step may capture the closure in a CUDA graph
    (``train.train.sample_graph_blocker``).
    """
    if use_d2_flow and use_fused is False:
        raise ValueError("use_d2_flow requires use_fused")
    if use_large_flow and use_fused is False:
        raise ValueError("use_large_flow requires use_fused")
    if use_flow_kernel and use_fused is False:
        raise ValueError("use_flow_kernel requires use_fused")
    sp_indices = np.asarray(sp_indices)
    jacobian = jacobian or ferminet_apply_and_jac

    tables = {}  # the momenta 2 pi / L * sp_indices, once per device and dtype
    routes = {}  # (flow kernel, fused tail, why) per shape, flow and device

    def route_of(n, dim, cfg, device):
        key = (n, dim, cfg, torch.device(device))
        if key not in routes:
            routes[key] = choose_route(n, dim, cfg, device, use_fused, use_flow_kernel)
        return routes[key]

    def route(n, dim, cfg, device) -> str:
        """The route this closure takes for walkers (., n, dim) on ``device``."""
        if use_d2_flow or use_large_flow:
            head = "depth-2 closure kernel" if use_d2_flow else "row-chunked flow kernels"
            return head + " + fused_logp"
        kernel, fused, why = route_of(n, dim, cfg, device)
        name = "%s + %s" % ("flow kernel" if kernel else "analytic flow Jacobian",
                            "fused_logp" if fused else "stacked chol_logdet")
        return name + (" (%s)" % why if why else "")

    def logp_impl(x, flow: FermiNet, state_indices):
        B, n, dim = x.shape
        nd = n * dim
        if (x.device, x.dtype) not in tables:
            tables[x.device, x.dtype] = 2 * np.pi / L * torch.as_tensor(
                sp_indices, dtype=x.dtype, device=x.device)
        k = tables[x.device, x.dtype][state_indices]
        cfg = flow.cfg
        if use_d2_flow:  # a request: the kernel takes the size or this raises
            if not cuda_flow_d2.flow_d2_fits(n, dim, cfg, device=x.device):
                raise ValueError("use_d2_flow: the depth-2 closure kernel does not take "
                                 "depth %d, n %d, dim %d, widths %d/%d" % (
                                     cfg.depth, n, dim, cfg.spsize, cfg.tpsize))
            u, J = flow_u_jac_d2_cuda(flow, x)
            return fused_logp_cuda(u, k, J, L)
        if use_large_flow:
            if not cuda_flow_large.flow_large_fits(n, dim, cfg.spsize, cfg.tpsize, x.device):
                raise ValueError("use_large_flow: the row-chunked kernels do not take n %d, "
                                 "dim %d, widths %d/%d" % (n, dim, cfg.spsize, cfg.tpsize))
            u, J = flow_u_jac_large_cuda(flow, x)  # raises for depth != 2
            return fused_logp_cuda(u, k, J, L)
        flow_kernel, fused, _ = route_of(n, dim, cfg, x.device)
        if flow_kernel:
            u, J = flow_u_jac_cuda(flow, x)
            return fused_logp_cuda(u, k, J, L)
        u, J = jacobian(flow, x)
        if fused:
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

    logp.route = route
    # every route launches on the current stream and reads nothing back to
    # the host once its tables and route are cached: a CUDA graph may hold it
    logp.graph_safe = True
    return logp
