"""Depth-2 flow forward + Jacobian in its carried form on the GPU — hand-written CUDA.

Counterpart of ``coulombgas_tpu/ops/pallas_flow_jac.py:flow_u_jac_pallas_large``
(K4).  One launch of ``csrc/flow_large.cu`` per call: a block per walker
whose warps take the particle rows, the two means over rows that couple them
(``mean_i sp1`` and ``mean_i Jsp1``) reduced in shared memory between the
block's phases, and layer 0's Jacobian ``Jsp1`` rebuilt per pair in
registers from the pair features where layer 1 uses it, so that nothing but
x, the weights, u and J touches device memory.  The kernel reads the flow's
weights from their own tensors (f32, contiguous, on x's device).  Depth 2
only, n <= 64.  Used by the Metropolis logp only; no gradient runs through
it, and an input that requires grad is refused.

Layout is batch-first: x ``(B, n, dim)`` -> u ``(B, n, dim)``,
J ``(B, nd, nd)`` with rows (i, b) and columns (l, a), identity included —
exactly what ``ops.cuda_fused_logp.fused_logp_cuda`` reads.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.ferminet import FermiNet, softplus
from ..models.ferminet_jac import _assemble_jac, _pair_feature_grads
from . import counters
from ._build import SMEM_LIMIT_BYTES, check_launch, load_library

__all__ = ["flow_u_jac_large_cuda", "flow_u_jac_large_ref", "flow_large_fits",
           "flow_large_smem_bytes"]


def _check_depth(flow: FermiNet):
    if flow.cfg.depth != 2:  # a wrong Jacobian otherwise: raise, never assert
        raise ValueError("the row-chunked flow kernel supports depth-2 flows only, "
                         "got depth=%d" % flow.cfg.depth)


def flow_u_jac_large_ref(flow: FermiNet, x):
    """Plain PyTorch version of the kernel, in the TPU kernels' two stages:
    layer 0 of every row, the two means over rows, then layer 1 and the
    head.  Same arguments and result as ``flow_u_jac_large_cuda``."""
    _check_depth(flow)
    n, dim = x.shape[-2:]
    S = flow.cfg.spsize
    eye = torch.eye(n, dtype=x.dtype, device=x.device)[:, :, None, None]
    tp0, A0 = _pair_feature_grads(x, flow.cfg.L)           # (B,n,n,C0), (B,n,n,dim,C0)

    # ---- layer 0: sp and mean sp are zero, only the tp-mean rows of sp_w[0] act
    w30, b0 = flow.sp[0].w[2 * dim:], flow.sp[0].b
    pre = tp0.mean(dim=-2) @ w30 + b0                      # (B,n,S)
    sp1 = softplus(pre)
    AW = A0 @ w30                                          # (B,n,n,dim,S)
    Jsp1 = torch.sigmoid(pre)[:, :, None, None, :] * (eye * AW.sum(dim=2, keepdim=True) - AW) / n
    pre_tp = tp0 @ flow.tp[0].w + flow.tp[0].b             # (B,n,n,T)
    tp1 = softplus(pre_tp)
    A1 = torch.sigmoid(pre_tp)[..., None, :] * (A0 @ flow.tp[0].w)

    # ---- the cross-row coupling of layer 1
    spmean = sp1.mean(dim=1, keepdim=True)                 # (B,1,S)
    jmean = Jsp1.mean(dim=1, keepdim=True)                 # (B,1,n,dim,S)

    # ---- layer 1 (residual) and the head
    w1, b1 = flow.sp[1].w, flow.sp[1].b
    w1a, w1b, w1c = w1[:S], w1[S:2 * S], w1[2 * S:]
    pre = sp1 @ w1a + spmean @ w1b + tp1.mean(dim=2) @ w1c + b1
    sp = sp1 + softplus(pre)
    AW1 = A1 @ w1c
    JfW = Jsp1 @ w1a + jmean @ w1b + (eye * AW1.sum(dim=2, keepdim=True) - AW1) / n
    Jsp = Jsp1 + torch.sigmoid(pre)[:, :, None, None, :] * JfW
    u = x + sp @ flow.final.w + flow.final.b
    return u, _assemble_jac(Jsp, flow.final.w, n, dim)


def _lib():
    lib = load_library("flow_large")
    lib.cg_flow_large.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.cg_flow_large.restype = ctypes.c_int
    lib.cg_flow_large_smem.argtypes = [ctypes.c_int] * 4
    return lib


def flow_large_smem_bytes(n: int, dim: int, S: int, C2: int) -> int:
    """Shared memory of one block as the built library states it; -1 where
    the size is beyond the kernel (n > 64, dim > 3, a width > 32)."""
    return _lib().cg_flow_large_smem(n, dim, S, C2)


def flow_large_fits(n: int, dim: int, S: int, C2: int, device=None) -> bool:
    """Whether the wrapper takes this size on ``device`` (default: CUDA).
    The kernel takes n <= 64 (a lane owns at most two pairs of a row),
    dim <= 3 and widths <= 32; its shared memory grows as n (about
    (3 + 3 dim) S floats a particle, 36 KB at n = 57, dim 2, widths 16).
    This asks the built library, so it needs ``nvcc``.  On a CPU device the
    wrapper takes its plain version, which takes any size."""
    if device is not None and torch.device(device).type == "cpu":
        return True
    return 0 <= flow_large_smem_bytes(n, dim, S, C2) <= SMEM_LIMIT_BYTES


def _weights(flow: FermiNet, x):
    """The eight weight tensors in the kernel's order, as the kernel reads
    them: f32, contiguous, on x's device."""
    ws = []
    for lin in (flow.sp[0], flow.sp[1], flow.tp[0], flow.final):
        ws += [lin.w, lin.b]
    for w in ws:
        if w.dtype != torch.float32 or not w.is_contiguous() or w.device != x.device:
            raise ValueError("the kernel reads the flow's weights in place: they must be "
                             "contiguous float32 on x's device, got %s %s on %s" % (
                                 w.dtype, tuple(w.stride()), w.device))
    return ws


def flow_u_jac_large_cuda(flow: FermiNet, x):
    """u (B, n, dim) and J (B, nd, nd) of a depth-2 flow for walkers x (B, n, dim).

    A CUDA tensor must be f32 and is handled by the kernel in one launch (or
    this raises); a CPU tensor goes through the plain version.
    """
    if x.ndim != 3:
        raise ValueError("expected x (B, n, dim), got %s" % (tuple(x.shape),))
    if x.requires_grad:
        raise ValueError("flow_u_jac_large has no backward; call it under no_grad on a "
                         "tensor that does not require grad")
    _check_depth(flow)
    if not x.is_cuda:
        with torch.no_grad():
            return flow_u_jac_large_ref(flow, x)
    if x.dtype != torch.float32:
        raise TypeError("the CUDA kernel takes float32, got %s" % x.dtype)
    B, n, dim = x.shape
    cfg = flow.cfg
    S, T = cfg.spsize, cfg.tpsize
    if dim != flow.dim:
        raise ValueError("flow built for dim %d, x has dim %d" % (flow.dim, dim))
    if not flow_large_fits(n, dim, S, T):
        raise ValueError(
            "n = %d, dim = %d, spsize = %d, tpsize = %d is beyond the flow kernel K4 "
            "(n <= 64, dim <= 3, widths <= 32; shared memory %d of %d bytes, -1: beyond)" % (
                n, dim, S, T, flow_large_smem_bytes(n, dim, S, T), SMEM_LIMIT_BYTES))
    ws = _weights(flow, x)
    x = x.contiguous()
    nd = n * dim
    u = torch.empty(B, n, dim, dtype=torch.float32, device=x.device)
    J = torch.empty(B, nd, nd, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = _lib().cg_flow_large(x.data_ptr(), *(w.data_ptr() for w in ws), u.data_ptr(),
                                    J.data_ptr(), B, n, dim, S, T, float(cfg.L),
                                    torch.cuda.current_stream().cuda_stream)
    check_launch(code, "flow_u_jac_large")
    counters.launched("flow_u_jac_large")
    return u, J
