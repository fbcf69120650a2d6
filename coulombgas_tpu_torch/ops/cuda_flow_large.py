"""Row-chunked depth-2 flow forward + Jacobian on the GPU — hand-written CUDA.

Counterpart of ``coulombgas_tpu/ops/pallas_flow_jac.py:flow_u_jac_pallas_large``.
Two kernels (``csrc/flow_large.cu``) split the flow by particle rows: the
first writes the layer-0 single-particle stream ``sp1 (B, n, S)`` and its
Jacobian ``Jsp1 (B, n, n, dim, S)``; the rows couple only through
``mean_i sp1`` and ``mean_i Jsp1``, which are reduced between the launches
(``torch.mean``, as the JAX package reduces them outside its kernels); the
second rebuilds the pair-local layer-1 two-particle stream from x and writes
u and J.  Depth 2 only.  Used by the Metropolis logp only; no gradient runs
through it, and an input that requires grad is refused.

Layout is batch-first: x ``(B, n, dim)`` -> u ``(B, n, dim)``,
J ``(B, nd, nd)`` with rows (i, b) and columns (l, a), identity included —
exactly what ``ops.cuda_fused_logp.fused_logp_cuda`` reads.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.ferminet import FermiNet, softplus
from ..models.ferminet_jac import _assemble_jac, _pair_feature_grads
from ._build import SMEM_LIMIT_BYTES, check_launch, load_library
from .cuda_flow_jac import pack_flow_params

__all__ = ["flow_u_jac_large_cuda", "flow_u_jac_large_ref", "flow_large_fits",
           "flow_large_smem_bytes", "launches"]

# Number of wrapper calls that launched the kernels (each call launches the
# layer-0 kernel and the final-layer kernel once).
launches = 0


def _check_depth(flow: FermiNet):
    if flow.cfg.depth != 2:  # a wrong Jacobian otherwise: raise, never assert
        raise ValueError("the row-chunked flow kernel supports depth-2 flows only, "
                         "got depth=%d" % flow.cfg.depth)


def flow_u_jac_large_ref(flow: FermiNet, x):
    """Plain PyTorch version of the kernels, in their two stages: layer 0 of
    every row, the two means over rows, then layer 1 and the head.  Same
    arguments and result as ``flow_u_jac_large_cuda``."""
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
    lib.cg_flow_large_layer0.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.cg_flow_large_layer0.restype = ctypes.c_int
    lib.cg_flow_large_final.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.cg_flow_large_final.restype = ctypes.c_int
    lib.cg_flow_large_smem.argtypes = [ctypes.c_int] * 4
    lib.cg_flow_large_param_count.argtypes = [ctypes.c_int] * 3
    return lib


def flow_large_smem_bytes(n: int, dim: int, S: int, C2: int) -> int:
    """Shared memory of one block as the built library states it, the larger
    of the two kernels' needs; -1 where dim is beyond the kernels (dim > 3)."""
    return _lib().cg_flow_large_smem(n, dim, S, C2)


def flow_large_fits(n: int, dim: int, S: int, C2: int, device=None) -> bool:
    """Whether the wrapper takes this size on ``device`` (default: CUDA).
    The kernels take dim <= 3, and their n ceiling is shared memory, which
    grows as n (the per-row state of the second kernel, about 4 (dim S +
    dim C2 + ...) floats a particle; 40 KB at n = 57, dim 2, widths 16);
    this asks the built library, so it needs ``nvcc``.  On a CPU device the
    wrapper takes its plain version, which takes any size."""
    if device is not None and torch.device(device).type == "cpu":
        return True
    return 0 <= flow_large_smem_bytes(n, dim, S, C2) <= SMEM_LIMIT_BYTES


def flow_u_jac_large_cuda(flow: FermiNet, x):
    """u (B, n, dim) and J (B, nd, nd) of a depth-2 flow for walkers x (B, n, dim).

    A CUDA tensor must be f32 and is handled by the kernels (or this raises);
    a CPU tensor goes through the plain version.
    """
    global launches
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
            "n = %d, dim = %d, spsize = %d, tpsize = %d is beyond the row-chunked flow "
            "kernel (shared memory %d of %d bytes; -1: dim > 3)" % (
                n, dim, S, T, flow_large_smem_bytes(n, dim, S, T), SMEM_LIMIT_BYTES))
    params = pack_flow_params(flow)
    if params.device != x.device:
        raise ValueError("flow parameters and x must lie on one device")
    lib = _lib()
    assert params.numel() == lib.cg_flow_large_param_count(dim, S, T)
    x = x.contiguous()
    nd = n * dim
    dev = x.device
    sp1 = torch.empty(B, n, S, dtype=torch.float32, device=dev)
    Jsp1 = torch.empty(B, n, n, dim, S, dtype=torch.float32, device=dev)
    u = torch.empty(B, n, dim, dtype=torch.float32, device=dev)
    J = torch.empty(B, nd, nd, dtype=torch.float32, device=dev)
    tail = (B, n, dim, S, T, float(cfg.L))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.cg_flow_large_layer0(x.data_ptr(), params.data_ptr(), sp1.data_ptr(),
                                        Jsp1.data_ptr(), *tail, stream)
        check_launch(code, "flow_u_jac_large (layer 0)")
        # the two reductions over rows that couple the particles in layer 1
        spmean = sp1.mean(dim=1).contiguous()
        jmean = Jsp1.mean(dim=1).contiguous()
        code = lib.cg_flow_large_final(x.data_ptr(), params.data_ptr(), sp1.data_ptr(),
                                       Jsp1.data_ptr(), spmean.data_ptr(), jmean.data_ptr(),
                                       u.data_ptr(), J.data_ptr(), *tail, stream)
    check_launch(code, "flow_u_jac_large (final layer)")
    launches += 1
    return u, J
