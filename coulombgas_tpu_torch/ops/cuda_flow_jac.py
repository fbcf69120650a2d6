"""FermiNet flow forward + analytic Jacobian on the GPU — hand-written CUDA.

Counterpart of ``coulombgas_tpu/ops/pallas_flow_jac.py:flow_u_jac_pallas``.
One kernel (``csrc/flow_jac.cu``), one launch per call: a block per walker
runs the forward pass into shared memory, then each of its warps carries one
column particle's part of the Jacobian, ``Jsp[:, l]``, through the layers in
registers.  Used by the Metropolis logp only; no gradient runs through it.

Layout is batch-first: x ``(B, n, dim)`` -> u ``(B, n, dim)``,
J ``(B, nd, nd)`` with rows (i, b) and columns (l, a) — exactly what
``ops.cuda_fused_logp.fused_logp_cuda`` reads.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.ferminet import FermiNet
from ..models.ferminet_jac import ferminet_apply_and_jac
from . import counters
from ._build import SMEM_LIMIT_BYTES, check_launch, load_library

__all__ = ["flow_u_jac_cuda", "flow_u_jac_plain", "flow_jac_fits",
           "flow_jac_smem_bytes", "pack_flow_params"]


def flow_u_jac_plain(flow: FermiNet, x):
    """Plain PyTorch version of the kernel: same arguments, same result."""
    return ferminet_apply_and_jac(flow, x)


def flow_jac_smem_bytes(n: int, dim: int, cfg) -> int:
    """Shared memory of one block as the built library states it; -1 where
    n, dim or a width is beyond the kernel."""
    return _lib().cg_flow_smem(n, dim, cfg.depth, cfg.spsize, cfg.tpsize)


def flow_jac_fits(n: int, dim: int, cfg, device=None) -> bool:
    """Whether the wrapper takes this size on ``device`` (default: CUDA).
    The kernel takes n <= 64 (a lane of a warp owns two rows), dim <= 3,
    widths <= 32; this asks the built library, so it needs ``nvcc``.  On a
    CPU device the wrapper takes its plain version, which takes any size."""
    if device is not None and torch.device(device).type == "cpu":
        return True
    return 0 <= flow_jac_smem_bytes(n, dim, cfg) <= SMEM_LIMIT_BYTES


def pack_flow_params(flow: FermiNet):
    """All weights in one flat f32 tensor, in the order the kernels read them:
    (sp_w, sp_b) per layer, (tp_w, tp_b) per layer, final_w, final_b."""
    parts = []
    for lin in [*flow.sp, *flow.tp, flow.final]:
        parts += [lin.w.detach().reshape(-1), lin.b.detach().reshape(-1)]
    return torch.cat(parts).to(torch.float32).contiguous()


def _lib():
    lib = load_library("flow_jac")
    lib.cg_flow_u_jac.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.cg_flow_u_jac.restype = ctypes.c_int
    lib.cg_flow_smem.argtypes = [ctypes.c_int] * 5
    lib.cg_flow_param_count.argtypes = [ctypes.c_int] * 4
    return lib


def flow_u_jac_cuda(flow: FermiNet, x):
    """u (B, n, dim) and J (B, nd, nd) for walkers x (B, n, dim).

    A CUDA tensor must be f32 and is handled by the kernel (or this raises);
    a CPU tensor goes through the plain version.
    """
    if x.ndim != 3:
        raise ValueError("expected x (B, n, dim), got %s" % (tuple(x.shape),))
    if not x.is_cuda:
        with torch.no_grad():
            return flow_u_jac_plain(flow, x)
    if x.dtype != torch.float32:
        raise TypeError("the CUDA kernel takes float32, got %s" % x.dtype)
    B, n, dim = x.shape
    cfg = flow.cfg
    if dim != flow.dim:
        raise ValueError("flow built for dim %d, x has dim %d" % (flow.dim, dim))
    if not flow_jac_fits(n, dim, cfg):
        raise ValueError(
            "n = %d, dim = %d, spsize = %d, tpsize = %d is beyond the flow "
            "kernel (shared memory %d of %d bytes; -1: n > 64, a width > 32 or "
            "dim > 3)" % (
                n, dim, cfg.spsize, cfg.tpsize,
                flow_jac_smem_bytes(n, dim, cfg), SMEM_LIMIT_BYTES))
    params = pack_flow_params(flow)
    if params.device != x.device:
        raise ValueError("flow parameters and x must lie on one device")
    assert params.numel() == _lib().cg_flow_param_count(
        cfg.depth, dim, cfg.spsize, cfg.tpsize)
    x = x.contiguous()
    nd = n * dim
    u = torch.empty(B, n, dim, dtype=torch.float32, device=x.device)
    J = torch.empty(B, nd, nd, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = _lib().cg_flow_u_jac(
            x.data_ptr(), params.data_ptr(), u.data_ptr(), J.data_ptr(), B, n, dim,
            cfg.depth, cfg.spsize, cfg.tpsize, float(cfg.L),
            torch.cuda.current_stream().cuda_stream)
    check_launch(code, "flow_u_jac")
    counters.launched("flow_u_jac")
    return u, J
