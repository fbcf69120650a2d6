"""Depth-2 closure flow kernels on the GPU — hand-written CUDA.

Counterparts of ``coulombgas_tpu/ops/pallas_flow_jac.py:flow_u_jac_pallas_d2``
and ``flow_u_jac_lap_pallas_d2``.  One source (``csrc/flow_d2.cu``) and one
kernel body, assembling u, J from the closed form of
``models.ferminet_jac.ferminet_apply_and_jac_d2`` — no carried
``(n, n, dim, S)`` Jacobian state.  Depth 2 only.  K5 (u, J) and K6 (u, J
and the flow's coordinate Laplacian) are its two instantiations: a block per
walker, a warp per particle row, whose lanes hold the row's
pairs in registers, so shared memory grows as n (n <= 64, widths <= 32,
dim <= 3).  K6 adds, per pair, the Laplacian of the pair features and the
pair's part U[i][l] of the final layer's squared first derivatives, a
(dim x S) product summed over the row in registers; it does about twice K5's
work a pair, bound by operations.

Both are called outside autograd (the Metropolis logp, and the primal slot of
the kinetic-energy engine), so neither has a backward: an input that requires
grad is refused.

Layout is batch-first: x ``(B, n, dim)`` -> u ``(B, n, dim)``,
J ``(B, nd, nd)`` with rows (i, b) and columns (l, a), identity included,
lap ``(B, nd)`` — what ``ops.cuda_fused_logp.fused_logp_cuda`` and
``wavefunction.fast_laplacian`` read.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..models.ferminet import FermiNet
from ..models.ferminet_jac import ferminet_apply_and_jac_d2, ferminet_apply_jac_lap_d2
from . import counters
from ._build import SMEM_LIMIT_BYTES, check_launch, load_library
from .cuda_flow_jac import pack_flow_params

__all__ = ["flow_u_jac_d2_cuda", "flow_u_jac_lap_d2_cuda", "flow_u_jac_d2_plain",
           "flow_u_jac_lap_d2_plain", "flow_d2_fits", "flow_d2_smem_bytes"]


def flow_u_jac_d2_plain(flow: FermiNet, x):
    """Plain PyTorch version of ``flow_u_jac_d2_cuda``: same arguments and result."""
    return ferminet_apply_and_jac_d2(flow, x)


def flow_u_jac_lap_d2_plain(flow: FermiNet, x):
    """Plain PyTorch version of ``flow_u_jac_lap_d2_cuda``."""
    return ferminet_apply_jac_lap_d2(flow, x)


@functools.cache
def _lib():
    lib = load_library("flow_d2")
    lib.cg_flow_d2_u_jac.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.cg_flow_d2_u_jac.restype = ctypes.c_int
    lib.cg_flow_d2_u_jac_lap.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.cg_flow_d2_u_jac_lap.restype = ctypes.c_int
    lib.cg_flow_d2_smem.argtypes = [ctypes.c_int] * 5
    lib.cg_flow_d2_param_count.argtypes = [ctypes.c_int] * 3
    return lib


def flow_d2_smem_bytes(n: int, dim: int, cfg, lap: bool = False) -> int:
    """Shared memory of one block of K5 (``lap`` False) or K6 as the built
    library states it; -1 where n > 64, dim > 3 or a width > 32."""
    return _lib().cg_flow_d2_smem(n, dim, cfg.spsize, cfg.tpsize, int(lap))


def flow_d2_fits(n: int, dim: int, cfg, lap: bool = False, device=None) -> bool:
    """Whether the wrapper takes this size on ``device`` (default: CUDA):
    depth 2 always; for the kernels, K5 and K6 (``lap``) alike, also n <= 64
    (a lane owns at most two pairs of a row), widths <= 32 and dim <= 3.
    This asks the built library, so it needs ``nvcc``.  On a CPU device the
    wrapper takes its plain version, which takes any size."""
    if cfg.depth != 2:
        return False
    if device is not None and torch.device(device).type == "cpu":
        return True
    return 0 <= flow_d2_smem_bytes(n, dim, cfg, lap) <= SMEM_LIMIT_BYTES


def _launch(flow: FermiNet, x, lap: bool):
    name = "flow_u_jac_lap_d2" if lap else "flow_u_jac_d2"
    if x.ndim != 3:
        raise ValueError("expected x (B, n, dim), got %s" % (tuple(x.shape),))
    if x.requires_grad:
        raise ValueError("%s has no backward; call it under no_grad on a tensor "
                         "that does not require grad" % name)
    cfg = flow.cfg
    if cfg.depth != 2:
        raise ValueError("the depth-2 closure kernel needs depth == 2 (got %d)" % cfg.depth)
    if not x.is_cuda:
        with torch.no_grad():
            return (flow_u_jac_lap_d2_plain if lap else flow_u_jac_d2_plain)(flow, x)
    if x.dtype != torch.float32:
        raise TypeError("the CUDA kernel takes float32, got %s" % x.dtype)
    B, n, dim = x.shape
    if dim != flow.dim:
        raise ValueError("flow built for dim %d, x has dim %d" % (flow.dim, dim))
    if not flow_d2_fits(n, dim, cfg, lap):
        raise ValueError(
            "n = %d, dim = %d, spsize = %d, tpsize = %d is beyond the depth-2 closure "
            "kernel (it takes n <= 64, dim <= 3 and widths <= 32)" % (
                n, dim, cfg.spsize, cfg.tpsize))
    params = pack_flow_params(flow)
    if params.device != x.device:
        raise ValueError("flow parameters and x must lie on one device")
    lib = _lib()
    assert params.numel() == lib.cg_flow_d2_param_count(dim, cfg.spsize, cfg.tpsize)
    x = x.contiguous()
    nd = n * dim
    u = torch.empty(B, n, dim, dtype=torch.float32, device=x.device)
    J = torch.empty(B, nd, nd, dtype=torch.float32, device=x.device)
    tail = (B, n, dim, cfg.spsize, cfg.tpsize, float(cfg.L))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if lap:
            lap_u = torch.empty(B, nd, dtype=torch.float32, device=x.device)
            code = lib.cg_flow_d2_u_jac_lap(x.data_ptr(), params.data_ptr(), u.data_ptr(),
                                            J.data_ptr(), lap_u.data_ptr(), *tail, stream)
        else:
            code = lib.cg_flow_d2_u_jac(x.data_ptr(), params.data_ptr(), u.data_ptr(),
                                        J.data_ptr(), *tail, stream)
    check_launch(code, name)
    counters.launched(name)
    return (u, J, lap_u) if lap else (u, J)


def flow_u_jac_d2_cuda(flow: FermiNet, x):
    """u (B, n, dim) and J (B, nd, nd) of a depth-2 flow for walkers x (B, n, dim).

    A CUDA tensor must be f32 and is handled by the kernel (or this raises);
    a CPU tensor goes through the plain version.
    """
    return _launch(flow, x, lap=False)


def flow_u_jac_lap_d2_cuda(flow: FermiNet, x):
    """u, J and the flow's coordinate Laplacian lap (B, nd), as
    ``flow_u_jac_d2_cuda``."""
    return _launch(flow, x, lap=True)
