"""Fused Metropolis log-density tail on the GPU — hand-written CUDA.

    logp = log det(D^H D) + 1/2 log det(J^T J),
    D[i][m] = L^(-dim/2) exp(i k_m . u_i)

Counterpart of ``coulombgas_tpu/ops/pallas_fused_logp.py``.  The kernel
(``csrc/fused_logp.cu``) gives one thread block to each walker, whose warps
form two groups: one streams J into the real Gram and eliminates it, the
other builds the plane-wave matrix and its Hermitian Gram and eliminates
that, both at the same time, in panels of 8 columns (``csrc/chol_blocked.cuh``).
Both Grams stay in shared memory and one number per walker leaves.  Layout is batch-first — u, k ``(B, n, dim)``,
J ``(B, nd, nd)`` — which is what ``ops.cuda_flow_jac.flow_u_jac_cuda``
writes, so the two run back to back with no transpose.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import counters
from ._build import SMEM_LIMIT_BYTES, check_launch, load_library
from .logdet import PIVOT_FLOOR, chol_logdet_ref

__all__ = ["fused_logp_cuda", "fused_logp_plain", "fused_fits",
           "fused_smem_bytes"]


def fused_smem_bytes(n: int, dim: int) -> int:
    """Shared memory of one walker's block, as the built library states it;
    -1 beyond the kernel's n ceiling."""
    return _lib().cg_fused_logp_smem(n, dim)


def fused_fits(n: int, dim: int, device=None) -> bool:
    """Whether the wrapper takes this size on ``device`` (default: CUDA).
    The kernel takes nd <= 152 with one walker within a thread block's shared
    memory; this asks the built library, so it needs ``nvcc``.  On a CPU
    device the wrapper takes its plain version, which takes any size."""
    if device is not None and torch.device(device).type == "cpu":
        return True
    return 0 <= fused_smem_bytes(n, dim) <= SMEM_LIMIT_BYTES


def fused_logp_plain(u, kvec, J, L: float):
    """Plain PyTorch version of the kernel: same arguments, same result."""
    dim = u.shape[-1]
    c = float(L) ** (-dim / 2)
    ang = torch.einsum("bnd,bmd->bnm", u, kvec)
    D = torch.complex(c * torch.cos(ang), c * torch.sin(ang))
    ld_h = _herm_chol_logdet(D.mH @ D)
    ld_g = chol_logdet_ref(J.transpose(-1, -2) @ J)
    return ld_h + 0.5 * ld_g


def _herm_chol_logdet(H):
    """Complex pivot-free Cholesky log det of Hermitian H (B, n, n), deflating."""
    n = H.shape[-1]
    ld = H.real.new_zeros(H.shape[0])
    rows = torch.arange(n, device=H.device)
    one = ld.new_ones(())
    for k in range(n):
        d = H[:, k, k].real
        bad = d < PIVOT_FLOOR
        d_use = torch.where(bad, one, d)
        ld = ld + torch.where(bad, one * math.log(PIVOT_FLOOR), torch.log(d_use))
        keep = (rows > k)[None, :] & ~bad[:, None]
        col = torch.where(keep, H[:, :, k], torch.zeros_like(H[:, :, k]))
        H = H - col[:, :, None] * col.conj()[:, None, :] / d_use[:, None, None]
    return ld


def _lib():
    lib = load_library("fused_logp")
    lib.cg_fused_logp.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.cg_fused_logp.restype = ctypes.c_int
    lib.cg_fused_logp_smem.argtypes = [ctypes.c_int] * 2
    return lib


def fused_logp_cuda(u, kvec, J, L: float):
    """logp (B,) for u, kvec (B, n, dim) and J (B, nd, nd).

    CUDA tensors must be f32 and are handled by the kernel (or this raises);
    CPU tensors go through the plain version.
    """
    B, n, dim = u.shape
    nd = n * dim
    if kvec.shape != u.shape or J.shape != (B, nd, nd):
        raise ValueError("shapes: u %s, kvec %s, J %s" % (
            tuple(u.shape), tuple(kvec.shape), tuple(J.shape)))
    if not (u.device == kvec.device == J.device):
        raise ValueError("u, kvec and J must lie on one device")
    if not u.is_cuda:
        return fused_logp_plain(u, kvec, J, L)
    if not (u.dtype == kvec.dtype == J.dtype == torch.float32):
        raise TypeError("the CUDA kernel takes float32")
    if not fused_fits(n, dim):
        raise ValueError("n = %d, dim = %d exceeds the kernel's shared-memory "
                         "budget (%d > %d bytes)" % (
                             n, dim, fused_smem_bytes(n, dim), SMEM_LIMIT_BYTES))
    u, kvec, J = u.contiguous(), kvec.contiguous(), J.contiguous()
    out = torch.empty(B, dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        code = _lib().cg_fused_logp(
            u.data_ptr(), kvec.data_ptr(), J.data_ptr(), out.data_ptr(), B, n, dim,
            float(L) ** (-dim / 2), torch.cuda.current_stream().cuda_stream)
    check_launch(code, "fused_logp")
    counters.launched("fused_logp")
    return out
