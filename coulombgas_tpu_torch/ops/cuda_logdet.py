"""Batched log det of small SPD matrices on the GPU — hand-written CUDA.

Counterpart of ``coulombgas_tpu/ops/pallas_logdet.py``.  The kernel
(``csrc/chol_logdet.cu``) gives one thread block to each matrix, holds it in
shared memory through all elimination steps and writes one number.  Its plain
version is ``ops.logdet.chol_logdet_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import SMEM_LIMIT_BYTES, check_launch, load_library
from .logdet import chol_logdet_ref

__all__ = ["chol_logdet_cuda", "chol_logdet_plain", "chol_logdet_fits", "launches"]

# Number of kernel launches made by ``chol_logdet_cuda``.
launches = 0

# The plain PyTorch version of the kernel, same signature.
chol_logdet_plain = chol_logdet_ref


def chol_logdet_fits(m: int, device=None) -> bool:
    """Whether the wrapper takes an m x m matrix on ``device`` (default:
    CUDA): for the kernel, whether one matrix fits a block's shared memory,
    which asks the built library and so needs ``nvcc``.  On a CPU device the
    wrapper takes its plain version, which takes any size."""
    if device is not None and torch.device(device).type == "cpu":
        return True
    return _lib().cg_chol_logdet_smem(m) <= SMEM_LIMIT_BYTES


def _lib():
    lib = load_library("chol_logdet")
    lib.cg_chol_logdet.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_void_p]
    lib.cg_chol_logdet.restype = ctypes.c_int
    lib.cg_chol_logdet_smem.argtypes = [ctypes.c_int]
    return lib


def chol_logdet_cuda(A):
    """log det of (batch, m, m) SPD matrices, non-positive pivots deflated.

    A CUDA tensor must be f32 and is handled by the kernel (or this raises);
    a CPU tensor goes through the plain version.
    """
    global launches
    if A.ndim != 3 or A.shape[-1] != A.shape[-2]:
        raise ValueError("expected (batch, m, m), got %s" % (tuple(A.shape),))
    if not A.is_cuda:
        return chol_logdet_plain(A)
    if A.dtype != torch.float32:
        raise TypeError("the CUDA kernel takes float32, got %s" % A.dtype)
    B, m, _ = A.shape
    if not chol_logdet_fits(m):
        raise ValueError("m = %d exceeds the kernel's shared-memory budget" % m)
    A = A.contiguous()
    out = torch.empty(B, dtype=torch.float32, device=A.device)
    with torch.cuda.device(A.device):
        code = _lib().cg_chol_logdet(A.data_ptr(), out.data_ptr(), B, m,
                                     torch.cuda.current_stream().cuda_stream)
    check_launch(code, "chol_logdet")
    launches += 1
    return out
