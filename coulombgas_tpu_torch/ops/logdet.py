"""Batched log-determinants of small SPD matrices.

The MCMC coordinate density logp = 2 Re log Psi needs log|det J| of the flow
Jacobian and log|det D| of the plane-wave Slater matrix for every walker at
every Metropolis sweep.  Both reduce to SPD Gram forms:

    log|det J|      = 1/2 log det (J^T J)
    2 Re log det D  =     log det (D^H D)

so one *pivot-free batched Cholesky* covers the hot path.

Near-singular handling: a pivot below ``PIVOT_FLOOR`` marks a (numerically)
singular matrix.  The step is deflated — the pivot contributes
``log(PIVOT_FLOOR)`` and its column is zeroed — so the result degrades to a
large negative value instead of NaN.  For the MCMC use case that is exactly
right: a walker proposal at a wavefunction node must be rejected, which a
strongly negative logp guarantees, while NaN would poison the accept
comparison and freeze the walker.  ``torch.linalg.cholesky`` raises (or gives
NaN) on such input, which is why the elimination is written out here.

Counterpart of ``coulombgas_tpu/ops/logdet.py``; every function takes leading
batch dimensions.  ``chol_logdet_ref`` is also the plain version of the
kernel in ``ops/cuda_logdet.py``.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "PIVOT_FLOOR",
    "chol_logdet_ref",
    "chol_logdet",
    "chol_logdet_single",
    "logdet_spd_single",
    "gj_inverse_single",
    "gram_inverse_single",
    "gram_logabsdet",
    "planewave_gram_embed",
]

# f32 min normal is ~1.2e-38; 1e-30 leaves headroom for the rank-1 updates.
PIVOT_FLOOR = 1e-30


def chol_logdet_ref(A):
    """log det A for a batch of SPD matrices, pivot-free Cholesky; plain torch.

    A: (batch, m, m) symmetric positive definite.  Returns (batch,) log det.
    Deflates non-positive pivots (see module docstring).  Differentiable.
    """
    m = A.shape[-1]
    log_floor = math.log(PIVOT_FLOOR)
    ld = A.new_zeros(A.shape[0])
    rows = torch.arange(m, device=A.device)
    one = A.new_ones(())
    for k in range(m):
        d = A[:, k, k]
        bad = d < PIVOT_FLOOR
        d_use = torch.where(bad, one, d)
        ld = ld + torch.where(bad, one * log_floor, torch.log(d_use))
        col = A[:, :, k] / d_use[:, None]
        keep = (rows > k)[None, :] & ~bad[:, None]
        colm = torch.where(keep, col, torch.zeros_like(col))
        A = A - colm[:, :, None] * (colm[:, None, :] * d_use[:, None, None])
    return ld


def chol_logdet_single(A):
    """log det of SPD matrices (..., m, m) as a chain of differentiable ops."""
    batch = A.shape[:-2]
    return chol_logdet_ref(A.reshape(-1, *A.shape[-2:])).reshape(batch)


def gj_inverse_single(A):
    """Inverse of symmetric/Hermitian positive-definite matrices (..., m, m).

    Unrolled no-pivot Gauss-Jordan elimination — positive definiteness makes
    every pivot (a Schur-complement diagonal) positive, so no pivot search is
    needed and every step is a plain vectorized multiply-add, differentiable
    to any order.  A vanishing pivot is floored like in ``chol_logdet_ref``.
    """
    m = A.shape[-1]
    M = torch.eye(m, dtype=A.dtype, device=A.device).expand_as(A)
    rows = torch.arange(m, device=A.device)
    for k in range(m):
        d_re = A[..., k, k].real if A.is_complex() else A[..., k, k]
        d_use = torch.where(d_re < PIVOT_FLOOR, torch.ones_like(d_re), d_re)
        rowA = A[..., k, :] / d_use[..., None]
        rowM = M[..., k, :] / d_use[..., None]
        is_k = rows == k
        c = torch.where(is_k, torch.zeros_like(A[..., :, k]), A[..., :, k])[..., None]
        A = A - c * rowA[..., None, :]
        M = M - c * rowM[..., None, :]
        A = torch.where(is_k[:, None], rowA[..., None, :], A)
        M = torch.where(is_k[:, None], rowM[..., None, :], M)
    return M


def gram_inverse_single(D):
    """D^-1 of square complex (or real) matrices (..., m, m) via the Gram form.

    D^-1 = (D^H D)^-1 D^H with the Hermitian positive-definite Gram inverted
    by ``gj_inverse_single``: no LU, differentiable to any order.  The
    conditioning is squared, like that of every Gram form here.
    """
    Dh = D.conj().transpose(-1, -2) if D.is_complex() else D.transpose(-1, -2)
    return gj_inverse_single(Dh @ D) @ Dh


class _SpdInverse(torch.autograd.Function):
    """Inverse of real SPD matrices with the closed-form derivative
    d(A^-1) = -A^-1 dA A^-1 instead of AD through the m elimination steps
    (which would keep O(m) full-matrix residuals per walker).

    Written with ``setup_context`` and a ``vmap`` rule so that
    ``torch.func.vmap(torch.func.jacrev(...))`` — the per-sample scores of
    stochastic reconfiguration — and the batched cotangents of the exact
    Laplacian's Hessian columns (``autograd.grad(is_grads_batched=True)``, the
    matrix itself unbatched: PyTorch then skips the rule) can pass through it:
    the function takes any leading batch dimensions, so the rule moves the
    mapped one to the front."""

    @staticmethod
    def forward(A):
        return gj_inverse_single(A)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)

    @staticmethod
    def backward(ctx, grad):
        (inv,) = ctx.saved_tensors
        invT = inv.transpose(-1, -2)
        return -(invT @ grad @ invT)

    @staticmethod
    def vmap(info, in_dims, A):
        return _SpdInverse.apply(A.movedim(in_dims[0], 0)), 0


class _LogdetSpd(torch.autograd.Function):
    """Primal: the pivot-free Cholesky — no graph is kept of it, so on the GPU
    it is the kernel behind ``chol_logdet``.  Derivative: A^-1 (A symmetric),
    so that reverse-mode derivatives of any order nest over ``_SpdInverse``'s
    closed form.  The ``vmap`` rule hands the kernel the physically batched
    tensor."""

    @staticmethod
    def forward(A):
        return chol_logdet(A.reshape(-1, *A.shape[-2:])).reshape(A.shape[:-2])

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, grad):
        (A,) = ctx.saved_tensors
        return grad[..., None, None] * _SpdInverse.apply(A)

    @staticmethod
    def vmap(info, in_dims, A):
        return _LogdetSpd.apply(A.movedim(in_dims[0], 0)), 0


def logdet_spd_single(A):
    """log det of real SPD matrices (..., m, m) with closed-form derivatives.

    Value from ``chol_logdet``; the gradient is A^-1 from
    ``gj_inverse_single``, and the gradient's own derivative is the closed
    form -A^-1 dA A^-1, so the Hessian-vector products of the Hutchinson
    Laplacian and the Hessian columns of the exact one keep no per-step
    residuals.
    """
    return _LogdetSpd.apply(A)


def chol_logdet(A):
    """log det of batched SPD matrices (batch, m, m).

    A CUDA tensor goes to the hand-written kernel (``ops/cuda_logdet.py``),
    which raises if it cannot run; a CPU tensor goes to ``chol_logdet_ref``.
    An m past the kernel's limit, ``K3_MAX_M`` (``chol_logdet_fits``), or a
    CUDA tensor of another dtype than float32 takes ``chol_logdet_ref`` on the
    tensor's own device, as the JAX package's dispatcher takes its kernel for
    f32 input within its VMEM budget only and its plain elimination otherwise.
    """
    from . import cuda_logdet

    f32_or_cpu = A.dtype == torch.float32 or A.device.type == "cpu"
    if not (f32_or_cpu and cuda_logdet.chol_logdet_fits(A.shape[-1], A.device)):
        return chol_logdet_ref(A)
    return cuda_logdet.chol_logdet_cuda(A)


def gram_logabsdet(J):
    """log |det J| for a batch of square real matrices: 1/2 log det(J J^T)."""
    return 0.5 * chol_logdet(torch.einsum("bij,bkj->bik", J, J))


def planewave_gram_embed(Dr, Di):
    """Real 2n x 2n SPD embedding of H = D^H D for complex D = Dr + i Di.

    det(embed(H)) = det(H)^2, so 2 Re log det D = 1/2 log det embed(H).
    Returns (batch, 2n, 2n); the shape equals the dim=2 flow-Jacobian Gram,
    so both determinants ride one ``chol_logdet`` call.
    """
    Hr = torch.einsum("bji,bjk->bik", Dr, Dr) + torch.einsum("bji,bjk->bik", Di, Di)
    Hi = torch.einsum("bji,bjk->bik", Dr, Di) - torch.einsum("bji,bjk->bik", Di, Dr)
    top = torch.cat([Hr, -Hi], dim=-1)
    bot = torch.cat([Hi, Hr], dim=-1)
    return torch.cat([top, bot], dim=-2)
