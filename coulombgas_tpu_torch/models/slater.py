"""Plane-wave Slater determinants.

log det[ L^(-dim/2) exp(i k_j . x_i) ] as a complex log (with phase), carried
as a real pair so that every derivative taken of it is real.  Counterpart of
``coulombgas_tpu/models/slater.py``; the determinant is an LU ``slogdet`` on
the complex matrix (a Gram form would square the conditioning and lose all
f32 digits on near-node walkers), differentiated by PyTorch's own rule.
"""

from __future__ import annotations

import torch

from ..config import complex_dtype

__all__ = ["logslaterdet", "logslaterdet_ref", "planewave_matrix"]


def planewave_matrix(k, x, L):
    """D_ij = L^(-dim/2) exp(i k_j . x_i) for momenta k = 2 pi / L * indices.

    k, x: (..., n, dim).  Returns (..., n, n) complex.
    """
    dim = x.shape[-1]
    k_dot_x = x @ k.transpose(-1, -2)
    phase = torch.complex(torch.cos(k_dot_x), torch.sin(k_dot_x))
    return L ** (-dim / 2) * phase.to(complex_dtype(x.dtype))


class _SlogdetInTransforms(torch.autograd.Function):
    """``torch.linalg.slogdet`` of complex matrices with PyTorch's own
    derivative as PyTorch takes it inside ``torch.func`` transforms (the
    per-sample scores' ``vmap(jacrev(...))``): A^-H applied by a solve of
    A^H, the same ops in the same order, so the same numbers.  PyTorch's
    ``linalg.solve`` there reads its singular-matrix flag back to the host,
    which a CUDA graph cannot hold; ``solve_ex`` does not.  On the SR route
    the analytic Laplacian engine refuses a singular Slater matrix of the
    same walkers on the device (``fast_laplacian.SINGULAR``)."""

    @staticmethod
    def forward(A):
        return torch.linalg.slogdet(A)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output[0])

    @staticmethod
    def backward(ctx, grad_sign, grad_logabsdet):
        A, sign = ctx.saved_tensors
        g = grad_logabsdet - 1j * torch.imag(grad_sign.conj() * sign)
        d = torch.diag_embed(g.unsqueeze(-1).expand(*g.shape, A.shape[-1])).mT
        return torch.linalg.solve_ex(A.mH, d)[0]

    @staticmethod
    def vmap(info, in_dims, A):
        return _SlogdetInTransforms.apply(A.movedim(in_dims[0], 0)), (0, 0)


def logslaterdet(indices, x, L):
    """log det of the plane-wave Slater matrix as a real pair.

    INPUT: indices (..., n, dim) float momenta in units of 2 pi / L (may
    include the twist), x (..., n, dim).
    OUTPUT: (..., 2) = [log|det D|, arg(det D)].
    """
    D = planewave_matrix(2 * torch.pi / L * indices, x, L)
    if torch._C._functorch.is_functorch_wrapped_tensor(D):
        sign, logabsdet = _SlogdetInTransforms.apply(D)
    else:
        sign, logabsdet = torch.linalg.slogdet(D)
    return torch.stack([logabsdet, torch.angle(sign)], dim=-1)


def logslaterdet_ref(indices, x, L):
    """Complex-valued form, log|det D| + i arg(det D)."""
    out = logslaterdet(indices, x, L)
    return torch.complex(out[..., 0], out[..., 1])
