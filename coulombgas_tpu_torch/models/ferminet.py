"""Permutation-equivariant FermiNet-style normalizing flow (backflow).

Maps electron coordinates x -> z in a periodic box of size L through residual
single-particle / two-particle feature streams built from periodic pair
features.  Counterpart of ``coulombgas_tpu/models/ferminet.py``: the
parameters live in an ``nn.Module`` whose names map one-to-one onto the
reference pytree (``sp.{i}.w``, ``sp.{i}.b``, ``tp.{i}.w``, ``final.w`` ...),
and every function takes any number of leading batch dimensions: x is
``(..., n, dim)``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..config import resolve_device

__all__ = ["FermiNetConfig", "Linear", "FermiNet", "init_ferminet_params",
           "ferminet_apply", "softplus"]


@dataclass(frozen=True)
class FermiNetConfig:
    """Static hyperparameters of the flow."""

    depth: int
    spsize: int
    tpsize: int
    L: float
    init_stddev: float = 0.01


class Linear(nn.Module):
    """Affine map stored as the reference stores it: ``w`` (d_in, d_out), ``b``."""

    def __init__(self, d_in: int, d_out: int, dtype=None, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(d_in, d_out, dtype=dtype, device=device))
        self.b = nn.Parameter(torch.zeros(d_out, dtype=dtype, device=device))

    def forward(self, x):
        return x @ self.w + self.b


class FermiNet(nn.Module):
    """Parameter container of the flow; ``forward`` is ``ferminet_apply``.

    Layer shapes mirror the stream construction in ``ferminet_apply``: the
    two-particle stream starts at 2*dim+1 features (cos/sin pair
    displacements + periodized distance), the per-layer single-particle
    feature is [sp, mean(sp), mean(tp)].
    """

    def __init__(self, cfg: FermiNetConfig, dim: int, dtype=None, device=None):
        super().__init__()
        self.cfg, self.dim = cfg, dim
        spsize, tpsize = dim, 2 * dim + 1
        sp, tp = [], []
        for i in range(cfg.depth):
            sp.append(Linear(2 * spsize + tpsize, cfg.spsize, dtype, device))
            spsize = cfg.spsize
            if i < cfg.depth - 1:
                tp.append(Linear(tpsize, cfg.tpsize, dtype, device))
                tpsize = cfg.tpsize
        self.sp = nn.ModuleList(sp)
        self.tp = nn.ModuleList(tp)
        self.final = Linear(cfg.spsize, dim, dtype, device)

    def forward(self, x):
        return ferminet_apply(self, x)


def init_ferminet_params(cfg: FermiNetConfig, dim: int, generator=None,
                         dtype=torch.float32, device=None) -> FermiNet:
    """Flow with N(0, init_stddev^2) weights and zero biases.

    ``device=None`` means CUDA and raises where there is none.  ``generator``
    is a CPU ``torch.Generator``; the draws are made on the CPU and copied, so
    that one seed gives the same flow on either device.
    """
    flow = FermiNet(cfg, dim, dtype, resolve_device(device))
    with torch.no_grad():
        for lin in [*flow.sp, *flow.tp, flow.final]:
            w = torch.randn(lin.w.shape, generator=generator, dtype=torch.float64)
            lin.w.copy_((cfg.init_stddev * w).to(dtype))
    return flow


def softplus(x):
    """log(1 + e^x) as ``logaddexp(x, 0)``: no threshold switch to the
    identity (``torch.nn.functional.softplus`` has one), so f64 parity with
    the reference holds everywhere."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _pair_features(x, L):
    """Initial two-particle stream: (..., n, n, 2*dim+1) periodic pair features.

    cos/sin of the pair displacements plus the periodized distance
    |sin(pi r_ij / L)| with the diagonal regularized through an identity
    shift so its derivative stays finite at r_ii = 0.
    """
    n = x.shape[-2]
    rij = x[..., :, None, :] - x[..., None, :, :]
    cos_rij = torch.cos(2 * torch.pi / L * rij)
    sin_rij = torch.sin(2 * torch.pi / L * rij)
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    s1 = torch.sin(torch.pi / L * rij) + eye[..., None]
    dij = (s1**2).sum(dim=-1).sqrt() * (1.0 - eye)
    return torch.cat([cos_rij, sin_rij, dij[..., None]], dim=-1)


def _sp_feature(sp, tp):
    """Per-layer single-particle feature f = [sp, mean_i(sp), mean_j(tp)]."""
    return torch.cat(
        [sp, sp.mean(dim=-2, keepdim=True).expand_as(sp), tp.mean(dim=-2)], dim=-1
    )


def ferminet_apply(flow: FermiNet, x):
    """Apply the flow: x (..., n, dim) -> z (..., n, dim).

    Equivariances: permutation of particles, continuous translation
    z(x + a) = z(x) + a, and lattice-translation compatibility
    z(x + R*L) = z(x) + R*L.
    """
    depth = flow.cfg.depth
    sp = torch.zeros_like(x)
    tp = _pair_features(x, flow.cfg.L)

    for i in range(depth - 1):
        sp_new = softplus(flow.sp[i](_sp_feature(sp, tp)))
        tp_new = softplus(flow.tp[i](tp))
        sp = sp_new if i == 0 else sp + sp_new
        tp = tp_new if i == 0 else tp + tp_new

    sp = sp + softplus(flow.sp[-1](_sp_feature(sp, tp)))
    return x + flow.final(sp)
