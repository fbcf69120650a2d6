"""Batched Metropolis MCMC over electron coordinates.

Counterpart of ``coulombgas_tpu/sampling/mcmc.py``.  The random draws come
from a ``torch.Generator`` on the walkers' device, or — so that a test can
replay another implementation's draws — from tensors handed in.
"""

from __future__ import annotations

import torch

__all__ = ["mcmc"]


@torch.no_grad()
def mcmc(logp_fn, x_init, generator, mc_steps: int, mc_stddev=0.02,
         proposals=None, uniforms=None):
    """Metropolis sampling with an isotropic Gaussian proposal.

    Args:
      logp_fn: x (batch, n, dim) -> (batch,) log-probabilities.
      x_init: (batch, n, dim) walkers.
      generator: ``torch.Generator`` on ``x_init.device`` (unused when both
        ``proposals`` and ``uniforms`` are given).
      mc_steps: number of Metropolis sweeps.
      mc_stddev: proposal standard deviation.
      proposals: optional (mc_steps, batch, n, dim) standard-normal draws.
      uniforms: optional (mc_steps, batch) uniform [0, 1) draws.

    Returns:
      (x, accept_rate): final walkers and the mean acceptance rate (a 0-dim
      tensor on the walkers' device).
    """
    x = x_init
    logp = logp_fn(x)
    num_accepts = torch.zeros((), dtype=x.dtype, device=x.device)
    for i in range(mc_steps):
        if proposals is not None:
            noise = proposals[i]
        else:
            noise = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                                device=x.device)
        x_prop = x + mc_stddev * noise
        logp_prop = logp_fn(x_prop)
        ratio = torch.exp(logp_prop - logp)
        if uniforms is not None:
            unif = uniforms[i]
        else:
            unif = torch.rand(ratio.shape, generator=generator, dtype=ratio.dtype,
                              device=ratio.device)
        accept = unif < ratio
        # Stuck-walker rescue: a NaN proposal logp auto-rejects (NaN compares
        # False), but a walker whose CURRENT logp is non-finite would then
        # reject everything forever — accept any finite proposal to bring it
        # back.
        accept = accept | (~torch.isfinite(logp) & torch.isfinite(logp_prop))
        x = torch.where(accept[:, None, None], x_prop, x)
        logp = torch.where(accept, logp_prop, logp)
        num_accepts = num_accepts + accept.sum()
    return x, num_accepts / (mc_steps * x.shape[0])
