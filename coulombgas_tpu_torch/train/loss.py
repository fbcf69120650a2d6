"""Observables and REINFORCE loss functions for the joint VMC objective.

F = E_p[ log p / beta + <E_loc>_Psi ] minimized over both the classical VAN
and the quantum flow.  Counterpart of ``coulombgas_tpu/train/loss.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel import mesh
from ..physics.ewald import potential_energy

__all__ = ["make_loss"]


def make_loss(log_prob, logpsi, logpsi_grad_laplacian, kappa, G, L, rs, Vconst, beta,
              clip_factor=5.0):
    """Build the observable/loss evaluator.

    Args:
      log_prob: batched VAN log-probability (van, (batch, n)) -> (batch,).
      logpsi: batched log Psi (x, flow, state_indices) -> (batch, 2) [Re, Im].
      logpsi_grad_laplacian: batched derivative engine
        (x, flow, state_indices, generator, v) -> (grad, laplacian), complex.
      kappa, G, L, rs, Vconst, beta: Ewald/physics constants; Vconst is the
        Madelung term n*rs/L*madelung(...) added to every potential sample.
      clip_factor: total-variation clipping width for the REINFORCE weights.

    Returns ``observable_and_lossfn(van, flow, state_indices, x,
    generator=None, v=None, group=None) -> (observables dict,
    classical_lossfn, quantum_lossfn, aux)``; ``group`` is the process group
    of the ranks that share this chunk, None where this process holds all
    of it (nothing is reduced).  With a group, the clip window's centres and
    mean deviations are the chunk's, as the JAX package's global-batch means
    are: ``parallel.mesh.window_mean`` weighs each rank's means by its
    walkers.  The observables are 0-dim tensors without a
    graph, means over the walkers this process holds.  Each loss closure
    takes no argument and returns the real scalars (loss, mean score),
    differentiable in the parameters of ``van`` resp. ``flow``; the clipped
    weights in ``aux`` ("Floc_clipped" (B,) real, "Eloc_clipped" (B,)
    complex) enter them as constants.

    It is the composition of its two parts, which it carries as attributes
    for the SR accumulate (``train.train``), the same ops in the same order:
    ``.observables(van, flow, state_indices, x, generator=None, v=None) ->
    (observables dict, Floc (B,), Eloc (B,) complex)``, which reads nothing
    of the other walkers of its chunk, and ``.clip_window(observables, Floc,
    Eloc, group=None) -> (Floc_clipped, Eloc_clipped)``.  ``.graph_safe`` is
    the derivative engine's mark (``make_logpsi_grad_laplacian_analytic``):
    whether ``observables`` may be captured in a CUDA graph.
    """
    meshes = {}  # the Ewald mesh G once per device and dtype: no host copy a call

    def observables(van, flow, state_indices, x, generator=None, v=None):
        with torch.no_grad():
            if (x.device, x.dtype) not in meshes:
                meshes[x.device, x.dtype] = torch.as_tensor(
                    np.asarray(G), dtype=x.dtype, device=x.device)
            logp_states = log_prob(van, state_indices)
            grad, laplacian = logpsi_grad_laplacian(x, flow, state_indices, generator, v)

            kinetic = -laplacian - (grad**2).sum(dim=(-2, -1))
            potential = potential_energy(x, kappa, meshes[x.device, x.dtype], L, rs) + Vconst
            Eloc = kinetic + potential
            Floc = logp_states / beta + Eloc.real

            observable = {
                "K_mean": kinetic.real.mean(),
                "K2_mean": (kinetic.real**2).mean(),
                "V_mean": potential.mean(),
                "V2_mean": (potential**2).mean(),
                "E_mean": Eloc.real.mean(),
                "E2_mean": (Eloc.real**2).mean(),
                "F_mean": Floc.mean(),
                "F2_mean": (Floc**2).mean(),
                "S_mean": -logp_states.mean(),
                "S2_mean": (logp_states**2).mean(),
            }
        return observable, Floc, Eloc

    @torch.no_grad()
    def clip_window(observable, Floc, Eloc, group=None):
        F_mean, E_mean = observable["F_mean"], observable["E_mean"]
        count = Floc.shape[0]
        if group is not None:  # two reductions, one after the other
            F_mean, E_mean = mesh.window_mean([F_mean, E_mean], group, count)
        tvF = (Floc - F_mean).abs().mean()
        tvE = (Eloc - E_mean).abs().mean()
        if group is not None:
            tvF, tvE = mesh.window_mean([tvF, tvE], group, count)

        Floc_clipped = torch.clamp(
            Floc, F_mean - clip_factor * tvF, F_mean + clip_factor * tvF)
        # clip the real part and carry the imaginary part unchanged
        Eloc_clipped = torch.complex(
            torch.clamp(Eloc.real, E_mean - clip_factor * tvE, E_mean + clip_factor * tvE),
            Eloc.imag)
        return Floc_clipped, Eloc_clipped

    def observable_and_lossfn(van, flow, state_indices, x, generator=None, v=None, group=None):
        observable, Floc, Eloc = observables(van, flow, state_indices, x, generator, v)
        Floc_clipped, Eloc_clipped = clip_window(observable, Floc, Eloc, group)
        aux = {"Floc_clipped": Floc_clipped, "Eloc_clipped": Eloc_clipped}

        def classical_lossfn():
            logp = log_prob(van, state_indices)
            return (logp * Floc_clipped).mean(), logp.mean()

        def quantum_lossfn():
            lp = logpsi(x, flow, state_indices)
            # 2 Re(logpsi conj(Eloc)), written out in real arithmetic so that
            # the scalar handed to autograd is real from the start
            gradF_theta = 2 * (lp[..., 0] * Eloc_clipped.real
                               + lp[..., 1] * Eloc_clipped.imag).mean()
            return gradF_theta, 2 * lp[..., 0].mean()

        return observable, classical_lossfn, quantum_lossfn, aux

    observable_and_lossfn.observables = observables
    observable_and_lossfn.clip_window = clip_window
    observable_and_lossfn.graph_safe = getattr(logpsi_grad_laplacian, "graph_safe", False)
    return observable_and_lossfn
