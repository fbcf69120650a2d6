"""Training steps: joint sampling, gradient accumulation, update.

Counterpart of ``coulombgas_tpu/train/train.py`` on the plain-optimizer
branch (no stochastic reconfiguration yet):

  * ``sample_step``   — VAN occupation draws + Metropolis coordinates,
  * ``accumulate``    — observables, REINFORCE gradients and mean scores,
                        summed into an explicit accumulator,
  * ``apply_update``  — accumulator normalization, baseline correction, and
                        the optimizer step.
"""

from __future__ import annotations

import torch

from ..sampling.mcmc import mcmc

__all__ = ["make_sample_step", "make_accumulate_and_apply", "init_accumulators",
           "DATA_KEYS"]

DATA_KEYS = ("F_mean", "F2_mean", "E_mean", "E2_mean", "K_mean",
             "K2_mean", "V_mean", "V2_mean", "S_mean", "S2_mean")


def make_sample_step(sampler, logp, mc_steps: int, mc_stddev, L, batch: int):
    """Joint sampling of occupations (exact) and coordinates (MCMC).

    Returns ``sample_step(van, flow, x, generator) -> (state_indices, x,
    accept_rate)``; coordinates are wrapped back into [0, L).  ``generator``
    lives on the walkers' device and serves both samplers.
    """

    @torch.no_grad()
    def sample_step(van, flow, x, generator):
        state_indices = sampler(van, generator, batch)
        x, accept_rate = mcmc(
            lambda xx: logp(xx, flow, state_indices), x, generator, mc_steps, mc_stddev)
        x = x - L * torch.floor(x / L)
        return state_indices, x, accept_rate

    return sample_step


def _zeros_like_params(module):
    return [torch.zeros_like(p) for p in module.parameters()]


def init_accumulators(van, flow, sr: bool = False):
    """Zero accumulators for one epoch of gradient accumulation.  Gradients
    and scores are lists in the order of ``module.parameters()``."""
    if sr:
        raise NotImplementedError("stochastic reconfiguration is not ported yet")
    p = next(flow.parameters())
    return {
        "data": {k: torch.zeros((), dtype=p.dtype, device=p.device) for k in DATA_KEYS},
        "grads": (_zeros_like_params(van), _zeros_like_params(flow)),
        "classical_score": _zeros_like_params(van),
        "quantum_score": _zeros_like_params(flow),
    }


def make_accumulate_and_apply(observable_and_lossfn, acc_steps: int,
                              microbatch: int | None = None):
    """Build (accumulate, apply_update) for one training epoch.

    Per-step gradients and scores are accumulated, then normalized by
    acc_steps, baseline-corrected (grad_van -= F_mean * score_van,
    grad_flow -= E_mean * score_flow) and handed to the optimizer.

    ``microbatch`` bounds the memory of the autograd graphs: the batch is
    processed in chunks of that many walkers, one after the other, and the
    chunks' contributions averaged.  (The REINFORCE clipping window is then
    computed per chunk rather than per batch.)
    """

    def _grad_pair(lossfn, params):
        """Gradients of (loss, mean score) with one forward pass."""
        loss, score = lossfn()
        g_loss = torch.autograd.grad(loss, params, retain_graph=True)
        g_score = torch.autograd.grad(score, params)
        return list(g_loss), list(g_score)

    def _one_batch(van, flow, state_indices, x, generator, v):
        data, classical_lossfn, quantum_lossfn, _ = observable_and_lossfn(
            van, flow, state_indices, x, generator, v)
        grad_van, classical_score = _grad_pair(classical_lossfn, list(van.parameters()))
        grad_flow, quantum_score = _grad_pair(quantum_lossfn, list(flow.parameters()))
        return {
            "data": data,
            "grads": (grad_van, grad_flow),
            "classical_score": classical_score,
            "quantum_score": quantum_score,
        }

    def _add(acc, contrib, weight=1.0):
        for k in acc["data"]:
            acc["data"][k] += weight * contrib["data"][k]
        pairs = [(acc["grads"][0], contrib["grads"][0]),
                 (acc["grads"][1], contrib["grads"][1]),
                 (acc["classical_score"], contrib["classical_score"]),
                 (acc["quantum_score"], contrib["quantum_score"])]
        for dst, src in pairs:
            for a, b in zip(dst, src):
                a.add_(b, alpha=weight)
        return acc

    def accumulate(van, flow, state_indices, x, generator, acc, v=None):
        """Add one batch's contribution to ``acc`` (in place) and return it."""
        batch = x.shape[0]
        if microbatch is None or batch <= microbatch:
            return _add(acc, _one_batch(van, flow, state_indices, x, generator, v))
        if batch % microbatch:
            raise ValueError("batch %d is not a multiple of microbatch %d" % (batch, microbatch))
        nchunks = batch // microbatch
        for s in range(0, batch, microbatch):
            sl = slice(s, s + microbatch)
            contrib = _one_batch(van, flow, state_indices[sl], x[sl], generator,
                                 None if v is None else v[sl])
            _add(acc, contrib, 1.0 / nchunks)
        return acc

    @torch.no_grad()
    def apply_update(van, flow, optimizer, acc):
        """Normalize, baseline-correct, step ``optimizer`` (which holds the
        parameters of ``van`` and ``flow``).  Returns the epoch's observables
        as 0-dim tensors."""
        data = {k: val / acc_steps for k, val in acc["data"].items()}
        for params, grads, scores, base in (
            (van.parameters(), acc["grads"][0], acc["classical_score"], data["F_mean"]),
            (flow.parameters(), acc["grads"][1], acc["quantum_score"], data["E_mean"]),
        ):
            for p, g, s in zip(params, grads, scores):
                # REINFORCE baseline correction
                p.grad = (g - base * s) / acc_steps
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return data

    return accumulate, apply_update
