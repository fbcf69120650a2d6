"""Exact autoregressive sampling of ordered momentum occupations.

Draws n-fermion occupation states k_1 < k_2 < ... < k_n from the VAN and
evaluates their exact log-probabilities.  Counterpart of
``coulombgas_tpu/sampling/autoregressive.py``: a Python loop over particles
drives the KV-cached single-token decode — O(n) token work per sample.

The ordered-occupation mask encodes "strictly increasing indices with room
for the remaining particles":  row i allows index m iff
m > state_idx[i-1]  and  m <= M - n + i.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..io.convert import ravel_named, ravel_order
from ..models.per_sample import per_sample_jacobian
from ..models.transformer import (
    Transformer,
    init_kv_cache,
    transformer_apply,
    transformer_decode_step,
)

__all__ = ["make_autoregressive_sampler", "make_classical_score", "draw",
           "drawable", "assert_drawable"]

_NEG_INF = -1e30
# torch.multinomial's messages for the two checks of its probabilities
BAD_PROBS = "probability tensor contains either `inf`, `nan` or element < 0"
ZERO_ROW = "invalid multinomial distribution (sum of probabilities <= 0)"


def draw(probs, generator):
    """One index a row of ``probs`` (B, M), the index and the generator's
    state after it equal to ``torch.multinomial(probs, 1, generator=generator)
    [:, 0]``: ATen's path for one sample, argmax of p / q with q ~ Exp(1),
    written out without the two host reads with which ``torch.multinomial``
    checks ``probs`` first.  The checks are ``drawable``'s, on the device."""
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / q, dim=-1)


def drawable(lows, highs, row_sums):
    """``torch.multinomial``'s two checks of its probabilities as device
    flags, over draws with least and largest probabilities ``lows``,
    ``highs`` (draws,) (``torch.aminmax``, which keeps a NaN) and row sums
    ``row_sums`` (draws, B): (no entry inf, NaN or negative; no row summing
    to zero)."""
    finite = ((highs < math.inf) & (lows >= 0)).all()
    return finite, (row_sums != 0).all()


def assert_drawable(lows, highs, row_sums):
    """Raise ``torch.multinomial``'s error where ``drawable`` fails: at once
    on the CPU; on the card at the next synchronisation, as the device-side
    assert of ``torch.multinomial``'s other path does, with no host read."""
    finite, nonzero = drawable(lows, highs, row_sums)
    torch._assert_async(finite, BAD_PROBS)
    torch._assert_async(nonzero, ZERO_ROW)


def make_autoregressive_sampler(sp_indices, n: int, num_states: int,
                                mask_fn: bool = False):
    """Build (sampler, log_prob) closures over a VAN.

    Args:
      sp_indices: (num_states, dim) float array of (twisted) momenta — the
        token embedding table, ordered the same way the VAN's logits are.
      n: number of fermions.
      num_states: number of single-particle states M.
      mask_fn: if True, additionally return the function that makes the mask (for tests).

    Returns:
      sampler(van, generator, batch) -> (batch, n) int64 occupation indices,
        drawn on the VAN's device with ``generator`` (a ``torch.Generator`` on
        that device);
      log_prob(van, state_idx (batch, n)) -> (batch,) exact log p.
    """
    M = num_states
    sp_indices = np.asarray(sp_indices)

    tables = {}  # the embedding table once per device and dtype: no host copy a draw

    def _table(van: Transformer):
        p = van.x1hat
        if (p.device, p.dtype) not in tables:
            tables[p.device, p.dtype] = torch.as_tensor(sp_indices, dtype=p.dtype,
                                                        device=p.device)
        return tables[p.device, p.dtype]

    def _mask(state_idx):
        """(B, n, M) boolean mask of allowed states given the sampled prefix."""
        dev = state_idx.device
        m = torch.arange(M, device=dev)
        band = m[None, :] <= (M - n + torch.arange(n, device=dev))[:, None]
        idx_lb = torch.cat(
            [state_idx.new_full((*state_idx.shape[:-1], 1), -1), state_idx[..., :-1]],
            dim=-1)
        return (m > idx_lb[..., None]) & band

    def _row_mask(i: int, prev_idx):
        """Allowed-state mask (B, M) for particle i given the previous index."""
        m = torch.arange(M, device=prev_idx.device)
        return (m > prev_idx[:, None]) & (m <= M - n + i)

    @torch.no_grad()
    def sampler(van: Transformer, generator, batch: int):
        """Draw a batch of occupation states with KV-cached decoding.

        Exactly n-1 decode steps: particle 0 is drawn from the learned
        ``x1hat`` logits with no transformer run, and each decode of token
        i-1 yields the row-i logits for the next draw.
        """
        p = van.x1hat
        table = _table(van)
        kc, vc = init_kv_cache(van.cfg, batch, n, p.dtype, p.device)
        neg = p.new_full((), _NEG_INF)
        prev = torch.full((batch,), -1, dtype=torch.long, device=p.device)
        logits = p.expand(batch, M)
        samples, lows, highs, row_sums = [], [], [], []
        for i in range(n):
            if i > 0:
                logits, kc, vc = transformer_decode_step(van, table[prev], i - 1, kc, vc)
            probs = torch.softmax(torch.where(_row_mask(i, prev), logits, neg), dim=-1)
            prev = draw(probs, generator)
            samples.append(prev)
            low, high = torch.aminmax(probs)
            lows.append(low)
            highs.append(high)
            row_sums.append(probs.sum(dim=-1))
        # torch.multinomial's checks of every draw, once a batch and on the device
        assert_drawable(torch.stack(lows), torch.stack(highs), torch.stack(row_sums))
        return torch.stack(samples, dim=1)

    def log_prob(van: Transformer, state_idx):
        """Exact log p(state_idx) for (B, n) ordered occupation states."""
        logits = transformer_apply(van, _table(van)[state_idx])
        logits = torch.where(_mask(state_idx), logits, logits.new_full((), _NEG_INF))
        logp = torch.log_softmax(logits, dim=-1)
        return torch.gather(logp, -1, state_idx[..., None])[..., 0].sum(dim=-1)

    if mask_fn:
        return _mask, sampler, log_prob
    return sampler, log_prob


def make_classical_score(log_prob):
    """Per-sample scores d log p / d params of the VAN, for the SR Fisher.

    Returns ``score(van, state_idx (B, n)) -> S_c (B, P_van)``, raveled in
    the JAX package's parameter order (``io.convert.ravel_order``)."""

    def classical_score(van, state_idx):
        jac = per_sample_jacobian(log_prob, van, state_idx)
        return ravel_named(jac, ravel_order(van), batch_dims=1)

    return classical_score
