"""Causal-transformer variational autoregressive network (VAN).

Models the classical distribution p(k_1 < k_2 < ... < k_n) over ordered
momentum-occupation indices: embedding -> [causal attention + tanh MLP]
residual blocks -> output head, with a learned first-row parameter ``x1hat``
and the outputs shifted down one row so row i depends only on tokens < i.

Counterpart of ``coulombgas_tpu/models/transformer.py``.  The parameters live
in an ``nn.Module`` whose names map one-to-one onto the reference pytree
(``embed.w``, ``layers.{i}.attn.q.w``, ``layers.{i}.mlp.fc1.b``, ``out.w``,
``x1hat``).  Attention is written in plain tensor ops.  A single-token decode
step with per-layer K/V caches lets the sampler run O(n) token evaluations
per sample.  All functions take a leading batch dimension.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from ..config import resolve_device
from .ferminet import Linear

__all__ = [
    "TransformerConfig",
    "Transformer",
    "init_transformer_params",
    "transformer_apply",
    "init_kv_cache",
    "transformer_decode_step",
]

_NEG_INF = -1e30  # large finite negative; safe in an f32 softmax


@dataclass(frozen=True)
class TransformerConfig:
    """Static hyperparameters of the VAN."""

    output_size: int  # number of single-particle states M
    num_layers: int
    model_size: int
    num_heads: int
    hidden_size: int

    def __post_init__(self):
        if self.model_size % self.num_heads != 0:
            raise ValueError(
                "model_size must be divisible by num_heads, got "
                f"{self.model_size} / {self.num_heads}"
            )

    @property
    def key_size(self) -> int:
        return self.model_size // self.num_heads


class _Attention(nn.Module):
    def __init__(self, D, dtype, device):
        super().__init__()
        self.q = Linear(D, D, dtype, device)
        self.k = Linear(D, D, dtype, device)
        self.v = Linear(D, D, dtype, device)
        self.o = Linear(D, D, dtype, device)


class _MLP(nn.Module):
    def __init__(self, D, H, dtype, device):
        super().__init__()
        self.fc1 = Linear(D, H, dtype, device)
        self.fc2 = Linear(H, D, dtype, device)

    def forward(self, h):
        return self.fc2(torch.tanh(self.fc1(h)))


class _Block(nn.Module):
    def __init__(self, D, H, dtype, device):
        super().__init__()
        self.attn = _Attention(D, dtype, device)
        self.mlp = _MLP(D, H, dtype, device)


class Transformer(nn.Module):
    """Parameter container of the VAN; ``forward`` is ``transformer_apply``."""

    def __init__(self, cfg: TransformerConfig, input_size: int, dtype=None, device=None):
        super().__init__()
        self.cfg, self.input_size = cfg, input_size
        D, H, M = cfg.model_size, cfg.hidden_size, cfg.output_size
        self.embed = Linear(input_size, D, dtype, device)
        self.layers = nn.ModuleList(
            [_Block(D, H, dtype, device) for _ in range(cfg.num_layers)])
        self.out = Linear(D, M, dtype, device)
        self.x1hat = nn.Parameter(torch.zeros(M, dtype=dtype, device=device))

    def forward(self, x):
        return transformer_apply(self, x)


def _variance_scaling(gen, shape, scale, mode="fan_in"):
    """Truncated-normal variance-scaling init (fan_in/fan_out on 2D weights)."""
    fan = shape[0] if mode == "fan_in" else shape[-1]
    stddev = math.sqrt(scale / max(1.0, fan)) / 0.87962566103423978
    w = torch.empty(shape, dtype=torch.float64)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return stddev * w


def init_transformer_params(cfg: TransformerConfig, input_size: int, generator=None,
                            dtype=torch.float32, device=None) -> Transformer:
    """VAN with the reference's init scales (init_scale = 0.02 / num_layers,
    variance-scaling truncated normals, x1hat ~ TruncatedNormal with stddev
    sqrt(init_scale / output_size)); draws made on the CPU from ``generator``
    and copied to ``device`` (``None`` means CUDA and raises where there is
    none)."""
    van = Transformer(cfg, input_size, dtype, resolve_device(device))
    scale = 0.02 / cfg.num_layers
    M = cfg.output_size
    with torch.no_grad():
        for name, p in van.named_parameters():
            if name.endswith(".w"):
                mode = "fan_out" if name == "embed.w" else "fan_in"
                p.copy_(_variance_scaling(generator, p.shape, scale, mode).to(dtype))
        x1 = torch.empty(M, dtype=torch.float64)
        nn.init.trunc_normal_(x1, 0.0, 1.0, -2.0, 2.0, generator=generator)
        van.x1hat.copy_((math.sqrt(scale / M) * x1).to(dtype))
    return van


def _causal_attention(p: _Attention, h, cfg: TransformerConfig):
    """Multi-head self-attention with a causal mask; h (B, n, D) -> (B, n, D)."""
    B, n, D = h.shape
    nh, hd = cfg.num_heads, cfg.key_size
    q = p.q(h).reshape(B, n, nh, hd)
    k = p.k(h).reshape(B, n, nh, hd)
    v = p.v(h).reshape(B, n, nh, hd)
    logits = torch.einsum("bthd,bThd->bhtT", q, k) / math.sqrt(hd)
    causal = torch.tril(torch.ones(n, n, dtype=torch.bool, device=h.device))
    logits = torch.where(causal, logits, logits.new_full((), _NEG_INF))
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhtT,bThd->bthd", w, v).reshape(B, n, D)
    return p.o(o)


def transformer_apply(van: Transformer, x):
    """Full forward pass on token sequences.

    INPUT:  x (B, n, input_size) — the (twisted) momentum vectors of the
            occupied orbitals, as floats.
    OUTPUT: (B, n, M) logits, where row i depends only on tokens < i: the raw
            head outputs are shifted down one row and row 0 is ``x1hat``.
    """
    cfg = van.cfg
    h = torch.tanh(van.embed(x))
    for layer in van.layers:
        h = h + _causal_attention(layer.attn, h, cfg)
        h = h + layer.mlp(h)
    logits = van.out(torch.tanh(h))
    first = van.x1hat.expand(x.shape[0], 1, -1)
    return torch.cat([first, logits[:, :-1]], dim=1)


def init_kv_cache(cfg: TransformerConfig, batch: int, n: int, dtype=torch.float32,
                  device=None):
    """Per-layer K/V caches of static length n: (B, layers, n, heads, key_size);
    ``device=None`` means CUDA and raises where there is none."""
    device = resolve_device(device)
    shape = (batch, cfg.num_layers, n, cfg.num_heads, cfg.key_size)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def transformer_decode_step(van: Transformer, token, pos: int, kcache, vcache):
    """Process one token per sequence at position ``pos``; next-row logits.

    Equals ``transformer_apply(...)[:, pos + 1]`` when the caches hold the K/V
    of all tokens < pos, at the cost of one token.  The caches are updated in
    place (they are the sampler's own scratch).

    INPUT:  token (B, input_size); caches as from ``init_kv_cache``.
    OUTPUT: logits (B, M), the caches.
    """
    cfg = van.cfg
    nh, hd = cfg.num_heads, cfg.key_size
    B = token.shape[0]
    n = kcache.shape[2]
    valid = torch.arange(n, device=token.device) <= pos
    h = torch.tanh(van.embed(token))
    for li, layer in enumerate(van.layers):
        p = layer.attn
        q = p.q(h).reshape(B, nh, hd)
        kcache[:, li, pos] = p.k(h).reshape(B, nh, hd)
        vcache[:, li, pos] = p.v(h).reshape(B, nh, hd)
        logits = torch.einsum("bhd,bThd->bhT", q, kcache[:, li]) / math.sqrt(hd)
        logits = torch.where(valid, logits, logits.new_full((), _NEG_INF))
        w = torch.softmax(logits, dim=-1)
        o = torch.einsum("bhT,bThd->bhd", w, vcache[:, li]).reshape(B, -1)
        h = h + p.o(o)
        h = h + layer.mlp(h)
    return van.out(torch.tanh(h)), kcache, vcache
