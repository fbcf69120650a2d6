"""Per-sample parameter derivatives of batched model functions.

Stochastic reconfiguration needs the score of every sample, d log p_b / d theta
and d log Psi_b / d theta, not the gradient of a batch mean.  The walkers are
independent, so the function is evaluated sample by sample under
``torch.func.vmap(torch.func.jacrev(...))`` with the module's parameters
handed in as a dictionary — one batched reverse pass, B-wide, whatever the
number of parameters.  The JAX package does the same with
``jax.vmap(jax.grad(...))``.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["per_sample_jacobian"]


class _Bound(nn.Module):
    """``fn(module, *args)`` as a module's forward, so that
    ``torch.func.functional_call`` can swap the parameters ``fn`` reads."""

    def __init__(self, module: nn.Module, fn):
        super().__init__()
        self.module, self.fn = module, fn

    def forward(self, *args):
        return self.fn(self.module, *args)


def per_sample_jacobian(fn, module: nn.Module, *batched):
    """Derivative of each sample's ``fn`` value in the parameters of ``module``.

    ``fn(module, *args)`` takes arguments with a leading batch dimension and
    returns ``(batch, *out)``, sample b depending on ``args[.][b]`` only; it
    is called with batches of one.  Returns ``{parameter name: (B, *out,
    *parameter.shape)}`` without an autograd graph.  The reverse pass holds
    the whole batch's activations; a caller bounds memory by the batch it hands
    in (``--microbatch``).
    """
    bound = _Bound(module, fn)
    prefix = "module."
    params = {prefix + k: v.detach() for k, v in module.named_parameters()}

    def one(params, *args):
        return torch.func.functional_call(bound, params, tuple(a[None] for a in args))[0]

    # Grad mode is switched on whatever the caller's: under an outer
    # ``no_grad`` the backward of a complex ``slogdet`` takes another branch
    # inside PyTorch, which under ``vmap`` gives wrong numbers.
    with torch.enable_grad():
        jac = torch.func.vmap(torch.func.jacrev(one),
                              in_dims=(None,) + (0,) * len(batched))(params, *batched)
    return {k[len(prefix):]: v for k, v in jac.items()}
