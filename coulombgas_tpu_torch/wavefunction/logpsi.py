"""Assembly of log Psi.

log Psi_k(x) = log det[planewave_k(z)] + 1/2 log det(dz/dx),  z = flow(x).

Counterpart of ``coulombgas_tpu/wavefunction/logpsi.py:make_logpsi_fast``:
complex results are carried as real pairs (Re, Im) so that autograd stays
real.  The generic-AD engines of the reference are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.convert import ravel_named, ravel_order
from ..models.per_sample import per_sample_jacobian
from ..models.slater import logslaterdet
from ..ops.logdet import logdet_spd_single

__all__ = ["make_logpsi_fast", "make_quantum_score", "to_complex"]


def make_logpsi_fast(flow_jac, sp_indices, L):
    """logpsi via the analytic flow Jacobian + differentiable Gram log-det.

    ``logpsi(x (B, n, dim), flow, state_idx (B, n)) -> (B, 2)`` =
    [Re log Psi, Im log Psi].  ``flow_jac(flow, x) -> (z, J (B, nd, nd))`` is
    the pair-local analytic Jacobian (models/ferminet_jac.py), and the
    1/2 log|det J| term is 1/4 log det(J J^T) through the pivot-free Cholesky
    with closed-form derivatives (ops/logdet.py).
    """
    sp_indices = np.asarray(sp_indices)

    def logpsi(x, flow, state_idx):
        z, J = flow_jac(flow, x)
        table = torch.as_tensor(sp_indices, dtype=x.dtype, device=x.device)
        log_phi = logslaterdet(table[state_idx], z, L)
        logjacdet = 0.5 * logdet_spd_single(J @ J.transpose(-1, -2))  # log|det J|
        return torch.stack([log_phi[..., 0] + 0.5 * logjacdet, log_phi[..., 1]], dim=-1)

    return logpsi


def to_complex(pair):
    """(…, 2) real pair [Re, Im] -> complex."""
    return torch.complex(pair[..., 0], pair[..., 1])


def make_quantum_score(logpsi):
    """Per-sample d log Psi / d flow-params (complex), for the quantum Fisher.

    Returns ``score(x (B, n, dim), flow, state_idx (B, n)) -> S_q (B, P_flow)``
    complex, ``d Re log Psi + i d Im log Psi``, raveled in the JAX package's
    parameter order (``io.convert.ravel_order``)."""

    def quantum_score(x, flow, state_idx):
        jac = per_sample_jacobian(lambda f, xx, si: logpsi(xx, f, si), flow, x, state_idx)
        pair = ravel_named(jac, ravel_order(flow), batch_dims=2)  # (B, 2, P)
        return torch.complex(pair[:, 0], pair[:, 1])

    return quantum_score
