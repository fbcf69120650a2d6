"""Float64 SR apply step (``--sr_solver host64``).

The n = 29 production Fisher blocks have lambda_max / damping ~ 6e8, beyond
what any f32 factorization resolves (see ``optim/sr.py``), so the float64
option does the whole apply — baseline correction, quantum-Fisher centring,
damped Cholesky solves, trust-region scaling — in float64 and hands back
raveled updates.  Counterpart of ``coulombgas_tpu/optim/host_sr.py``, whose
name it keeps: there the float64 arithmetic had to run on the host, behind a
packed device-to-host transfer of the Fisher matrices; a GPU has float64
units, so here the solve runs on whichever device holds the accumulators and
nothing is packed or transferred.  What is kept is the contract: the same
numbers as the plain f64 apply, and a cache that reuses the classical factor
for K epochs (``--fisher_refresh K``) while the quantum block stays fresh.

``sym_pack`` / ``sym_unpack`` / ``damped_upper`` are the numpy helpers of the
packed-triangle layout, kept for reading and writing accumulators in that
layout (bitwise equal to the JAX package's).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..io.convert import ravel_params
from ..ops import counters
from ..utils.profiling import annotate

__all__ = ["host_solve_scaled", "host_hybrid_apply", "sym_pack", "sym_unpack",
           "damped_upper", "HostFisherCache"]


@functools.lru_cache(maxsize=4)
def _triu_indices(P):
    return np.triu_indices(P)


def sym_pack(M):
    """Upper triangle (incl. diagonal) of a (P, P) symmetric array as a flat
    vector, row-major; inverted by :func:`sym_unpack`."""
    M = np.asarray(M)
    iu = _triu_indices(M.shape[-1])
    return M[..., iu[0], iu[1]]


def _packed_dim(m):
    P = int(round((np.sqrt(8.0 * m + 1.0) - 1.0) / 2.0))
    if P * (P + 1) // 2 != m:
        raise ValueError("not a packed triangle length: %d" % m)
    return P


def sym_unpack(v, dtype=np.float64):
    """Inverse of :func:`sym_pack`: the full symmetric (P, P) matrix."""
    v = np.ascontiguousarray(v, dtype)
    P = _packed_dim(v.shape[-1])
    M = np.empty(v.shape[:-1] + (P, P), dtype)
    iu = _triu_indices(P)
    M[..., iu[0], iu[1]] = v
    M[..., iu[1], iu[0]] = v
    return M


def damped_upper(v, divisor, damping, dtype=np.float64):
    """Packed triangle -> (M / divisor + damping I) with only the UPPER
    triangle written (the lower is left uninitialized): what an upper
    Cholesky reads.  Elementwise equal to
    ``sym_unpack(v) / divisor + damping * eye`` on that triangle."""
    v = np.ascontiguousarray(v, dtype)
    if divisor != 1:
        v = v / dtype(divisor)
    P = _packed_dim(v.shape[-1])
    M = np.empty((P, P), dtype)
    iu = _triu_indices(P)
    M[iu[0], iu[1]] = v
    M[np.diag_indices(P)] += damping
    return M


def _f64(a, device=None):
    """Float64 tensor (on ``device``, default: where it lies) from a tensor or
    a numpy array."""
    if not torch.is_tensor(a):
        a = torch.from_numpy(np.asarray(a, np.float64))
    return a.to(device=device, dtype=torch.float64)


def _full_matrix(a, device=None):
    """Float64 (P, P) matrix from a full matrix or a packed upper triangle."""
    if a.ndim == 1:
        a = sym_unpack(a.detach().cpu().numpy() if torch.is_tensor(a) else a)
    return _f64(a, device)


def _scale_step(upd, g, max_norm):
    """Trust-region scaling + zero-step guard: a non-positive or non-finite
    curvature g^T M^{-1} g means the solve is untrustworthy -> null step."""
    gnorm = float(g @ upd)
    if not np.isfinite(gnorm) or gnorm <= 0.0:
        return torch.zeros_like(upd), {"gnorm": gnorm, "scale": 0.0}
    scale = min(float(np.sqrt(max_norm / gnorm)), 1.0)
    upd = -scale * upd
    upd = torch.where(torch.isfinite(upd), upd, torch.zeros_like(upd))
    return upd, {"gnorm": gnorm, "scale": scale}


def _damped_solve(A, g):
    """(A already damped) Cholesky solve; LU where the matrix is not
    numerically positive definite (the centred quantum Fisher can be so),
    counted in ``counters.events["sr.lu_fallbacks"]``."""
    c, info = torch.linalg.cholesky_ex(A)
    if int(info) == 0:
        return torch.cholesky_solve(g[:, None], c)[:, 0]
    counters.count("sr.lu_fallbacks")
    upd, info = torch.linalg.solve_ex(A, g)
    return upd if int(info) == 0 else torch.full_like(g, float("nan"))


def host_solve_scaled(fisher, grads, damping, max_norm):
    """f64 damped solve + trust-region scaling; returns (-scaled step, diag).

    Same semantics as ``optim.sr._solve_scaled``, in float64 by Cholesky, on
    the device that holds ``fisher``.  Never NaN: a failed solve is a zero step.
    """
    A = _full_matrix(fisher)
    g = _f64(grads, A.device)
    A = A + damping * torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    return _scale_step(_damped_solve(A, g), g, max_norm)


class HostFisherCache:
    """k-epoch stale-Fisher state for ``--sr_solver host64 --fisher_refresh K``.

    The Fisher is a Monte-Carlo estimate that changes slowly relative to its
    own sampling noise, so — as KFAC refreshes its preconditioner every N
    steps — the classical block's Cholesky factor (P_van ~ 5.8k at n = 29,
    the expensive one) is refreshed every K epochs while gradients, scores
    and the trust-region logic stay per-epoch.  Only the classical block is
    amortized: its cached factor is of (F + damping I), SPD by construction,
    so a stale classical solve can never zero-step.  A frozen quantum second
    moment, by contrast, goes indefinite against the moving mean score (the
    centring subtracts the CURRENT rank-1 outer product), so the quantum
    block is taken fresh whenever the accumulators carry one; the frozen
    copy serves only accumulators without it.  K = 1 is plain host64.
    """

    def __init__(self, damping):
        self.damping = float(damping)
        self._c_factor = None   # lower Cholesky factor of (classical Fisher + damping I)
        self._qf = None         # stale UNCENTRED quantum Fisher (f64)
        self.age = 0            # epochs since the last refresh

    @property
    def ready(self):
        return self._c_factor is not None

    def refresh(self, classical_fisher, quantum_fisher, divisor=1):
        """Install fresh Fisher blocks (sums over ``divisor`` accumulation
        steps, or already-normalized matrices with the default)."""
        M = _full_matrix(classical_fisher) / divisor
        M = M + self.damping * torch.eye(M.shape[0], dtype=M.dtype, device=M.device)
        c, info = torch.linalg.cholesky_ex(M)
        if int(info) != 0:
            raise RuntimeError("the damped classical Fisher is not positive definite")
        self._c_factor = c
        self._qf = _full_matrix(quantum_fisher, M.device) / divisor
        self.age = 0

    def solve_classical(self, grads, max_norm):
        """f64 solve via the cached factorization + trust-region scaling."""
        g = _f64(grads, self._c_factor.device)
        return _scale_step(torch.cholesky_solve(g[:, None], self._c_factor)[:, 0], g, max_norm)

    def solve_quantum(self, grads, qsm, max_norm):
        """Centre the stale quantum Fisher with the CURRENT mean score
        ``qsm`` (2, P) [Re, Im], solve."""
        return _solve_centred(self._qf, grads, qsm, self.damping, max_norm)


def _solve_centred(qf, grads, qsm, damping, max_norm):
    qsm = _f64(qsm, qf.device)
    qf = qf - (torch.outer(qsm[0], qsm[0]) + torch.outer(qsm[1], qsm[1]))
    return host_solve_scaled(qf, grads, damping, max_norm)


def _raveled(entry, module, device):
    """An accumulator entry as a raveled f64 vector: a list in the order of
    ``module.parameters()``, or a vector that is raveled already."""
    if isinstance(entry, (list, tuple)):
        entry = ravel_params(module, list(entry))
    return _f64(entry, device)


def host_hybrid_apply(acc, acc_steps, damping, max_norm, cache=None, van=None, flow=None):
    """The hybrid-SR apply in float64 from the accumulators.

    ``acc`` has the layout of ``train.init_accumulators(sr=True)``, each entry
    a SUM over ``acc_steps`` accumulation steps; gradients and mean scores are
    lists in the order of ``van.parameters()`` / ``flow.parameters()`` (then
    ``van`` and ``flow`` are needed to ravel them) or raveled vectors.  With
    ``cache`` (a :class:`HostFisherCache`) the classical block comes from the
    cache; if ``acc`` carries 'classical_fisher' the cache is refreshed from it
    first (a refresh epoch), and the quantum block is taken fresh whenever
    ``acc`` carries 'quantum_fisher'.

    Returns (upd_van, upd_flow, data, diag): raveled f64 update vectors (JAX
    parameter order), the normalized observables and the two solves'
    diagnostics as Python floats.
    """
    first = acc["quantum_score_mean"]
    device = first.device if torch.is_tensor(first) else None
    data = {k: float(v) / acc_steps for k, v in acc["data"].items()}

    grad_van = _raveled(acc["grads"][0], van, device) / acc_steps
    grad_flow = _raveled(acc["grads"][1], flow, device) / acc_steps
    score_van = _raveled(acc["classical_score"], van, device) / acc_steps
    score_flow = _raveled(acc["quantum_score"], flow, device) / acc_steps
    # REINFORCE baseline correction, in f64
    grad_van = grad_van - data["F_mean"] * score_van
    grad_flow = grad_flow - data["E_mean"] * score_flow
    qsm = _f64(acc["quantum_score_mean"], device) / acc_steps

    with annotate("sr.solve"), counters.timed("sr.solve"):
        if cache is not None:
            if "classical_fisher" in acc:  # refresh epoch
                cache.refresh(acc["classical_fisher"], acc["quantum_fisher"],
                              divisor=acc_steps)
                upd_flow, diag_flow = cache.solve_quantum(grad_flow, qsm, max_norm)
            else:
                cache.age += 1
                if "quantum_fisher" in acc:  # fresh quantum block on a stale-classical epoch
                    qf = _full_matrix(acc["quantum_fisher"], device) / acc_steps
                    upd_flow, diag_flow = _solve_centred(qf, grad_flow, qsm, damping, max_norm)
                else:
                    upd_flow, diag_flow = cache.solve_quantum(grad_flow, qsm, max_norm)
            upd_van, diag_van = cache.solve_classical(grad_van, max_norm)
        else:
            cf = _full_matrix(acc["classical_fisher"], device) / acc_steps
            upd_van, diag_van = host_solve_scaled(cf, grad_van, damping, max_norm)
            qf = _full_matrix(acc["quantum_fisher"], device) / acc_steps
            upd_flow, diag_flow = _solve_centred(qf, grad_flow, qsm, damping, max_norm)
    diag = {"gnorm_van": diag_van["gnorm"], "scale_van": diag_van["scale"],
            "gnorm_flow": diag_flow["gnorm"], "scale_flow": diag_flow["scale"]}
    return upd_van, upd_flow, data, diag
