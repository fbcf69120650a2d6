"""Stochastic reconfiguration (natural-gradient) optimizers.

Second-order updates from classical and quantum Fisher information matrices:
score outer products, mean-score centring of the quantum Fisher, damping,
dense solve, per-block trust-region scaling, negated update.  Counterpart of
``coulombgas_tpu/optim/sr.py``.

Parameters, gradients and updates are *raveled vectors* here, in the JAX
package's ``ravel_pytree`` order (``io.convert.ravel_order``), so that column
j of a score matrix and row/column j of a Fisher matrix mean the same
parameter in both packages; ``io.convert.ravel_params`` / ``unravel_like``
translate to and from a module's parameter list.

The Fisher build is a (batch x P)^T (batch x P) matrix product and the solves
are dense P x P (P ~ 1e3-1e4): both go to ``torch.matmul`` / ``torch.linalg``,
in true f32 on the GPU (TF32 is off, see ``config.py``: a TF32 Fisher at
lambda_max / damping ~ 6e8 is noise).  For the float64 solve
(``optim.host_sr``) ``add_fishers_`` forms and sums the blocks in float64
instead: a Gram summed in float32 is not positive semi-definite to within the
damping at n = 57.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..ops import counters
from ..utils.profiling import annotate

__all__ = ["fisher_sr", "hybrid_fisher_sr", "fishers_from_scores", "fisher_blocks",
           "add_fishers_", "quantum_score_mean", "FisherSR", "HybridFisherSR"]


def _solve_scaled(fisher, grads_raveled, damping, max_norm, refine: int = 0,
                  jacobi: bool = False, with_diag: bool = False,
                  chol: bool = False):
    """Damped dense solve + trust-region scaling; returns the *negated* step.

    The centred quantum Fisher is PSD only up to roundoff; in f32 the damped
    matrix can be numerically indefinite, so the default is a general LU
    solve.  The trust-region scale is ``min(sqrt(max_norm / g^T delta), 1)``
    with delta = M^{-1} g; in exact arithmetic g^T delta > 0, so a
    non-positive (or non-finite) value means the solve produced garbage
    curvature — in that case the step is ZEROED.  A final finiteness mask
    turns any remaining pathological solve into a null step instead of NaN
    parameters.  No factorization raises: the ``*_ex`` routines report a
    failure through ``info``, and a failed factor is overwritten with NaN so
    that it ends in the zero-step guard (a failed ``cholesky_ex`` otherwise
    leaves a finite, meaningless partial factor).

    f32 accuracy measures: ``jacobi`` solves (S M S) y = S g with
    S = diag(M)^(-1/2) — identical solution in exact arithmetic, far better
    f32 conditioning when the Fisher's diagonal spread dominates; ``refine``
    adds rounds of iterative refinement with full-precision residual
    products; ``chol`` factors the Jacobi-scaled system by Cholesky and, if
    that fails, once more with 32x the damping.  In float64 none of them is
    needed and all variants take the plain solve.

    Accuracy domain: every f32 variant is sound only while the damped
    system's condition number stays below ~1/eps_f32 ~ 1e7.  The n = 29
    production Fisher blocks have lambda_max / damping ~ 6e8; use
    ``optim.host_sr`` (``--sr_solver host64``) there.

    ``with_diag`` also returns {"gnorm", "scale"} so the training script can log when
    the guard fires.  Nothing here synchronizes with the host.
    """
    dtype = fisher.dtype
    P = fisher.shape[0]
    eye = torch.eye(P, dtype=dtype, device=fisher.device)
    nan = torch.full((), float("nan"), dtype=dtype, device=fisher.device)
    g = grads_raveled
    M = fisher + damping * eye
    if dtype == torch.float64 or not (jacobi or refine or chol):
        updates, info = torch.linalg.solve_ex(M, g)
        updates = torch.where(info == 0, updates, nan)
    else:
        s = torch.rsqrt(torch.diagonal(M)) if jacobi else torch.ones_like(g)
        Ms = M * s[:, None] * s[None, :]
        gs = g * s
        if chol:
            c, info = torch.linalg.cholesky_ex(Ms)
            bad = (info != 0) | ~torch.isfinite(c).all()
            Ms_b = Ms + (32.0 * damping) * eye
            c_b, info_b = torch.linalg.cholesky_ex(Ms_b)
            c_b = torch.where(info_b == 0, c_b, nan)
            c = torch.where(bad, c_b, c)
            Ms = torch.where(bad, Ms_b, Ms)
            solve = lambda rhs: torch.cholesky_solve(rhs[:, None], c)[:, 0]  # noqa: E731
        else:
            lu, piv, info = torch.linalg.lu_factor_ex(Ms)
            lu = torch.where(info == 0, lu, nan)
            solve = lambda rhs: torch.linalg.lu_solve(lu, piv, rhs[:, None])[:, 0]  # noqa: E731
        y = solve(gs)
        for _ in range(refine):
            r = gs - Ms @ y
            y = y + solve(r)
        updates = y * s
    gnorm = torch.sum(g * updates)
    ok = torch.isfinite(gnorm) & (gnorm > 0)
    scale = torch.where(
        ok,
        torch.clamp(torch.sqrt(max_norm / torch.where(ok, gnorm, torch.ones_like(gnorm))),
                    max=1.0),
        torch.zeros_like(gnorm),
    )
    updates = -scale * updates
    updates = torch.where(torch.isfinite(updates), updates, torch.zeros_like(updates))
    if with_diag:
        return updates, {"gnorm": gnorm, "scale": scale}
    return updates


class FisherSR(NamedTuple):
    """Classical-only SR (natural gradient); init/update pair."""

    init: Any
    update: Any


def fisher_sr(score_fn, damping, max_norm, refine: int = 0, jacobi: bool = False,
              chol: bool = False) -> FisherSR:
    """SR for the classical VAN alone (used by free-fermion pretraining).

    ``score_fn(van, state_indices)`` returns the raveled per-sample scores
    (B, P).  ``update(grads_raveled, state, van, state_indices)`` returns
    (raveled update, state); the state carries the trust-region diagnostics
    of the last solve.
    """

    def init_fn(params=None):
        return {"gnorm": torch.zeros(()), "scale": torch.zeros(())}

    @torch.no_grad()
    def update_fn(grads_raveled, state, van, state_indices, max_norm_scale=1.0):
        score = score_fn(van, state_indices)
        fisher = score.T @ score / score.shape[0]
        return _solve_scaled(fisher, grads_raveled, damping, max_norm * max_norm_scale,
                             refine=refine, jacobi=jacobi, chol=chol, with_diag=True)

    return FisherSR(init_fn, update_fn)


def fishers_from_scores(classical_score, quantum_score):
    """(S_c (B, P_c), S_q (B, P_q) complex) -> the hybrid-SR Fisher payload
    (classical_fisher, quantum_fisher, quantum_score_mean).  The mean is
    stacked as a real (2, P) tensor [Re, Im], the accumulators' layout."""
    return (*fisher_blocks(classical_score, quantum_score),
            quantum_score_mean(quantum_score))


def fisher_blocks(classical_score, quantum_score):
    """The two Fisher blocks of ``fishers_from_scores``, in the scores'
    precision: (S_c^T S_c / B, Re(S_q^H S_q) / B)."""
    batch = classical_score.shape[0]
    classical_fisher = classical_score.T @ classical_score / batch
    # Re(S^H S) = Sr^T Sr + Si^T Si
    sr_, si_ = quantum_score.real, quantum_score.imag
    quantum_fisher = (sr_.T @ sr_ + si_.T @ si_) / batch
    return classical_fisher, quantum_fisher


def quantum_score_mean(quantum_score):
    """The batch mean of S_q (B, P_q) complex as a real (2, P_q) [Re, Im]."""
    qsm = quantum_score.mean(dim=0)
    return torch.stack([qsm.real, qsm.imag])


def add_fishers_(classical_fisher, quantum_fisher, classical_score, quantum_score,
                 weight=1.0):
    """Add ``weight`` x the batch's Fisher blocks to the two accumulators in
    place, in the accumulators' precision: the scores are cast to it and
    their Gram is added by ``addmm_``, so no second (P, P) matrix is formed.
    The quantum block's Sr^T Sr + Si^T Si is one product of [Sr; Si].

    In float64 the sum is the Gram of the float32 scores to float64
    rounding, positive semi-definite well within the damping.  Formed and
    summed in float32 it is not: at n = 57 (P_van 7050) the damped
    classical block has a negative eigenvalue, and the float64 solve falls
    from Cholesky to LU and takes a step several times too long."""
    batch = classical_score.shape[0]
    s = classical_score.to(classical_fisher.dtype)
    classical_fisher.addmm_(s.T, s, alpha=weight / batch)
    q = torch.cat([quantum_score.real, quantum_score.imag]).to(quantum_fisher.dtype)
    quantum_fisher.addmm_(q.T, q, alpha=weight / batch)


class HybridFisherSR(NamedTuple):
    """Joint classical+quantum SR: the scores and fishers functions + init/update."""

    fishers: Any
    init: Any
    update: Any
    scores: Any = None


def hybrid_fisher_sr(classical_score_fn, quantum_score_fn, damping, max_norm,
                     refine: int = 0, jacobi: bool = False,
                     chol: bool = False) -> HybridFisherSR:
    """Hybrid SR over (van, flow).

    ``scores(van, flow, state_indices, x)`` returns the raveled per-sample
    score matrices (S_c (B, P_van), S_q (B, P_flow) complex) — everything the
    SR step needs derives from these: the Fisher matrices, the mean scores,
    AND the REINFORCE gradients (grad = S^T w / B with w the clipped
    per-sample weights), which lets the training step skip its loss
    gradients entirely in SR mode.  ``fishers(...)`` returns
    (classical_fisher, quantum_fisher, quantum_score_mean), each a batch
    average.  ``update((grad_van, grad_flow) raveled, state, fishers,
    max_norm_scale)`` returns ((update_van, update_flow) raveled, diagnostics).
    """

    def scores_fn(van, flow, state_indices, x):
        return classical_score_fn(van, state_indices), quantum_score_fn(x, flow, state_indices)

    def fishers_fn(van, flow, state_indices, x):
        return fishers_from_scores(*scores_fn(van, flow, state_indices, x))

    def init_fn(params=None):
        z = torch.zeros(())
        return {"gnorm_van": z, "scale_van": z, "gnorm_flow": z, "scale_flow": z}

    @torch.no_grad()
    def update_fn(grads, state, fishers, max_norm_scale=1.0):
        # ``max_norm_scale``: dynamic trust-region escalation factor (an
        # update tripwire shrinks it on persistent event bursts).
        grad_van, grad_flow = grads
        classical_fisher, quantum_fisher, qsm = fishers
        # Centre the quantum Fisher: subtract Re(conj(qsm) qsm^T).
        quantum_fisher = quantum_fisher - (torch.outer(qsm[0], qsm[0])
                                           + torch.outer(qsm[1], qsm[1]))
        scaled_norm = max_norm * max_norm_scale
        with annotate("sr.solve"), counters.timed("sr.solve"):
            upd_van, diag_van = _solve_scaled(classical_fisher, grad_van, damping, scaled_norm,
                                              refine=refine, jacobi=jacobi, chol=chol,
                                              with_diag=True)
            upd_flow, diag_flow = _solve_scaled(quantum_fisher, grad_flow, damping,
                                                scaled_norm, refine=refine, jacobi=jacobi,
                                                chol=chol, with_diag=True)
        diag = {"gnorm_van": diag_van["gnorm"], "scale_van": diag_van["scale"],
                "gnorm_flow": diag_flow["gnorm"], "scale_flow": diag_flow["scale"]}
        return (upd_van, upd_flow), diag

    return HybridFisherSR(fishers_fn, init_fn, update_fn, scores_fn)
