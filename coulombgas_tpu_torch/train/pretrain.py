"""Stage-1 free-fermion pretraining of the VAN.

Trains the autoregressive occupation model alone against the non-interacting
spectrum: loss E[logp * (F - F_mean)] with F = logp/beta + E(k), with
classical-Fisher SR or Adam, guarded by the update tripwire, and checked
against the exact mpmath canonical analytics printed at the start.
Counterpart of ``coulombgas_tpu/train/pretrain.py`` on one device.
"""

from __future__ import annotations

import copy
import math
import os

import numpy as np
import torch

from ..analytic.canonical import Z_E, box_parameters
from ..io.checkpoint import save_data
from ..io.convert import ravel_params, unravel_like, van_to_numpy
from ..io.logging import ObservableLog
from ..optim.host_sr import host_solve_scaled
from ..optim.sr import fisher_sr
from ..physics.orbitals import sp_orbitals, twist_sort
from ..sampling.autoregressive import make_autoregressive_sampler, make_classical_score
from .tripwire import UpdateTripwire

__all__ = ["make_freefermion_loss", "make_pretrain_step", "pretrain", "SOLVERS"]

SOLVERS = ("plain", "refined", "chol", "host64")


def make_freefermion_loss(log_prob, Es, beta, clip_factor=None):
    """REINFORCE loss for the non-interacting system (exact per-state E).

    ``log_prob(van, state_indices)`` is the VAN's exact log-probability,
    ``Es`` the (M,) single-particle energies in the VAN's state order.
    Returns ``loss_fn(van, state_indices) -> (loss, aux)``: the loss's
    gradient is the free-energy gradient; ``aux`` holds the batch means and
    (population) standard deviations of E, F and S, detached.

    ``clip_factor``: optional total-variation clipping of the centred
    REINFORCE weights (the interacting loss's 5xTV scheme); off by default.
    """
    Es = np.asarray(Es)
    tables = {}

    def loss_fn(van, state_indices):
        logp = log_prob(van, state_indices)
        key = (logp.device, logp.dtype)
        if key not in tables:
            tables[key] = torch.as_tensor(Es, dtype=logp.dtype, device=logp.device)
        E = tables[key][state_indices].sum(dim=-1)
        F = (logp / beta + E).detach()
        aux = {
            "E_mean": E.mean(), "E_std": E.std(correction=0),
            "F_mean": F.mean(), "F_std": F.std(correction=0),
            "S_mean": -logp.detach().mean(), "S_std": logp.detach().std(correction=0),
        }
        w = F - aux["F_mean"]
        if clip_factor is not None:
            tv = w.abs().mean()
            w = torch.clamp(w, -clip_factor * tv, clip_factor * tv)
        return (logp * w).mean(), aux

    return loss_fn


def make_pretrain_step(van, log_prob, loss_fn, lr, sr, damping, max_norm, solver="plain"):
    """One optimizer step of the pretraining on given draws.

    Returns ``(step, optimizer)``: ``step(state_indices, trust_scale=1.0)``
    updates ``van`` in place and returns the draws' observables as floats;
    ``optimizer`` is the Adam optimizer (``sr=False``) or None.  Under SR the
    classical Fisher of the draws preconditions the gradient: ``solver``
    ``plain | refined | chol`` solve in the working precision
    (``optim.sr.fisher_sr``), ``host64`` in float64 (``optim.host_sr``);
    ``trust_scale`` scales the trust radius ``max_norm`` (the tripwire's
    escalation).
    """
    if solver not in SOLVERS:
        raise ValueError("unknown solver %r (one of %s)" % (solver, ", ".join(SOLVERS)))
    params = list(van.parameters())
    optimizer = None
    if sr:
        score_fn = make_classical_score(log_prob)
        refined = solver in ("refined", "chol")
        sr_opt = fisher_sr(score_fn, damping, max_norm, refine=2 if refined else 0,
                           jacobi=refined, chol=solver == "chol")
    else:
        optimizer = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def step(state_indices, trust_scale=1.0):
        loss, aux = loss_fn(van, state_indices)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            if not sr:
                for p, g in zip(params, grads):
                    p.grad = g
                optimizer.step()
                optimizer.zero_grad(set_to_none=True)
            else:
                g = ravel_params(van, list(grads))
                if solver == "host64":
                    score = score_fn(van, state_indices)
                    fisher = score.T @ score / score.shape[0]
                    upd, _ = host_solve_scaled(fisher, g, damping, max_norm * trust_scale)
                else:
                    upd, _ = sr_opt.update(g, None, van, state_indices,
                                           max_norm_scale=trust_scale)
                for p, u in zip(params, unravel_like(upd, van)):
                    p.add_(u.to(p.dtype))
        return {k: float(v) for k, v in aux.items()}

    return step, optimizer


def pretrain(van, n, dim, Theta, Emax, twist, path, generator,
             lr, sr, damping, max_norm, batch, epoch=10000,
             check_analytic=True, dps=600, log_every=1, clip_factor=None,
             solver="plain", tripwire_sigma=15.0, ckpt_every=0, epoch_finished=0):
    """Train the VAN (in place, on its own device) on free fermions; returns it.

    Writes the 6-column ``data.txt`` into ``path``; with ``check_analytic``
    the exact F/E/S of the mpmath oracle are printed first.  ``generator`` is
    a ``torch.Generator`` on the VAN's device.  ``solver`` as in
    :func:`make_pretrain_step`.  The update tripwire (``tripwire_sigma``,
    0 = off) reverts the parameters and the optimizer state to the best
    healthy epoch when F jumps, and keeps such epochs out of ``data.txt``.
    With ``ckpt_every`` the parameters are saved to ``ckpt_van.pkl`` every
    that many epochs and at the end; ``epoch_finished`` offsets the epoch
    count of a resumed run.
    """
    L, beta = (float(v) for v in box_parameters(n, dim, Theta))

    sp_indices, _ = sp_orbitals(dim, Emax)
    sp_indices_twist, Es_twist = twist_sort(sp_indices, twist)
    # highest-energy states first, as the interacting training orders them
    sp_indices_twist = sp_indices_twist[::-1].copy()
    Es_twist = (2 * np.pi / L) ** 2 * np.asarray(Es_twist[::-1].copy())

    if check_analytic:
        from mpmath import mp, mpf

        F, E, S = Z_E(n, dim, mpf(str(Theta)), [mpf(str(t)) for t in np.asarray(twist)],
                      Emax, dps=dps)
        print("Analytic results for the thermodynamic quantities: "
              "F: %s, E: %s, S: %s" % (mp.nstr(F), mp.nstr(E), mp.nstr(S)))

    num_states = Es_twist.size
    sampler, log_prob = make_autoregressive_sampler(sp_indices_twist, n, num_states)
    loss_fn = make_freefermion_loss(log_prob, Es_twist.astype(np.float64), beta, clip_factor)
    step, optimizer = make_pretrain_step(van, log_prob, loss_fn, lr, sr, damping, max_norm,
                                         solver)

    log = ObservableLog(path, resume=epoch_finished > 0)
    sqrtb = math.sqrt(batch)
    # Observables at epoch i describe the parameters ENTERING epoch i; a jump
    # detected at i reverts to the best healthy snapshot (train/tripwire.py).
    tripwire = UpdateTripwire(sigma=tripwire_sigma)

    def snapshot():
        return ({k: v.detach().clone() for k, v in van.state_dict().items()},
                copy.deepcopy(optimizer.state_dict()) if optimizer is not None else None)

    def save_ckpt(i):
        if ckpt_every:
            save_data({"epoch": i, "params_van": van_to_numpy(van)},
                      os.path.join(path, "ckpt_van.pkl"))

    for i in range(epoch_finished + 1, epoch + 1):
        tripwire.snapshot(snapshot())
        with torch.no_grad():
            state_indices = sampler(van, generator, batch)
        a = step(state_indices, tripwire.trust_scale)
        F_raw, F_err = a["F_mean"], a["F_std"] / sqrtb
        finite = all(math.isfinite(a[k]) for k in ("F_mean", "E_mean", "S_mean", "F_std"))
        scale_before = tripwire.trust_scale
        revert_to = tripwire.check(F_raw, F_err, finite)
        if revert_to is not None:
            params, opt_state = revert_to
            van.load_state_dict(params)
            if optimizer is not None:
                optimizer.load_state_dict(opt_state)
            print("TRIPWIRE epoch %d: F=%.6f +- %.6f (finite=%s) -> revert"
                  % (i, F_raw, F_err, finite))
            if tripwire.trust_scale != scale_before:
                print("TRIPWIRE: event burst -> trust radius scaled to %g"
                      % (max_norm * tripwire.trust_scale))
            continue
        if i % log_every == 0:
            log.write_pretrain(i, F_raw, F_err, a["E_mean"], a["E_std"] / sqrtb,
                               a["S_mean"], a["S_std"] / sqrtb)
        if ckpt_every and i % ckpt_every == 0:
            save_ckpt(i)
    save_ckpt(epoch)
    log.close()
    return van
