"""The reference of the training epochs: observables, REINFORCE gradients,
scores and Fisher matrices, and the Adam or stochastic-reconfiguration
update, worked out from the benchmark's inputs and the program's samples.

One epoch is ``acc_steps`` rounds; a round is a global batch of walkers
(x, their occupation states, and under Hutchinson the probe v), which the
program sampled.  Per walker:

    E_loc = -lap log Psi - (grad log Psi)^2 + V(x) + Vconst,
    F_loc = log p(state) / beta + Re E_loc,

and per microbatch chunk of a round the REINFORCE weights are clipped to
mean +- 5 mean|deviation|.  The gradients of the free energy are

    grad_van  = mean(F_loc_clipped d log p) - F * mean(d log p),
    grad_flow = 2 Re mean(E_loc_clipped^* d log Psi) - E * 2 mean(d Re log Psi),

averaged over the rounds.  Adam (torch's rule) or SR (damped solves of the
classical Fisher and the centred quantum Fisher, each step scaled into the
trust region sqrt(max_norm / g^T F^-1 g)) then updates the parameters.

Walkers are processed in blocks of ``block`` so that the reverse passes fit.
"""

from __future__ import annotations

import math

import torch

from . import model

OBSERVABLES = ("F", "E", "K", "V", "S")
CLIP = 5.0


class Problem:
    """The constants of one configuration, on one device and dtype."""

    def __init__(self, cfg: dict, device, dtype):
        self.cfg, self.device, self.dtype = cfg, device, dtype
        n, dim = cfg["n"], cfg["dim"]
        self.L, self.beta = model.box(n, dim, cfg["Theta"])
        table = model.twisted_momenta(dim, cfg["Emax"], cfg["twist"])
        self.table = torch.as_tensor(table, dtype=dtype, device=device)
        self.G = model.kpoints(dim, cfg["Gmax"])
        self.Vconst = n * cfg["rs"] / self.L * model.madelung(dim, cfg["kappa"], self.G)

    def momenta(self, states):
        return 2 * math.pi / self.L * self.table[states]

    def log_prob(self, P_van, states):
        c = self.cfg
        return model.van_log_prob(P_van, self.table, states, c["nlayers"], c["nheads"])

    def logpsi(self, P_flow, x, states):
        return model.logpsi(P_flow, x, self.momenta(states), self.cfg["depth"], self.L)

    def metropolis_logp(self, P_flow, x, states):
        """2 Re log Psi: the density the Metropolis walk samples."""
        with torch.no_grad():
            return 2 * self.logpsi(P_flow, x, states)[:, 0]

    def local(self, P_van, P_flow, x, states, probe):
        """(F_loc (B,), E_loc (B,) complex, K (B,), V (B,), log p (B,))."""
        c = self.cfg
        g, lap = model.grad_laplacian(P_flow, x, self.momenta(states), c["depth"], self.L,
                                      probe)
        with torch.no_grad():
            kinetic = -lap - (g**2).sum(dim=(-2, -1))
            pot = model.potential(x, c["kappa"], self.G, self.L, c["rs"]) + self.Vconst
            logp = self.log_prob(P_van, states)
            E = kinetic + pot
            return logp / self.beta + E.real, E, kinetic.real, pot, logp


def _clip(F, E, chunk):
    """Clipped REINFORCE weights, one window per chunk of ``chunk`` walkers."""
    Fc, Ec = torch.empty_like(F), torch.empty_like(E)
    for s in range(0, F.shape[0], chunk):
        f, e = F[s:s + chunk], E[s:s + chunk]
        fm, em = f.mean(), e.real.mean()
        tf, te = (f - fm).abs().mean(), (e - em).abs().mean()
        Fc[s:s + chunk] = torch.clamp(f, fm - CLIP * tf, fm + CLIP * tf)
        Ec[s:s + chunk] = torch.complex(torch.clamp(e.real, em - CLIP * te, em + CLIP * te),
                                        e.imag)
    return Fc, Ec


def _unravel(vec, like: dict) -> dict:
    out, i = {}, 0
    for k, v in like.items():
        out[k] = vec[i:i + v.numel()].reshape(v.shape)
        i += v.numel()
    return out


def _per_sample(fn, P, *batched):
    """{name: (B, *out, *shape)} per-sample derivatives of ``fn(P, *one)``."""
    def one(P, *args):
        return fn(P, *(a[None] for a in args))[0]
    with torch.enable_grad():
        return torch.func.vmap(torch.func.jacrev(one), in_dims=(None,) + (0,) * len(batched))(
            P, *batched)


def round_terms(prob: Problem, P_van, P_flow, rnd, sr: bool, chunk: int, block: int,
                keep=None):
    """One round's contributions: observables' means, gradient and score sums
    (divided by the round's walkers) and, with ``sr``, the Fisher matrices.
    ``keep`` (a boolean mask over the walkers) leaves walkers out and takes
    the means over the rest (a planted fault)."""
    x, states, probe = rnd["x"], rnd["states"], rnd.get("v")
    if keep is not None:
        x, states = x[keep], states[keep]
        probe = None if probe is None else probe[keep]
    B = x.shape[0]
    F, E, K, V, lp = [], [], [], [], []
    for s in range(0, B, block):
        out = prob.local(P_van, P_flow, x[s:s + block], states[s:s + block],
                         None if probe is None else probe[s:s + block])
        for dst, val in zip((F, E, K, V, lp), out):
            dst.append(val)
    F, E, K, V, lp = (torch.cat(t) for t in (F, E, K, V, lp))
    obs = {"F": F.mean(), "E": E.real.mean(), "K": K.mean(), "V": V.mean(), "S": -lp.mean(),
           "F2": (F**2).mean(), "E2": (E.real**2).mean(), "K2": (K**2).mean(),
           "V2": (V**2).mean(), "S2": (lp**2).mean(), "count": torch.tensor(float(B))}
    Fc, Ec = _clip(F, E, min(chunk, B))
    pv = {k: v.detach() for k, v in P_van.items()}
    pf = {k: v.detach() for k, v in P_flow.items()}
    P_vdim = sum(v.numel() for v in pv.values())
    P_fdim = sum(v.numel() for v in pf.values())
    zeros = lambda n: torch.zeros(n, dtype=prob.dtype, device=prob.device)  # noqa: E731
    out = {"obs": obs, "g_van": zeros(P_vdim), "g_flow": zeros(P_fdim),
           "s_van": zeros(P_vdim), "s_flow": zeros(P_fdim)}
    if sr:
        out.update(cf=zeros((P_vdim, P_vdim)), qf=zeros((P_fdim, P_fdim)),
                   qsm=zeros((2, P_fdim)))
    for s in range(0, B, block):
        sl = slice(s, s + block)
        xb, sb, fc, ec = x[sl], states[sl], Fc[sl], Ec[sl]
        if sr:
            Sc = torch.cat([v.reshape(v.shape[0], -1)
                            for v in _per_sample(prob.log_prob, pv, sb).values()], dim=1)
            jq = _per_sample(lambda P, xx, ss: prob.logpsi(P, xx, ss), pf, xb, sb)
            Sq = torch.cat([v.reshape(v.shape[0], 2, -1) for v in jq.values()], dim=2)
            Sr, Si = Sq[:, 0], Sq[:, 1]
            out["g_van"] += Sc.T @ fc / B
            out["g_flow"] += 2 * (Sr.T @ ec.real + Si.T @ ec.imag) / B
            out["s_van"] += Sc.sum(dim=0) / B
            out["s_flow"] += 2 * Sr.sum(dim=0) / B
            out["cf"] += Sc.T @ Sc / B
            out["qf"] += (Sr.T @ Sr + Si.T @ Si) / B
            out["qsm"] += torch.stack([Sr.sum(dim=0), Si.sum(dim=0)]) / B
            continue
        with torch.enable_grad():
            pvg = {k: v.requires_grad_(True) for k, v in
                   ((k, v.clone()) for k, v in pv.items())}
            logp = prob.log_prob(pvg, sb)
            gl = torch.autograd.grad((logp * fc).sum() / B, list(pvg.values()), retain_graph=True)
            gs = torch.autograd.grad(logp.sum() / B, list(pvg.values()))
            pfg = {k: v.requires_grad_(True) for k, v in
                   ((k, v.clone()) for k, v in pf.items())}
            lq = prob.logpsi(pfg, xb, sb)
            ql = 2 * (lq[:, 0] * ec.real + lq[:, 1] * ec.imag).sum() / B
            hl = torch.autograd.grad(ql, list(pfg.values()), retain_graph=True)
            hs = torch.autograd.grad(2 * lq[:, 0].sum() / B, list(pfg.values()))
        out["g_van"] += torch.cat([t.reshape(-1) for t in gl])
        out["s_van"] += torch.cat([t.reshape(-1) for t in gs])
        out["g_flow"] += torch.cat([t.reshape(-1) for t in hl])
        out["s_flow"] += torch.cat([t.reshape(-1) for t in hs])
    return out


def epoch_gradient(prob: Problem, P_van, P_flow, rounds, sr: bool, chunk: int, block: int,
                   keep=None):
    """The epoch's observables, baseline-corrected gradients (raveled) and,
    under SR, Fisher matrices, averaged over its rounds."""
    total = None
    for rnd in rounds:
        t = round_terms(prob, P_van, P_flow, rnd, sr, chunk, block,
                        None if keep is None else keep(rnd))
        if total is None:
            total = t
            continue
        for k, v in t.items():
            if k == "obs":
                for o in v:
                    total["obs"][o] = total["obs"][o] + v[o]
            else:
                total[k] = total[k] + v
    R = len(rounds)
    obs = {k: v / R for k, v in total["obs"].items()}
    obs["count"] = obs["count"] * R
    out = {"obs": obs,
           "g_van": (total["g_van"] - obs["F"] * total["s_van"]) / R,
           "g_flow": (total["g_flow"] - obs["E"] * total["s_flow"]) / R}
    if sr:
        out.update(cf=total["cf"] / R, qf=total["qf"] / R, qsm=total["qsm"] / R)
    return out


class Adam:
    """torch.optim.Adam's rule (no weight decay, no amsgrad)."""

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.m = self.v = None
        self.t = 0

    def step(self, g):
        if self.m is None:
            self.m, self.v = torch.zeros_like(g), torch.zeros_like(g)
        self.t += 1
        self.m = self.b1 * self.m + (1 - self.b1) * g
        self.v = self.b2 * self.v + (1 - self.b2) * g * g
        denom = (self.v / (1 - self.b2**self.t)).sqrt() + self.eps
        return -self.lr / (1 - self.b1**self.t) * self.m / denom


def sr_step(fisher, g, damping, max_norm):
    """Damped solve, trust-region scale, negated step; a solve with
    non-positive curvature g^T F^-1 g is a zero step."""
    M = fisher + damping * torch.eye(fisher.shape[0], dtype=fisher.dtype, device=fisher.device)
    upd = torch.linalg.solve(M, g)
    gn = float(g @ upd)
    if not math.isfinite(gn) or gn <= 0:
        return torch.zeros_like(g)
    return -min(math.sqrt(max_norm / gn), 1.0) * upd


def run_epochs(prob: Problem, P_van: dict, P_flow: dict, epochs, mix: dict, block: int,
               fault=None):
    """Follow the program's first epochs from the same parameters on its
    samples.  ``epochs`` is a list of lists of rounds.  Returns per epoch the
    observables and the gradients (named leaves), and the parameters after
    the last epoch.  ``fault`` plants one of the benchmark's faults in the
    reference: "half" (every other walker of a round left out, the means
    over the rest), "quarter" (the first of four ranks' shares alone: the
    exchange between the ranks left out) or "frozen" (no update)."""
    P_van = {k: v.clone() for k, v in P_van.items()}
    P_flow = {k: v.clone() for k, v in P_flow.items()}
    sr = bool(mix.get("sr"))
    chunk = mix.get("microbatch") or mix["batch"]
    opt = Adam(lr=mix.get("lr", 1e-3))
    keep = None
    if fault in ("half", "quarter"):
        def keep(rnd):
            mask = torch.zeros(rnd["x"].shape[0], dtype=torch.bool, device=rnd["x"].device)
            if fault == "half":
                mask[::2] = True
            else:  # the first rank's share of four: the exchange left out
                mask[:rnd["x"].shape[0] // 4] = True
            return mask
    records = []
    for rounds in epochs:
        out = epoch_gradient(prob, P_van, P_flow, rounds, sr, chunk, block, keep)
        rec = {"obs": {k: float(v) for k, v in out["obs"].items()},
               "grad_van": _unravel(out["g_van"], P_van),
               "grad_flow": _unravel(out["g_flow"], P_flow)}
        if sr:
            qf = out["qf"] - (torch.outer(out["qsm"][0], out["qsm"][0])
                              + torch.outer(out["qsm"][1], out["qsm"][1]))
            rec["fisher"] = {"classical": out["cf"], "quantum": out["qf"]}
            d_van = sr_step(out["cf"], out["g_van"], mix["damping"], mix["max_norm"])
            d_flow = sr_step(qf, out["g_flow"], mix["damping"], mix["max_norm"])
        else:
            d = opt.step(torch.cat([out["g_van"], out["g_flow"]]))
            nv = out["g_van"].numel()
            d_van, d_flow = d[:nv], d[nv:]
        if fault != "frozen":
            P_van = {k: v + u for (k, v), u in zip(P_van.items(),
                                                   _unravel(d_van, P_van).values())}
            P_flow = {k: v + u for (k, v), u in zip(P_flow.items(),
                                                    _unravel(d_flow, P_flow).values())}
        records.append(rec)
    return records, P_van, P_flow
