"""The comparison that decides ``correct``.

The reference (``reference/``) follows the program's first epochs from the
same inputs: the checked-in VAN, the flow drawn from the seed, and the
program's samples of each round (walkers, occupations and the benchmark's
Hutchinson probes), which it reads only to judge them.  It works out again
everything the program derived from them, in float64, and these numbers are
computed, and those that ``limits/<cell>.json`` names are compared, each
against its limit there:

* ``obs``: the largest relative gap of an epoch's observables F, E, K, V, S
  (the loss and its parts), over the epochs followed; ``obs1``: the same of
  the first epoch alone, where both sides hold the same parameters;
* ``logp``: the widest gap of the Metropolis log-density 2 Re log Psi that
  the program's sample-step route (the flow and log-det kernels) gives for
  the first epoch's walkers;
* ``grad``: the worst leaf's gap between the norms of the first epoch's
  gradient as the optimizer gets it, over the larger of the reference
  leaf's norm and the median leaf's;
* ``change``: the same, of the parameters' change over the epochs followed;
  ``change_median``: the median leaf's gap of it;
* ``fisher`` (SR): the relative Frobenius gap of the first epoch's
  classical and quantum Fisher matrices, the worse of the two.

Leaves whose reference gradient is below a thousandth of the median leaf's
(nought to rounding, as the attention keys' biases under softmax and the
flow's final bias under translation) are left out of ``grad`` and
``change``: Adam moves them by round-off alone.
"""

from __future__ import annotations

import statistics

import torch

from reference import model, step

LEAF_FLOOR = 1e-3


def global_rounds(per_rank_epochs):
    """[rank][epoch][round] -> [epoch][round] with the ranks' shares joined in
    rank order (rank r holds walkers [r B / W, (r + 1) B / W) of a round)."""
    out = []
    for e in range(len(per_rank_epochs[0])):
        rounds = []
        for r in range(len(per_rank_epochs[0][e])):
            parts = [per_rank_epochs[k][e][r] for k in range(len(per_rank_epochs))]
            rounds.append({key: (None if parts[0][key] is None
                                 else torch.cat([p[key] for p in parts]))
                           for key in parts[0]})
        out.append(rounds)
    return out


def reference_side(cfg, mix, van_file, flow0, epochs, device, dtype=torch.float64,
                   tf32=False, fault=None, block=256):
    """What the reference gives on the recorded inputs: per-epoch
    observables, the first epoch's gradient by leaf and Fisher blocks, the
    parameters' change, and the first epoch's Metropolis log-densities.
    ``dtype``/``tf32`` set its precision (the control is float32 with TF32
    matrix products); ``fault`` plants a fault (``step.run_epochs``)."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        prob = step.Problem(cfg, device, dtype)
        P_van = {k: torch.as_tensor(v).to(device=device, dtype=dtype)
                 for k, v in model.load_van(van_file).items()}
        P_flow = model.tree_order({k: v.to(device=device, dtype=dtype) for k, v in flow0.items()})
        ep = [[{k: (None if v is None else
                    v.to(device) if k == "states" else v.to(device=device, dtype=dtype))
                for k, v in rnd.items()} for rnd in rounds] for rounds in epochs]
        records, P_van1, P_flow1 = step.run_epochs(prob, P_van, P_flow, ep, mix, block, fault)
        logp = torch.cat([prob.metropolis_logp(P_flow, r["x"], r["states"]) for r in ep[0]])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    first = records[0]
    out = {"obs": [r["obs"] for r in records],
           "grad": {**{"van." + k: v.double() for k, v in first["grad_van"].items()},
                    **{"flow." + k: v.double() for k, v in first["grad_flow"].items()}},
           "change": {**{"van." + k: (P_van1[k] - P_van[k]).double() for k in P_van},
                      **{"flow." + k: (P_flow1[k] - P_flow[k]).double() for k in P_flow}},
           "logp": logp.double()}
    if "fisher" in first:
        out["fisher"] = {k: v.double() for k, v in first["fisher"].items()}
    return out


def _leaf_gaps(prog: dict, ref: dict, kept) -> list:
    """Each kept leaf's gap of norms over the larger of the reference leaf's
    norm and the median leaf's."""
    norms = {k: float(ref[k].norm()) for k in kept}
    med = statistics.median(norms.values())
    return [abs(float(prog[k].to(ref[k]).norm()) - norms[k]) / max(norms[k], med)
            for k in kept]


def stderr(obs: dict, o: str) -> float:
    """The reference's Monte-Carlo standard error of observable ``o``."""
    return max(obs[o + "2"] - obs[o] ** 2, 0.0) ** 0.5 / obs["count"] ** 0.5


def details(prog: dict, ref: dict) -> dict:
    """What the compared numbers are made of: each epoch's observables on
    both sides with the reference's standard error, and each leaf's norms."""
    out = {"obs": [{o: [p[o], r[o], stderr(r, o)] for o in step.OBSERVABLES}
                   for p, r in zip(prog["obs"], ref["obs"])],
           "leaves": {k: [float(ref["grad"][k].norm()), float(prog["grad"][k].norm()),
                          float(ref["change"][k].norm()), float(prog["change"][k].norm())]
                      for k in ref["grad"]}}
    d = (prog["logp"].to(ref["logp"]) - ref["logp"]).abs()
    out["logp_quantiles"] = [float(q) for q in torch.quantile(
        d, torch.tensor([0.5, 0.9, 0.99, 1.0], dtype=d.dtype, device=d.device))]
    return out


def numbers(prog: dict, ref: dict) -> dict:
    """The compared numbers of one run (see the module docstring)."""
    gnorm = {k: float(v.norm()) for k, v in ref["grad"].items()}
    med = statistics.median(gnorm.values())
    kept = [k for k, g in gnorm.items() if g >= LEAF_FLOOR * med]
    rel = [[abs(p[o] - r[o]) / abs(r[o]) for o in step.OBSERVABLES]
           for p, r in zip(prog["obs"], ref["obs"])]
    change = _leaf_gaps(prog["change"], ref["change"], kept)
    out = {
        "obs": max(max(e) for e in rel),
        "obs1": max(rel[0]),
        "logp": float((prog["logp"].to(ref["logp"]) - ref["logp"]).abs().max()),
        "grad": max(_leaf_gaps(prog["grad"], ref["grad"], kept)),
        "change": max(change),
        "change_median": statistics.median(change),
    }
    if "fisher" in ref:
        out["fisher"] = max(float((prog["fisher"][k].to(r) - r).norm() / r.norm())
                            for k, r in ref["fisher"].items())
    return out


def verdict(values: dict, limits: dict):
    """(correct, lines): every number the cell's limits name is within its
    limit (numbers it does not name are not compared), one line each."""
    ok = bool(limits)
    lines = []
    for k, lim in limits.items():
        v = values.get(k, float("nan"))
        good = v == v and v <= lim
        ok = ok and good
        lines.append("check %s %.6g limit %.6g %s" % (k, v, lim, "ok" if good else "FAILED"))
    return ok, lines


def program_side(record_epochs, prog_logp, grad, fisher, change) -> dict:
    """The program's readings in the form ``numbers`` takes."""
    out = {"obs": record_epochs, "logp": prog_logp, "grad": grad, "change": change}
    if fisher is not None:
        out["fisher"] = fisher
    return out
