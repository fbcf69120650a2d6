"""The benchmark's driver of the program: one cell, one seed, one rank.

A cell is a configuration (``configs/<name>.json``: the model, the physics
and the sampler, as ``main_torch.py`` takes them) under a traffic mix
(``traffic/<name>.json``: the optimizer's flags, the batch, the rounds an
epoch, the ranks).  Set-up builds the program's trainer with
``main_torch.build_trainer``, replaces the flow's parameters, the walkers and
the generators by draws from the seed, thermalises with the program's own
sample steps, and drives the first ``verify_epochs`` epochs through the
window's own epoch body, keeping what the reference needs to follow them.
The window then runs whole epochs until its seconds have passed.

The epoch body is the benchmark's copy of the body of ``main_torch.train``'s
loop, through the program's own functions: the tripwire's snapshot, the
accumulators, ``acc_steps`` rounds of sample step and accumulate (each ending
in the device's synchronize), the reduction over the ranks, the apply, and
the tripwire's check, which reverts a bad epoch as the driver does.  Around
each phase the body records a host-clock span.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PHASES = ("sample", "accumulate", "reduce", "apply")
FORBIDDEN = ("jax", "jaxlib", "flax", "coulombgas_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark():
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


class Cell:
    """One entry of ``workloads`` with everything found by its names."""

    def __init__(self, name: str, bench: dict | None = None):
        bench = bench or benchmark()
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit("vmcbench: no workload %r in BENCHMARK.json" % name)
        self.name, self.entry = name, cells[name]
        self.chips = self.entry["chips"]
        self.cfg = load_json(os.path.join(HERE, "configs", self.entry["config"] + ".json"))
        self.mix = load_json(os.path.join(HERE, "traffic", self.entry["traffic"] + ".json"))
        limits = os.path.join(HERE, "limits", name + ".json")
        self.limits = load_json(limits) if os.path.isfile(limits) else {}

        def mine(metric):
            ws = metric.get("workloads")
            return ws is None or name in ws

        self.cpu = False  # the CPU tests: float64 on the CPU, with --cpu
        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]

    def argv(self):
        """``main_torch.py``'s command line of this cell."""
        argv = []
        for key in ("n", "dim", "rs", "Theta", "Emax", "nlayers", "modelsize", "nheads",
                    "nhidden", "depth", "spsize", "tpsize", "Gmax", "kappa", "mc_therm",
                    "mc_steps", "mc_stddev", "folder"):
            argv += ["--" + key, str(self.cfg[key])]
        argv += ["--twist"] + [str(t) for t in self.cfg["twist"]]
        argv += ["--batch", str(self.mix["batch"]), "--acc_steps", str(self.mix["acc_steps"]),
                 "--microbatch", str(self.mix.get("microbatch", 0)),
                 "--num_devices", str(self.chips)]
        return argv + list(self.mix.get("flags", [])) + (["--cpu"] if self.cpu else [])


def sub_seed(seed: int, *parts) -> int:
    """A 63-bit seed for one purpose, from the run's seed."""
    digest = hashlib.sha256(("%d/" % seed + "/".join(map(str, parts))).encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def flow_draw(shapes: dict, seed: int, device, dtype) -> dict:
    """The flow's parameters from the seed, on the device in one draw:
    N(0, 0.01^2) weights and zero biases, as the program initialises them."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "flow"))
    sizes = [math.prod(s) for k, s in shapes.items() if k.endswith(".w")]
    draw = 0.01 * torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
    out, at = {}, 0
    for k, s in shapes.items():
        if k.endswith(".w"):
            out[k] = draw[at:at + math.prod(s)].reshape(s)
            at += math.prod(s)
        else:
            out[k] = torch.zeros(s, device=device, dtype=dtype)
    return out


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the run may not import."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


class Spans:
    """Host-clock spans of the epoch body, in seconds, per phase and epoch."""

    def __init__(self):
        self.epochs = []   # [{"wall": s, "sample": [..], "accumulate": [..], ...}]

    def new(self):
        self.epochs.append({p: [] for p in PHASES})
        return self.epochs[-1]


class Driver:
    """The program's trainer and the epoch body that drives it."""

    def __init__(self, cell: Cell, seed: int, out_folder: str):
        import main_torch
        from coulombgas_tpu_torch.parallel import mesh
        from coulombgas_tpu_torch.train.train import init_accumulators, reduce_accumulators
        from coulombgas_tpu_torch.train.tripwire import UpdateTripwire
        from coulombgas_tpu_torch.io.logging import stderr_from_moments
        from reference import model

        self.main = main_torch
        self.init_acc, self.reduce = init_accumulators, reduce_accumulators
        self.stderr = stderr_from_moments
        args = main_torch.parse_args(cell.argv())
        self.args = args
        tr = main_torch.build_trainer(args, out_folder=out_folder)
        self.tr = tr
        grid = mesh.current()
        self.rank, self.world = grid.rank, grid.world_size
        dtype = next(tr.flow.parameters()).dtype
        shapes = model.flow_shapes(args.dim, args.depth, args.spsize, args.tpsize)
        self.flow0 = flow_draw(shapes, seed, tr.device, dtype)
        with torch.no_grad():
            for k, p in tr.flow.named_parameters():
                p.copy_(self.flow0[k])
        gen = torch.Generator(device=tr.device).manual_seed(sub_seed(seed, "walkers"))
        x = tr.L * torch.rand(args.batch, args.n, args.dim, generator=gen, device=tr.device,
                              dtype=dtype)
        share = args.batch // self.world
        tr.x = x[self.rank * share:(self.rank + 1) * share].contiguous()
        tr.generator = torch.Generator(device=tr.device).manual_seed(
            sub_seed(seed, "chain", self.rank))
        self.probe_gen = torch.Generator(device=tr.device).manual_seed(
            sub_seed(seed, "probe", self.rank))
        self.tripwire = UpdateTripwire(sigma=args.tripwire_sigma)
        self.epoch = 0
        self.failed = 0
        self.spans = Spans()

    def thermalise(self):
        tr = self.tr
        for _ in range(self.args.mc_therm):
            _, tr.x, _ = tr.sample_step(tr.van, tr.flow, tr.x, tr.generator)
        tr.sync()

    def run_epoch(self, record=None, annotate=None):
        """One epoch of the driver's loop.  ``record`` (a dict) keeps the
        rounds' samples, the reduced gradients and Fisher matrices and the
        observables for the reference; ``annotate`` wraps each phase in a
        profiler range.  Returns whether the epoch failed."""
        main, tr, args = self.main, self.tr, self.args
        clock = time.perf_counter
        ann = annotate or (lambda name: contextlib.nullcontext())
        self.epoch += 1
        i = self.epoch
        span = self.spans.new()
        t_epoch = clock()
        self.tripwire.snapshot(main.snapshot_state(tr))
        acc = self.init_acc(tr.van, tr.flow, sr=args.sr)
        accept_sum = 0.0
        seconds = {"sample": 0.0, "accumulate": 0.0, "apply": 0.0}
        for _ in range(args.acc_steps):
            t0 = clock()
            with ann("vmcbench.sample"):
                states, tr.x, accept_rate = tr.sample_step(tr.van, tr.flow, tr.x, tr.generator)
                tr.sync()
            t1 = clock()
            span["sample"].append(t1 - t0)
            accept_sum += float(accept_rate)
            v = (torch.randn(tr.x.shape, generator=self.probe_gen, device=tr.x.device,
                             dtype=tr.x.dtype) if args.hutchinson else None)
            if record is not None:
                rnd = {"states": states.clone(), "x": tr.x.clone(), "v": v}
                if record["logp"]:
                    rnd["logp"] = tr.logp(tr.x, tr.flow, states)
                record["rounds"].append(rnd)
            t1 = clock()
            with ann("vmcbench.accumulate"):
                acc = tr.accumulate(tr.van, tr.flow, states, tr.x, tr.generator, acc, v)
                tr.sync()
            span["accumulate"].append(clock() - t1)
        t0 = clock()
        with ann("vmcbench.reduce"):
            acc, accept_sum = self.reduce(
                acc, accept_sum,
                leave_out=("classical_fisher",) if main.stale_classical(tr, i) else ())
            tr.sync()
        span["reduce"].append(clock() - t0)
        if record is not None:
            record["acc"] = _reduced_gradient(acc, tr, args.acc_steps, record["fisher"])
        t0 = clock()
        with ann("vmcbench.apply"):
            d, diag = main.apply_step(tr, acc, i, seconds, self.tripwire.trust_scale)
        span["apply"].append(clock() - t0)
        accept = accept_sum / args.acc_steps
        finite = all(math.isfinite(val) for val in d.values())
        total = args.batch * args.acc_steps
        F_sig = (self.stderr(d["F_mean"], d["F2_mean"], total)
                 if math.isfinite(d["F_mean"]) and math.isfinite(d["F2_mean"])
                 else float("nan"))
        revert_to = self.tripwire.check(d["F_mean"], F_sig, finite, accept=accept,
                                        S=d["S_mean"] if math.isfinite(d["S_mean"]) else None)
        if revert_to is not None:
            main.restore_state(tr, revert_to)
        elif args.sr:
            tr.sr_state = diag
        if record is not None:
            record["obs"] = {k: d[k + "_mean"] for k in "FEKVS"}
        span["wall"] = clock() - t_epoch
        failed = (not finite) or revert_to is not None
        self.failed += failed
        return failed

    def params(self) -> dict:
        """The program's parameters now, as float64 copies by name."""
        tr = self.tr
        return {**{"van." + k: p.detach().double().clone() for k, p in tr.van.named_parameters()},
                **{"flow." + k: p.detach().double().clone()
                   for k, p in tr.flow.named_parameters()}}


def _reduced_gradient(acc, tr, acc_steps, fisher: bool):
    """The epoch's gradient as the optimizer gets it, by leaf: the reduced
    accumulators baseline-corrected and normalized as the apply does; and
    the Fisher blocks where asked for."""
    data_F = float(acc["data"]["F_mean"]) / acc_steps
    data_E = float(acc["data"]["E_mean"]) / acc_steps
    out = {}
    for prefix, module, grads, scores, base in (
            ("van.", tr.van, acc["grads"][0], acc["classical_score"], data_F),
            ("flow.", tr.flow, acc["grads"][1], acc["quantum_score"], data_E)):
        for (k, _), g, s in zip(module.named_parameters(), grads, scores):
            out[prefix + k] = ((g.double() - base * s.double()) / acc_steps).clone()
    if fisher:
        out["fisher.classical"] = acc["classical_fisher"].double() / acc_steps
        out["fisher.quantum"] = acc["quantum_fisher"].double() / acc_steps
    return out


def argv_parser():
    p = argparse.ArgumentParser(description="vmcbench: one cell of the benchmark")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def temp_folder():
    return tempfile.mkdtemp(prefix="vmcbench-")


def to_host(rounds):
    return [{k: (None if v is None else v.detach().cpu()) for k, v in r.items()} for r in rounds]


def seed_everything(seed: int):
    np.random.seed(sub_seed(seed, "numpy") % 2**32)
    torch.manual_seed(sub_seed(seed, "torch"))
