"""One rank of a run: set-up, the verified epochs, the window, the traced
epoch, and (on rank 0) the reference's check and the result's line."""

from __future__ import annotations

import contextlib
import gc
import os
import shutil
import sys
import time

import torch

import check
import devtrace
import harness
import metrics


def _mesh_up(rank, world, port, cuda):
    """This rank's process group (none with one rank) and its device."""
    from coulombgas_tpu_torch.parallel import mesh

    device = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if world > 1:
        mesh.make_mesh("tcp://localhost:%d" % port, rank, world, device)
    elif cuda:
        torch.cuda.set_device(0)
    return mesh, device


def _all_max(value: float, world: int, device) -> float:
    if world == 1:
        return value
    t = torch.tensor([value], dtype=torch.float64, device=device)
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
    return float(t)


def _go_on(flag: bool, world: int, device) -> bool:
    """Rank 0's decision, on every rank."""
    if world == 1:
        return flag
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    torch.distributed.broadcast(t, 0)
    return bool(t.item() > 0.5)


def run(args, rank: int, world: int, port: int, t_start: float, cell=None):
    """Returns (result dict, lines for standard error) on rank 0; (None, [])
    elsewhere.  A ``cell`` given with ``cpu`` set runs on the CPU in float64
    (the CPU tests)."""
    cell = cell or harness.Cell(args.workload)
    cuda = not cell.cpu
    mesh, device = _mesh_up(rank, world, port, cuda)
    out = harness.temp_folder()
    try:
        return _run(cell, args, rank, world, t_start, out, device)
    finally:
        shutil.rmtree(out, ignore_errors=True)
        mesh.destroy()


def verified(cell, seed, out, cuda):
    """Set-up and the verified epochs: (driver, what the reference needs and
    the program's readings of them)."""
    harness.seed_everything(seed)
    with contextlib.redirect_stdout(sys.stderr):
        drv = harness.Driver(cell, seed, out)
        drv.thermalise()
    sr = drv.args.sr
    flow0 = {k: v.detach().cpu() for k, v in drv.flow0.items()}
    start = drv.params()
    kept = []
    for e in range(cell.mix.get("verify_epochs", 3)):
        rec = {"rounds": [], "logp": e == 0, "fisher": sr and e == 0}
        with contextlib.redirect_stdout(sys.stderr):
            drv.run_epoch(record=rec)
        kept.append(rec)
    change = {k: v - start[k] for k, v in drv.params().items()}
    rounds = [harness.to_host(rec["rounds"]) for rec in kept]
    first = kept[0]["acc"]
    grad = {k: v.cpu() for k, v in first.items() if not k.startswith("fisher.")}
    fisher = ({"classical": first["fisher.classical"].cpu(),
               "quantum": first["fisher.quantum"].cpu()} if sr else None)
    logp_rounds = [rnd.pop("logp").double() for rnd in rounds[0]]
    a = drv.args
    ref_mix = {"batch": a.batch, "acc_steps": a.acc_steps, "microbatch": a.microbatch,
               "sr": a.sr, "hutchinson": a.hutchinson, "damping": a.damping,
               "max_norm": a.max_norm, "lr": a.lr}
    kept_data = {"flow0": flow0, "mix": ref_mix, "reverted": drv.failed,
                 "shared": {"rounds": rounds, "logp": logp_rounds},
                 "prog": check.program_side([rec["obs"] for rec in kept], None, grad,
                                            fisher, change)}
    return drv, kept_data


def reference(cell, gathered, kept, device, **kw):
    """The reference's side on every rank's samples (``gathered``: each
    rank's ``kept["shared"]``, in rank order).  Sets the program's
    Metropolis log-densities of the first epoch, every rank's, in the
    reference's walker order."""
    rounds = check.global_rounds([g["rounds"] for g in gathered])
    kept["prog"]["logp"] = torch.cat([torch.cat([g["logp"][r] for g in gathered])
                                      for r in range(len(gathered[0]["logp"]))])
    van_file = os.path.join(harness.ROOT, cell.cfg["van_file"])
    return check.reference_side(cell.cfg, kept["mix"], van_file, kept["flow0"], rounds,
                                device, block=cell.mix.get("block", 256), **kw)


def _run(cell, args, rank, world, t_start, out, device):
    clock = time.perf_counter
    cuda = device.type == "cuda"
    drv, kept = verified(cell, args.seed, out, cuda)
    tr = drv.tr
    sync = tr.sync
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0

    # ---- the window -------------------------------------------------------------------
    if world > 1:
        torch.distributed.barrier()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    sync()
    setup_s = time.time() - t_start
    w0 = clock()
    drv.spans.epochs.clear()
    failed0 = drv.failed
    epochs = 0
    while True:
        drv.run_epoch()
        epochs += 1
        if not _go_on(clock() - w0 < args.seconds, world, device):
            break
    sync()
    window_s = clock() - w0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    failed = drv.failed - failed0
    span_epochs = list(drv.spans.epochs)

    trace = None
    if args.trace:
        trace = devtrace.profile_epoch(drv, annotate=rank == 0 and cuda)
        epochs += 1
        failed = drv.failed - failed0
    peak = _all_max(float(peak), world, device)
    memory_peak = _all_max(float(max(peak, setup_peak)), world, device)

    # ---- the samples of every rank to rank 0, the program's state freed ------------
    if world > 1:
        gathered = [None] * world
        torch.distributed.all_gather_object(gathered, kept["shared"])
    else:
        gathered = [kept["shared"]]
    del drv, tr
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if rank != 0:
        return None, []

    # ---- the reference's check -----------------------------------------------------
    t_ref = clock()
    ref = reference(cell, gathered, kept, device)
    values = check.numbers(kept["prog"], ref)
    correct, lines = check.verdict(values, cell.limits)
    if kept["reverted"]:
        correct = False
        lines.append("the tripwire reverted %d of the verified epochs: nothing to compare"
                     % kept["reverted"])
    lines.insert(0, "reference: %.1f s" % (clock() - t_ref))

    run_info = metrics.Run(cell=cell, trace=bool(args.trace), window_s=window_s, epochs=epochs,
                           setup_s=setup_s, peak_bytes=peak, spans=span_epochs,
                           profile=trace, world=world)
    wanted = cell.per_layer if args.trace else cell.end_to_end
    result = {"correct": bool(correct), "attempted": epochs, "failed": failed,
              "metrics": metrics.read_all(wanted, run_info),
              "device": _device(cuda, world, memory_peak, trace)}
    if trace is not None:
        result["breakdown"] = trace.breakdown()
    result["checks"] = {k: {"value": values.get(k), "limit": lim} for k, lim in cell.limits.items()}
    return result, lines


def _device(cuda, world, memory_peak, trace):
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": world, "memory_peak_bytes": int(memory_peak)}
    if trace is not None:
        dev["busy_s"] = trace.busy_s
        dev["window_s"] = trace.window_s
    return dev
