"""Where one training step of the PyTorch/CUDA port spends its time.

    python3 scripts/profile_torch_step.py [--folder data/interacting/] [main_torch flags]

Builds the trainer of main_torch.py at the given width (default: the Adam
path, n = 29, batch 2048, mc_steps 50, --hutchinson), thermalises with two
sample steps, then runs ``torch.profiler`` over one sample step, one
accumulate and one apply, each on its own.  For each phase it prints one JSON
line: wall seconds (host clock around a synchronize), peak device memory, the
device's busy time (sum of kernel times), its idle share, the number of
kernel launches, and the kernels with the most device time.  Needs a CUDA
device.

``--sr_path`` profiles the stochastic-reconfiguration path on the depth-2
closure kernels instead: it stands for ``--sr --sr_solver host64
--mc_d2_kernel --acc_d2_kernel`` (any of main_torch's flags can still be
given and wins).
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import main_torch  # noqa: E402
from coulombgas_tpu_torch.train.train import init_accumulators  # noqa: E402
from coulombgas_tpu_torch.utils.profiling import trace  # noqa: E402


def profiled(fn, top=4):
    torch.cuda.synchronize()
    t0 = time.time()
    with trace(None, "cuda") as prof:
        out = fn()
    wall = time.time() - t0
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    return out, {
        "wall_s_with_profiler": wall, "device_busy_ms": busy_ms,
        "kernel_launches": sum(r[2] for r in rows),
        "top_kernels": [{"name": k[:60], "ms": round(ms, 3), "count": c} for k, ms, c in rows[:top]],
    }


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def main():
    if not torch.cuda.is_available():
        sys.exit("profile_torch_step.py needs a CUDA device")
    argv = sys.argv[1:]
    if "--sr_path" in argv:
        argv.remove("--sr_path")
        argv = ["--sr", "--sr_solver", "host64", "--mc_d2_kernel", "--acc_d2_kernel"] + argv
    if "--folder" not in argv:
        argv += ["--folder", "data/interacting/"]
    if "--hutchinson" not in argv:
        argv += ["--hutchinson"]
    args = main_torch.parse_args(argv + ["--acc_steps", "1"])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"device": smi, "n": args.n, "batch": args.batch, "mc_steps": args.mc_steps,
                      "sr": args.sr, "sr_solver": args.sr_solver if args.sr else None,
                      "mc_d2_kernel": args.mc_d2_kernel, "acc_d2_kernel": args.acc_d2_kernel}))
    with tempfile.TemporaryDirectory() as out:
        tr = main_torch.build_trainer(args, out_folder=out)
        for _ in range(2):
            si, tr.x, _ = tr.sample_step(tr.van, tr.flow, tr.x, tr.generator)
        # warm-up of every phase, then the clean wall time, then the profile
        def new_acc():
            return init_accumulators(tr.van, tr.flow, sr=args.sr)

        acc = tr.accumulate(tr.van, tr.flow, si, tr.x, tr.generator, new_acc())
        main_torch.apply_step(tr, acc, 1, {})

        phases = {
            "sample": lambda: tr.sample_step(tr.van, tr.flow, tr.x, tr.generator),
            "accumulate": lambda: tr.accumulate(tr.van, tr.flow, si, tr.x, tr.generator,
                                                new_acc()),
        }
        for name, fn in phases.items():
            torch.cuda.reset_peak_memory_stats()
            _, wall = timed(fn)
            peak = torch.cuda.max_memory_allocated() / 2**30
            _, prof = profiled(fn)
            idle = 1.0 - prof["device_busy_ms"] / 1e3 / prof["wall_s_with_profiler"]
            print(json.dumps(dict({"phase": name, "wall_s": wall, "peak_GiB": round(peak, 3),
                                   "device_idle_share_under_profiler": round(idle, 3)}, **prof)))
        acc = phases["accumulate"]()
        seconds = {}
        torch.cuda.reset_peak_memory_stats()
        _, wall = timed(lambda: main_torch.apply_step(tr, acc, 1, seconds))
        peak = torch.cuda.max_memory_allocated() / 2**30
        _, prof = profiled(lambda: main_torch.apply_step(tr, acc, 1, {}))
        print(json.dumps(dict({"phase": "apply", "wall_s": wall, "peak_GiB": round(peak, 3),
                               "solve_phases_s": seconds}, **prof)))


if __name__ == "__main__":
    main()
