"""Run one cell of the benchmark of ``coulombgas_tpu_torch`` on this machine.

    python3 vmcbench/run.py --workload n29.exact --seed 12345 --seconds 40 --trace 0

From the root of a checkout.  Builds the cell's trainer, drives its first
epochs and keeps them for the reference, times whole epochs for
``--seconds`` (``--trace 1``: then profiles one more epoch), checks the
program's outputs against the plain reference, and prints one JSON line
last on standard output.  Needs as many CUDA devices as the cell's chips;
without them it exits with code 2 and prints no result.
"""

import time

T_START = time.time()

import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

# every kernel and build cache of the program inside the checkout, at fixed paths
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton_cache"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
os.environ.setdefault("PYTORCH_KERNEL_CACHE_PATH", os.path.join(ROOT, "build", "torch_kernels"))

import torch  # noqa: E402

import harness  # noqa: E402


def power_limit():
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def main(argv=None):
    args = harness.argv_parser().parse_args(argv)
    cell = harness.Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print("vmcbench: the cell needs %d CUDA device(s); %d visible"
              % (cell.chips, torch.cuda.device_count() if torch.cuda.is_available() else 0),
              file=sys.stderr)
        return 2
    if cell.chips == 1:
        return _rank(0, args, 1, 0, T_START)
    import torch.multiprocessing as mp
    from main_torch import free_port

    ctx = mp.start_processes(_rank_entry, args=(args, cell.chips, free_port(), T_START),
                             nprocs=cell.chips, start_method="spawn", join=False)
    try:
        while not ctx.join():
            pass
    except mp.ProcessExitedException as err:
        print("vmcbench: rank %d ended with %s" % (err.error_index, err.exit_code),
              file=sys.stderr)
        return 1
    except mp.ProcessRaisedException as err:
        print("vmcbench: %s" % err, file=sys.stderr)
        return 1
    return 0


def _rank_entry(rank, args, world, port, t_start):
    code = _rank(rank, args, world, port, t_start)
    if code:
        raise SystemExit(code)


def _rank(rank, args, world, port, t_start):
    import runner

    sys.stdout.reconfigure(line_buffering=True)
    result, lines = runner.run(args, rank, world, port, t_start)
    if rank != 0:
        return 0
    found = harness.forbidden_modules()
    if found:
        print("vmcbench: the run imported %s" % ", ".join(found), file=sys.stderr)
        return 3
    result["device"]["power_limit"] = power_limit()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    with contextlib.suppress(KeyboardInterrupt):
        sys.exit(main())
