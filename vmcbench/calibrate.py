"""Readings that the limits of ``limits/<cell>.json`` are set from.

    python3 vmcbench/calibrate.py --workload n29.exact --seeds 11 12 13 \
        --control 11 12 13 --out chiprun_out/calibrate.jsonl

One process, one card (four-card cells: the ranks' samples are simulated
by one rank's batch of the same global size, which is what the reference
sees).  For each seed: the cell's set-up and verified epochs, no window,
then the reference's check, with the compared numbers and what they are
made of.  For the seeds given to ``--control``: the reference put in the
program's place in the nearest precision below the configuration's
(float32 with TF32 matrix products) and the planted faults (``half``: half
of every round left out, the means over the rest), each held against the
float64 reference.  Every reading is one JSON line.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

import check  # noqa: E402
import harness  # noqa: E402
import runner  # noqa: E402


def readings(cell, seed, control: bool, faults=("half",)):
    """The program's numbers for ``seed`` and, with ``control``, the
    control's and the faults'.  Returns a list of records."""
    out_dir = harness.temp_folder()
    cuda = not cell.cpu
    dev = torch.device("cuda") if cuda else torch.device("cpu")
    t0 = time.time()
    drv, kept = runner.verified(cell, seed, out_dir, cuda)
    del drv
    if cuda:
        torch.cuda.empty_cache()
    t1 = time.time()
    ref = runner.reference(cell, [kept["shared"]], kept, dev)
    t2 = time.time()
    recs = [{"seed": seed, "side": "program", "numbers": check.numbers(kept["prog"], ref),
             "details": check.details(kept["prog"], ref), "reverted": kept["reverted"],
             "program_s": t1 - t0, "reference_s": t2 - t1}]
    if "fisher" in ref:
        recs[0]["classical_step"] = classical_step(kept, ref)
    if control:
        ctrl = runner.reference(cell, [kept["shared"]], kept, dev, dtype=torch.float32,
                                tf32=cuda)
        recs.append({"seed": seed, "side": "control", "numbers": check.numbers(ctrl, ref),
                     "details": check.details(ctrl, ref)})
        for fault in faults:
            bad = runner.reference(cell, [kept["shared"]], kept, dev, fault=fault)
            recs.append({"seed": seed, "side": "fault:" + fault,
                         "numbers": check.numbers(bad, ref)})
    return recs


def classical_step(kept, ref):
    """The first epoch's classical SR step solved in float64 from the
    program's Fisher and from the reference's, on the reference's gradient:
    their norms, and the least eigenvalue of each damped Fisher."""
    from reference import step

    damping, max_norm = kept["mix"]["damping"], kept["mix"]["max_norm"]
    g = torch.cat([v.reshape(-1) for k, v in ref["grad"].items() if k.startswith("van.")])
    out = {}
    for side, M in (("program", kept["prog"]["fisher"]["classical"]),
                    ("reference", ref["fisher"]["classical"])):
        M = M.to(g)
        eye = torch.eye(M.shape[0], dtype=M.dtype, device=M.device)
        out[side] = {"step_norm": float(step.sr_step(M, g, damping, max_norm).norm()),
                     "least_eigenvalue": float(torch.linalg.eigvalsh(M + damping * eye)[0])}
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, nargs="*", default=[])
    p.add_argument("--out", default=None)
    a = p.parse_args()
    cell = harness.Cell(a.workload)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    sink = open(a.out, "a") if a.out else None
    try:
        for seed in a.seeds:
            faults = ("half", "quarter") if cell.chips > 1 else ("half",)
            for rec in readings(cell, seed, seed in a.control, faults):
                rec["workload"] = a.workload
                line = json.dumps(rec)
                if sink:
                    sink.write(line + "\n")
                    sink.flush()
                print(json.dumps({k: rec[k] for k in rec if k != "details"}), flush=True)
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
