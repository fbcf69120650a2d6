"""Cluster job generation for GPU clusters (Slurm).

The port's copy of ``coulombgas_tpu/cluster/submit.py`` for the PyTorch/CUDA
training script: the job runs ``main_torch.py`` with the canonical production
arguments.  On one node ``main_torch.py`` starts a rank per visible GPU
itself (``--num_devices 0``, the default), as ``main.py`` uses every device;
across nodes, ``srun ... python main_torch.py --multihost`` makes each task
a rank and ``main_torch.py`` reads the job's layout from SLURM's environment.

The JAX module's ``--backend tpu`` and ``tpu_pod_script`` (a gcloud TPU-VM
launcher) have no counterpart: a TPU slice does not run a CUDA program.

Usage:
    python -m coulombgas_tpu_torch.cluster.submit --partition h100 --ngpus 8 \
        --jobname n57
    python -m coulombgas_tpu_torch.cluster.submit --jobname n57 --submit
"""

from __future__ import annotations

import socket
import subprocess
import textwrap

__all__ = ["production_args", "slurm_script", "submitjob", "main"]


def production_args(n=57, Emax=49, batch=512, acc_steps=16, epoch=5000, folder="./data/"):
    """The canonical production argument set (reference run/submit.py:29-41)."""
    return (
        f"--folder {folder} "
        f"--n {n} --dim 2 --rs 1.0 --Theta 0.15 --Emax {Emax} "
        "--nlayers 2 --modelsize 16 --nheads 4 --nhidden 32 "
        "--depth 2 --spsize 16 --tpsize 16 "
        "--Gmax 15 --kappa 10 "
        "--mc_therm 10 --mc_steps 50 --mc_stddev 0.1 "
        "--hutchinson --sr --damping 0.001 --max_norm 0.001 "
        f"--batch {batch} --acc_steps {acc_steps} --epoch {epoch}"
    )


def slurm_script(program: str, partition: str, ngpus: int, jobname: str,
                 time_limit: str = "96:00:00") -> str:
    """Single-node Slurm jobfile (the reference's cluster layout); ``program``
    is what ``python`` runs, e.g. ``main_torch.py `` + ``production_args()``."""
    return textwrap.dedent(
        f"""\
        #!/bin/bash
        #SBATCH --partition={partition}
        #SBATCH --nodes=1
        #SBATCH --gres=gpu:{ngpus}
        #SBATCH --cpus-per-task=8
        #SBATCH --time={time_limit}
        #SBATCH --job-name={jobname}
        #SBATCH --output=%x-%j.out

        echo "The current job ID is $SLURM_JOB_ID"
        echo "Running on $SLURM_JOB_NUM_NODES nodes: $SLURM_JOB_NODELIST"
        echo "Using $SLURM_NTASKS_PER_NODE tasks per node"

        python {program}
        """
    )


def submitjob(jobfile: str, dry_run: bool = False):
    """sbatch the jobfile (or, with ``dry_run``, only print it)."""
    if dry_run:
        with open(jobfile) as f:
            print(f.read())
        return None
    return subprocess.run(["sbatch", jobfile], check=True)


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="Generate and submit Slurm jobs")
    parser.add_argument("--partition", default="a100")
    parser.add_argument("--ngpus", type=int, default=8)
    parser.add_argument("--jobname", default="coulombgas")
    parser.add_argument("--n", type=int, default=57)
    parser.add_argument("--Emax", type=int, default=49)
    parser.add_argument("--batch", type=int, default=512)
    parser.add_argument("--acc_steps", type=int, default=16)
    parser.add_argument("--epoch", type=int, default=5000)
    parser.add_argument("--folder", default="./data/")
    parser.add_argument("--submit", action="store_true", help="actually sbatch")
    args = parser.parse_args(argv)

    program = "main_torch.py " + production_args(
        args.n, args.Emax, args.batch, args.acc_steps, args.epoch, args.folder
    )
    script = slurm_script(program, args.partition, args.ngpus, args.jobname)
    jobfile = f"jobfile_{args.jobname}.sh"
    with open(jobfile, "w") as f:
        f.write(script)
    print("Wrote", jobfile, "for host", socket.gethostname())
    if args.submit:
        submitjob(jobfile)
    else:
        print(script)


if __name__ == "__main__":
    main()
