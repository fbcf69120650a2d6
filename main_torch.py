"""Finite-temperature VMC for the homogeneous electron gas — PyTorch/CUDA training CLI.

The port's counterpart of ``main.py``: the same flags, run-directory naming
and ``data.txt`` columns, for the part of the system that is ported so far —
Adam or stochastic reconfiguration (``--sr``, with ``--sr_solver`` and
``--fisher_refresh``), the exact Laplacian or ``--hutchinson``, in batched
passes or ``--forloop_laplacian``, the analytic Slater Laplacian or the
generic-AD one (``--laplacian ad``), and the Metropolis log-density on the
hand-written CUDA kernels or, with ``--slow_logp``, by ``jacfwd`` and
``slogdet`` with no kernel; the depth-2 closure kernels behind
``--mc_d2_kernel`` / ``--acc_d2_kernel``; the update tripwire
(``--tripwire_sigma``, on by default as in ``main.py``) and the hang watchdog
(``--hang_timeout``).  Runs on the GPU unless ``--cpu`` is given.

Data parallelism, one process per GPU over ``torch.distributed``
(``coulombgas_tpu_torch/parallel/mesh.py``): ``--num_devices K`` starts K
processes on this host (0: every visible GPU; under ``--cpu``, K gloo
processes, 0 meaning one); ``--multihost --coordinator H:P --num_processes N
--process_id i`` makes this process rank i of N, and ``--multihost`` alone
reads a ``torchrun``, Open MPI or SLURM job's environment, as
``jax.distributed.initialize`` reads the latter two (the counts missing
beside ``--coordinator`` too).  Each rank holds ``--batch`` / W walkers of
the global batch; a ``--microbatch`` chunk's clip window is reduced over the
ranks that hold it, the epoch's accumulators and the accept rate are
averaged over the ranks, rank 0's parameters and SR updates are broadcast,
and rank 0 alone writes the run directory.

The pretrained VAN is read from ``params_van.pkl`` under ``--folder``, where
``main.py`` writes and looks for it; where there is none, the free-fermion
pretraining runs first (``--pre_batch``, ``--pre_epoch``) and writes it there.

Examples (the checked-in pretrainings and the n = 57 epoch-100 checkpoint):
  python main_torch.py --folder data/interacting/ --out_folder runs/ --epoch 100
  python main_torch.py --hutchinson --folder data/interacting/ --epoch 100
  python main_torch.py --sr --sr_solver host64 --hutchinson --mc_d2_kernel \
      --acc_d2_kernel --folder data/interacting/ --out_folder runs/ --epoch 100
  python main_torch.py --n 57 --rs 1.0 --Emax 49 --batch 512 --acc_steps 16 --sr \
      --hutchinson --sr_solver host64 --tripwire_sigma 6 --epoch_finished 100 \
      --epoch 110 --folder data/interacting_n57_goodseed/ --out_folder runs/n57/
  (the last resumes from runs/n57/<run directory>/epoch_000100.pkl: copy the
  checked-in checkpoint there first; --out_folder keeps data/ unwritten)
  python main_torch.py --num_devices 2 --sr --hutchinson --folder data/interacting/ \
      --out_folder runs/ --epoch 100
  torchrun --nproc_per_node 4 main_torch.py --multihost --sr --hutchinson \
      --folder data/interacting/ --out_folder runs/ --epoch 100
  srun --ntasks 8 --gpus-per-task 1 python main_torch.py --multihost --sr \
      --hutchinson --folder data/interacting/ --out_folder runs/ --epoch 100
"""

import argparse
import copy
import hashlib
import math
import os
import re
import socket
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from coulombgas_tpu_torch.config import default_precision, resolve_device
from coulombgas_tpu_torch.io.checkpoint import (
    ckpt_filename, from_host, load_data, pretrained_model_filename, save_data,
)
from coulombgas_tpu_torch.io.convert import (
    adam_state_from_reference, flow_from_numpy, flow_to_numpy, sr_state_from_reference,
    van_from_numpy, van_to_numpy,
)
from coulombgas_tpu_torch.io.logging import ObservableLog, stderr_from_moments
from coulombgas_tpu_torch.models.ferminet import (
    FermiNetConfig, ferminet_apply, init_ferminet_params,
)
from coulombgas_tpu_torch.models.ferminet_jac import select_flow_jac
from coulombgas_tpu_torch.models.transformer import TransformerConfig, init_transformer_params
from coulombgas_tpu_torch.ops.cuda_flow_d2 import flow_d2_fits, flow_u_jac_lap_d2_cuda
from coulombgas_tpu_torch.optim.host_sr import HostFisherCache, host_hybrid_apply
from coulombgas_tpu_torch.optim.sr import hybrid_fisher_sr
from coulombgas_tpu_torch.parallel import mesh
from coulombgas_tpu_torch.physics.ewald import kpoints, madelung
from coulombgas_tpu_torch.physics.orbitals import sp_orbitals, twist_sort
from coulombgas_tpu_torch.sampling.autoregressive import (
    make_autoregressive_sampler, make_classical_score,
)
from coulombgas_tpu_torch.train.loss import make_loss
from coulombgas_tpu_torch.train.pretrain import pretrain
from coulombgas_tpu_torch.train.train import (
    accumulate_graph_blocker, apply_raveled_update, chunk_layout, init_accumulators,
    make_accumulate_and_apply, make_sample_step, reduce_accumulators, sample_graph_blocker,
)
from coulombgas_tpu_torch.train.tripwire import UpdateTripwire
from coulombgas_tpu_torch.utils.watchdog import StepWatchdog
from coulombgas_tpu_torch.wavefunction.fast_laplacian import (
    make_logpsi_grad_laplacian_analytic,
)
from coulombgas_tpu_torch.wavefunction.fast_logp import make_logp_fast
from coulombgas_tpu_torch.wavefunction.logpsi import (
    make_logp, make_logphi_logjacdet, make_logpsi, make_logpsi_fast,
    make_logpsi_grad_laplacian, make_quantum_score,
)

# Rank r's generator seed on a fresh start; rank 0's is the one-process seed.
SEED = 42


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Finite-temperature VMC for the homogeneous electron gas (PyTorch/CUDA)"
    )
    parser.add_argument("--folder", default="./data/", help="the folder to save data")
    parser.add_argument("--out_folder", default=None,
                        help="where the run directory is made (default: --folder, which "
                             "also holds the pretrained VAN); keeps a run apart from "
                             "checked-in data of the same hyperparameters")

    # physical parameters
    parser.add_argument("--n", type=int, default=29, help="total number of electrons")
    parser.add_argument("--dim", type=int, default=2, help="spatial dimension")
    parser.add_argument("--rs", type=float, default=10.0, help="rs")
    parser.add_argument("--Theta", type=float, default=0.15, help="dimensionless temperature T/Ef")
    parser.add_argument("--twist", type=float, nargs="+", default=[1 / 4, 1 / 4],
                        help="(scaled) twist angle in [-1/2, 1/2]^dim")

    # autoregressive transformer
    parser.add_argument("--Emax", type=int, default=25, help="single-particle energy cutoff")
    parser.add_argument("--nlayers", type=int, default=2)
    parser.add_argument("--modelsize", type=int, default=16)
    parser.add_argument("--nheads", type=int, default=4)
    parser.add_argument("--nhidden", type=int, default=32)

    # normalizing flow
    parser.add_argument("--depth", type=int, default=2)
    parser.add_argument("--spsize", type=int, default=16)
    parser.add_argument("--tpsize", type=int, default=16)

    # Ewald
    parser.add_argument("--Gmax", type=int, default=15)
    parser.add_argument("--kappa", type=int, default=10)

    # MCMC
    parser.add_argument("--mc_therm", type=int, default=10)
    parser.add_argument("--mc_steps", type=int, default=50)
    parser.add_argument("--mc_stddev", type=float, default=0.1)

    # technical
    parser.add_argument("--hutchinson", action="store_true",
                        help="Hutchinson estimate of the flow-Jacobian Laplacian")
    parser.add_argument("--forloop_laplacian", action="store_true",
                        help="sequential Hessian columns (less memory) instead of batched")
    parser.add_argument("--laplacian", choices=["analytic", "ad"], default="analytic",
                        help="Slater-part Laplacian: closed-form plane-wave identities "
                             "or generic reverse-over-reverse AD")
    parser.add_argument("--slow_logp", action="store_true",
                        help="the slogdet-based Metropolis density (jacfwd of the flow, "
                             "no kernel) instead of the Gram-Cholesky kernels")
    parser.add_argument("--mc_microbatch", type=int, default=0,
                        help="batch-chunk size for the MCMC logp (0 = whole batch)")
    parser.add_argument("--flow_jac", choices=["auto", "carried", "d2"], default="auto")
    parser.add_argument("--mc_d2_kernel", action="store_true")
    parser.add_argument("--acc_d2_kernel", action="store_true")

    # optimizer
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--sr", action="store_true", help="stochastic reconfiguration")
    parser.add_argument("--damping", type=float, default=1e-3)
    parser.add_argument("--max_norm", type=float, default=1e-3)
    parser.add_argument("--sr_solver", choices=["plain", "refined", "chol", "host64"],
                        default="plain")
    parser.add_argument("--fisher_refresh", type=int, default=1,
                        help="host64 only: renew the classical Fisher factor every K "
                             "epochs (no effect under another solver or Adam)")
    parser.add_argument("--hang_timeout", type=float, default=0.0,
                        help="hard-exit with code 42 if no epoch completes for this many "
                             "seconds (0 disables; the first interval gets a 4x grace "
                             "for the kernel builds)")
    parser.add_argument("--tripwire_sigma", type=float, default=15.0,
                        help="revert an update when F jumps upward by more than this many "
                             "combined standard errors in one epoch (<= 0 disables)")
    parser.add_argument("--timing", action="store_true",
                        help="print the seconds of sample / accumulate / apply every epoch "
                             "(and the peak device memory on a GPU)")

    # training
    parser.add_argument("--batch", type=int, default=2048,
                        help="batch size per gradient-accumulation step (global)")
    parser.add_argument("--num_devices", type=int, default=0,
                        help="processes on this host, one per GPU (0 = all visible GPUs; "
                             "under --cpu, gloo processes, 0 = one)")
    parser.add_argument("--acc_steps", type=int, default=4)
    parser.add_argument("--microbatch", type=int, default=0,
                        help="gradient-chunk size bounding device memory (0 = whole batch)")
    parser.add_argument("--epoch_finished", type=int, default=0)
    parser.add_argument("--epoch", type=int, default=3000)
    parser.add_argument("--ckpt_every", type=int, default=100)

    # pretraining (names the directory of the pretrained VAN)
    parser.add_argument("--pre_batch", type=int, default=8192)
    parser.add_argument("--pre_epoch", type=int, default=5000)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU (f64)")
    parser.add_argument("--multihost", action="store_true",
                        help="join a process group of one process per GPU (with "
                             "--coordinator, or from a torchrun, Open MPI or SLURM "
                             "job's environment)")
    parser.add_argument("--coordinator", default=None,
                        help="multihost: rank 0's host:port")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="multihost: the number of processes (default: the job's)")
    parser.add_argument("--process_id", type=int, default=None,
                        help="multihost: this process's rank (default: the job's)")
    return parser.parse_args(argv)


def reject_unmet(args):
    """Refuse, with one line each, the requests that this run's other flags
    cannot meet."""
    # the depth-2 closed form and its kernels: a request that cannot be met
    # fails here, nothing else stands in
    for hit, flag in ((args.flow_jac == "d2", "--flow_jac d2"),
                      (args.mc_d2_kernel, "--mc_d2_kernel"),
                      (args.acc_d2_kernel, "--acc_d2_kernel")):
        if hit and args.depth != 2:
            raise SystemExit("main_torch.py: %s requires --depth 2 (got %d)" % (flag, args.depth))
    if args.sr and args.sr_solver == "host64" and args.fisher_refresh < 1:
        # main.py would divide by it
        raise SystemExit("main_torch.py: --fisher_refresh must be at least 1 under "
                         "--sr --sr_solver host64")


@dataclass(frozen=True)
class Launch:
    """How this invocation runs: ``world_size`` processes, started here
    (``spawn``) or each started by the user (``--multihost``), and for the
    latter this process's ``rank``, ``init_method`` and local GPU index."""

    world_size: int
    spawn: bool = False
    rank: int = 0
    init_method: str | None = None
    local_index: int = 0


@dataclass(frozen=True)
class Cluster:
    """The process layout a cluster's launcher gives this process."""

    name: str
    world_size: int
    rank: int
    local_rank: int | None
    coordinator: str | None = None  # host:port of rank 0; None: torchrun's env://


# JAX's port range for a coordinator it derives from a job id
# (jax/_src/clusters: the ephemeral range [65535 - 2^12 + 1, 65535])
_PORT_BASE, _PORT_SPAN = 65535 - 2**12 + 1, 2**12


def _slurm_first_host(node_list: str) -> str:
    """The first host of a SLURM node list: ``node001``, ``node001,host2``,
    ``node[001-015],host2`` and ``node[001,007-015],host2`` all give
    ``node001`` (jax/_src/clusters/slurm_cluster.py).  ``node[001]`` gives
    ``node001`` here, where that file keeps the bracket."""
    ind = next((i for i, ch in enumerate(node_list) if ch in ",["), len(node_list))
    if ind == len(node_list) or node_list[ind] == ",":
        return node_list[:ind]
    suffix = node_list[ind + 1:]
    end = next((i for i, ch in enumerate(suffix) if ch in ",-]"), None)
    return node_list[:ind] + suffix[:end]


def cluster_environment(environ=os.environ) -> Cluster | None:
    """The cluster that started this process, read from its environment:
    ``torchrun``'s (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``), then, in the order ``jax.distributed.initialize``
    tries them, Open MPI's (``OMPI_MCA_orte_hnp_uri``,
    ``OMPI_COMM_WORLD_SIZE/RANK/LOCAL_RANK``) and SLURM's (``SLURM_JOB_ID``,
    ``SLURM_STEP_NODELIST``, ``SLURM_NTASKS``, ``SLURM_PROCID``,
    ``SLURM_LOCALID``), with the coordinator address JAX derives there
    (``JAX_COORDINATOR_PORT`` overrides its port).  None outside a cluster."""
    if all(k in environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")):
        local = environ.get("LOCAL_RANK")
        return Cluster("torchrun", int(environ["WORLD_SIZE"]), int(environ["RANK"]),
                       None if local is None else int(local))
    port = environ.get("JAX_COORDINATOR_PORT")
    if "OMPI_MCA_orte_hnp_uri" in environ:
        uri = environ["OMPI_MCA_orte_hnp_uri"]
        if not port:  # the job id is a multiple of 2^12
            port = str(int(uri.split(".", maxsplit=1)[0]) // 2**12 % _PORT_SPAN + _PORT_BASE)
        found = re.search(r"tcp://(.+?)[,:]|tcp6://\[(.+?)[,\]]", uri)
        if found is None:
            raise SystemExit("main_torch.py: no coordinator address in OMPI_MCA_orte_hnp_uri "
                             "(%s)" % uri)
        host = next(g for g in found.groups() if g is not None)
        return Cluster("ompi", int(environ["OMPI_COMM_WORLD_SIZE"]),
                       int(environ["OMPI_COMM_WORLD_RANK"]),
                       int(environ["OMPI_COMM_WORLD_LOCAL_RANK"]), "%s:%s" % (host, port))
    slurm = ("SLURM_JOB_ID", "SLURM_STEP_NODELIST", "SLURM_NTASKS", "SLURM_PROCID",
             "SLURM_LOCALID")
    if all(k in environ for k in slurm):
        if not port:
            port = str(int(environ["SLURM_JOB_ID"]) % _PORT_SPAN + _PORT_BASE)
        host = _slurm_first_host(environ["SLURM_STEP_NODELIST"])
        return Cluster("slurm", int(environ["SLURM_NTASKS"]), int(environ["SLURM_PROCID"]),
                       int(environ["SLURM_LOCALID"]), "%s:%s" % (host, port))
    return None


def _tcp(address: str) -> str:
    """``tcp://host:port`` for ``torch.distributed``, an IPv6 host in brackets."""
    host, _, port = address.rpartition(":")
    return "tcp://%s:%s" % ("[%s]" % host if ":" in host and not host.startswith("[") else host,
                            port)


def plan_launch(args, environ=os.environ) -> Launch:
    """The process layout the device flags ask for, as ``main.py`` reads
    them; every refusal happens here, before any process group is formed.

    ``--multihost`` takes what its flags give and the rest from the cluster
    that started this process (``cluster_environment``), as
    ``jax.distributed.initialize`` does; the cluster's local rank picks the
    card."""
    if args.multihost:
        env = cluster_environment(environ)
        if args.coordinator is not None:
            world, rank = args.num_processes, args.process_id
            if env is not None:
                world = env.world_size if world is None else world
                rank = env.rank if rank is None else rank
            if world is None or rank is None:
                raise SystemExit("main_torch.py: --multihost --coordinator needs "
                                 "--num_processes and --process_id outside a torchrun, "
                                 "Open MPI or SLURM job")
            init = _tcp(args.coordinator)
        elif env is None:
            raise SystemExit("main_torch.py: --multihost without --coordinator reads a "
                             "torchrun, Open MPI or SLURM job's environment, and there is none")
        else:
            world, rank = env.world_size, env.rank
            init = "env://" if env.coordinator is None else _tcp(env.coordinator)
        if not 0 <= rank < world:
            raise SystemExit("main_torch.py: process %d is not one of %d" % (rank, world))
        if args.num_devices not in (0, world):
            # main.py fails here too: its mesh is the first K devices of all
            # processes', and a process holding none of them dies in shard_batch
            raise SystemExit("main_torch.py: --multihost runs one process per GPU; "
                             "--num_devices %d differs from its %d processes"
                             % (args.num_devices, world))
        # the job's local rank picks the card, modulo the cards this process
        # sees (a launcher may show each task its own card alone)
        cards = 1 if args.cpu else max(torch.cuda.device_count(), 1)
        local = rank if env is None or env.local_rank is None else env.local_rank
        plan = Launch(world, rank=rank, init_method=init, local_index=local % cards)
    elif args.cpu:
        plan = Launch(max(args.num_devices, 1), spawn=args.num_devices > 1)
    else:
        cards = torch.cuda.device_count()
        world = min(args.num_devices or cards, cards) if cards else 1
        if cards and args.num_devices > cards:
            print("main_torch.py: --num_devices %d, but %d GPUs are visible: running on %d"
                  % (args.num_devices, cards, world))
        plan = Launch(world, spawn=world > 1)
    try:
        chunk_layout(args.batch, args.microbatch or None, plan.world_size)
    except ValueError as err:
        raise SystemExit("main_torch.py: %s" % err)
    return plan


def free_port() -> int:
    """A TCP port of this host that is free now (for rank 0 to listen on)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_device(args, index: int) -> torch.device:
    return torch.device("cpu") if args.cpu else torch.device("cuda", index)


# The pretraining's optimizer, fixed as main.py fixes it: SR, plain solver.
PRE_SR, PRE_DAMPING, PRE_MAXNORM, PRE_LR = True, 0.001, 0.001, 1e-3


def freefermion_path(args, twist):
    """Directory of the pretrained VAN, as main.py names it."""
    return os.path.join(
        args.folder, "freefermion", "pretraining",
        "n_%d_dim_%d_Theta_%.2f_Emax_%d" % (args.n, args.dim, args.Theta, args.Emax)
        + ("_twist" + "_%.3f" * args.dim) % tuple(twist),
        "nlayers_%d_modelsize_%d_nheads_%d_nhidden_%d" % (
            args.nlayers, args.modelsize, args.nheads, args.nhidden)
        + "_damping_%.5f_maxnorm_%.5f" % (PRE_DAMPING, PRE_MAXNORM)
        + "_batch_%d" % args.pre_batch,
    )


def run_directory(args, twist, folder, ndevices: int = 1, make: bool = True):
    """Run directory named by the hyperparameters, byte for byte as main.py's
    (rs in repr-style float formatting; ``ndevices`` the world size); names
    over 255 bytes are truncated and hashed, with the full name kept in
    ``runname.txt``.  ``make``: create it (rank 0's job)."""
    n, dim = args.n, args.dim
    path = os.path.join(
        folder,
        "n_%d_dim_%d_rs_%s_Theta_%.2f" % (n, dim, float(args.rs), args.Theta)
        + "_Emax_%d" % args.Emax
        + ("_twist" + "_%.3f" * dim) % tuple(twist)
        + "_nlayers_%d_modelsize_%d_nheads_%d_nhidden_%d" % (
            args.nlayers, args.modelsize, args.nheads, args.nhidden)
        + "_depth_%d_spsize_%d_tpsize_%d" % (args.depth, args.spsize, args.tpsize)
        + "_Gmax_%d_kappa_%d" % (args.Gmax, args.kappa)
        + "_mctherm_%d_mcsteps_%d_mcstddev_%.2f" % (args.mc_therm, args.mc_steps, args.mc_stddev)
        + ("_hutchinson" if args.hutchinson else "")
        + ("_damping_%.5f_maxnorm_%.5f" % (args.damping, args.max_norm)
           if args.sr else "_lr_%.3f" % args.lr)
        + "_batch_%d_ndevices_%d_accsteps_%d" % (args.batch, ndevices, args.acc_steps),
    )
    run_name = os.path.basename(path)
    if len(run_name.encode()) > 255:
        digest = hashlib.sha1(run_name.encode()).hexdigest()[:10]
        short = run_name.encode()[: 255 - 11].decode(errors="ignore")
        path = os.path.join(os.path.dirname(path), short + "~" + digest)
        if make:
            os.makedirs(path, exist_ok=True)
            with open(os.path.join(path, "runname.txt"), "w") as f:
                f.write(run_name + "\n")
    if make:
        os.makedirs(path, exist_ok=True)
    return path


@dataclass
class Trainer:
    """Everything one training run holds."""

    args: argparse.Namespace
    device: torch.device
    L: float
    sp_indices: np.ndarray
    van: torch.nn.Module
    flow: torch.nn.Module
    sampler: object
    logp: object
    sample_step: object
    accumulate: object
    apply_update: object
    optimizer: torch.optim.Optimizer | None  # None under --sr
    sr_state: dict | None                    # diagnostics of the last SR solve
    fisher_cache: HostFisherCache | None     # --sr_solver host64 --fisher_refresh K > 1
    generator: torch.Generator
    x: torch.Tensor                          # this rank's walkers
    path: str
    mesh: mesh.Mesh                          # rank and world size (1 without a group)
    loss: object = None                      # make_loss's observable_and_lossfn
    sr_opt: object = None                    # the hybrid SR under --sr

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def rank_seed(rank: int, epoch: int | None = None) -> int:
    """Seed of rank ``rank``'s generator: ``SEED + rank`` on a fresh start
    (rank 0's is the one-process seed), and a hash of (SEED, epoch, rank)
    where a resume at another world size cannot continue the saved streams."""
    if epoch is None:
        return SEED + rank
    digest = hashlib.sha256(b"%d:%d:%d" % (SEED, epoch, rank)).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def build_trainer(args, out_folder=None) -> Trainer:
    """Models, samplers, loss and optimizer for ``args``, on this process's
    rank of the process group (``parallel.mesh``), or alone without one.

    The pretrained VAN is read from under ``args.folder`` (by rank 0, which
    sends it to the others); the run directory is made under ``out_folder``
    (default: ``args.folder``) by rank 0.
    """
    reject_unmet(args)
    grid = mesh.current()
    world = grid.world_size
    device = grid.device if grid.device is not None else resolve_device(
        "cpu" if args.cpu else None)
    prec = default_precision(device)
    rdtype = prec.real
    print("torch", torch.__version__, "device:", device, "precision:", rdtype)
    if grid.backend is not None:
        print("rank %d of %d (%s)" % (grid.rank, world, grid.backend))
    layout = chunk_layout(args.batch, args.microbatch or None, world)
    local_batch = args.batch // world

    n, dim = args.n, args.dim
    if dim == 3:
        L = float((4 / 3 * np.pi * n) ** (1 / 3))
        beta = 1 / ((4.5 * np.pi) ** (2 / 3) * args.Theta)
    elif dim == 2:
        L = float(np.sqrt(np.pi * n))
        beta = 1 / (4 * args.Theta)
    else:
        raise ValueError("dim must be 2 or 3")
    print("n = %d, dim = %d, L = %f" % (n, dim, L))
    twist = np.array(args.twist)
    if twist.size != dim:
        raise ValueError("--twist needs %d components" % dim)

    # ---- single-particle orbitals --------------------------------------
    sp_indices, Es = sp_orbitals(dim, args.Emax)
    num_states = Es.size
    print("Number of available single-particle orbitals: %d" % num_states)
    sp_indices_twist, _ = twist_sort(sp_indices, twist)
    # highest-energy states first (empty tail at small indices)
    sp_indices_twist = sp_indices_twist[::-1].copy()

    # ---- VAN ------------------------------------------------------------
    cpu_gen = torch.Generator().manual_seed(42)
    van_cfg = TransformerConfig(num_states, args.nlayers, args.modelsize,
                                args.nheads, args.nhidden)
    van = init_transformer_params(van_cfg, dim, cpu_gen, rdtype, device)
    print("#parameters in the autoregressive model: %d"
          % sum(p.numel() for p in van.parameters()))
    sampler, log_prob = make_autoregressive_sampler(sp_indices_twist, n, num_states)

    pre_path = freefermion_path(args, twist)
    pre_fname = pretrained_model_filename(pre_path)
    if grid.rank != 0:
        # rank 0's pretraining may outlast any collective's timeout
        print("Pretrained free-fermion model: rank 0's")
        mesh.wait_for_rank0("pretrained")
    elif os.path.isfile(pre_fname):
        print("Load pretrained free-fermion model:", pre_fname)
        van_from_numpy(load_data(pre_fname), van)
    else:
        print("No pretrained model found; running free-fermion pretraining...")
        os.makedirs(pre_path, exist_ok=True)
        pretrain(van, n, dim, args.Theta, args.Emax, twist, pre_path,
                 torch.Generator(device=device).manual_seed(41),
                 PRE_LR, PRE_SR, PRE_DAMPING, PRE_MAXNORM, args.pre_batch, epoch=args.pre_epoch)
        save_data(van_to_numpy(van), pre_fname)
        print("Pretraining done; saved to", pre_fname)
    mesh.release("pretrained")

    # ---- flow + logpsi ----------------------------------------------------
    flow_cfg = FermiNetConfig(args.depth, args.spsize, args.tpsize, L)
    flow = init_ferminet_params(flow_cfg, dim, cpu_gen, rdtype, device)
    print("#parameters in the flow model: %d" % sum(p.numel() for p in flow.parameters()))
    # every rank starts from rank 0's parameters (its VAN may be the only
    # pretrained one: no filesystem is assumed to be shared)
    mesh.replicate([*van.state_dict().values(), *flow.state_dict().values()])
    flow_jac, flow_jac_lap = select_flow_jac(flow_cfg, args.flow_jac)
    if args.slow_logp:
        # escape hatch: jacfwd Jacobians and LU slogdets everywhere, no kernel
        logpsi = make_logpsi(ferminet_apply, sp_indices_twist, L)
        logp = make_logp(logpsi)
        route = "make_logp(make_logpsi): jacfwd of the flow + slogdet, no kernel"
        if args.mc_d2_kernel:  # main.py ignores it here too
            route += " (--mc_d2_kernel has no effect)"
    else:
        logpsi = make_logpsi_fast(flow_jac, sp_indices_twist, L)
        # Metropolis density: the flow kernel feeding the fused log-det tail
        # kernel (--mc_d2_kernel: the depth-2 closure kernel in the flow
        # kernel's place).  Past a kernel's size limit the closure takes the
        # reference's route around it; the route is named here, so that
        # nothing is chosen silently.
        logp = make_logp_fast(sp_indices_twist, L, chunk=args.mc_microbatch or None,
                              jacobian=flow_jac, use_d2_flow=args.mc_d2_kernel)
        route = logp.route(n, dim, flow_cfg, device)
    print("logp route: %s%s" % (route, " (plain versions on the CPU)"
                                if device.type == "cpu" and not args.slow_logp else ""))
    why = sample_graph_blocker(logp, device)
    print("sample step: %s" % ("eager (%s)" % why if why else "CUDA graph"))

    # ---- Ewald -------------------------------------------------------------
    G = kpoints(dim, args.Gmax)
    Vconst = n * args.rs / L * madelung(dim, args.kappa, G)
    print("(scaled) Vconst:", Vconst / (n * args.rs / L))

    # ---- optimizer -----------------------------------------------------------
    sr_opt = sr_state = optimizer = fisher_cache = None
    if args.sr:
        refined = args.sr_solver in ("refined", "chol")
        sr_opt = hybrid_fisher_sr(
            make_classical_score(log_prob), make_quantum_score(logpsi),
            args.damping, args.max_norm, refine=2 if refined else 0, jacobi=refined,
            chol=args.sr_solver == "chol")
        sr_state = {k: float(v) for k, v in sr_opt.init().items()}
        if args.sr_solver == "host64" and args.fisher_refresh > 1:
            fisher_cache = HostFisherCache(args.damping)
        print("Optimizer hybrid_fisher_sr: damping = %.5f, max_norm = %.5f, solver = %s"
              % (args.damping, args.max_norm, args.sr_solver))
    else:
        optimizer = torch.optim.Adam(
            [*van.parameters(), *flow.parameters()], lr=args.lr, betas=(0.9, 0.999), eps=1e-8)
        print("Optimizer adam: lr = %.3f" % args.lr)
    if args.fisher_refresh != 1 and not (args.sr and args.sr_solver == "host64"):
        # main.py reads it under host64 only
        print("--fisher_refresh %d has no effect without --sr --sr_solver host64"
              % args.fisher_refresh)

    path = run_directory(args, twist, out_folder or args.folder, world, make=grid.rank == 0)
    mesh.barrier()
    print("Run directory:", path)

    # ---- training programs --------------------------------------------------
    # each rank samples its share of the global batch
    sample_step = make_sample_step(sampler, logp, args.mc_steps, args.mc_stddev, L, local_batch)
    if args.laplacian == "analytic":
        flow_jac_lap_batched = None
        if args.acc_d2_kernel:
            # the primal flow + Jacobian + Laplacian of the kinetic energy from
            # the depth-2 closure kernel, one launch for the batch; an
            # explicit request, so it engages or the run ends here
            if args.slow_logp:
                raise SystemExit("main_torch.py: --acc_d2_kernel requires the fast logp "
                                 "path, not --slow_logp")
            if not flow_d2_fits(n, dim, flow_cfg, lap=True, device=device):
                raise SystemExit(
                    "main_torch.py: --acc_d2_kernel requested but the depth-2 closure "
                    "kernel cannot engage: n = %d, dim = %d, widths %d/%d are beyond its "
                    "limits (n <= 64, dim <= 3, widths <= 32)"
                    % (n, dim, args.spsize, args.tpsize))
            flow_jac_lap_batched = flow_u_jac_lap_d2_cuda
        # under --slow_logp the flow is differentiated by generic AD alone
        analytic = not args.slow_logp
        logpsi_grad_laplacian = make_logpsi_grad_laplacian_analytic(
            sp_indices_twist, L, flow_jac_lap if analytic else None,
            hutchinson=args.hutchinson, flow_jac=flow_jac if analytic else None,
            flow_jac_lap_batched=flow_jac_lap_batched, forloop=args.forloop_laplacian,
            flow_apply=ferminet_apply)
    else:
        if args.acc_d2_kernel:  # main.py ignores it here too
            print("laplacian route: generic AD (--acc_d2_kernel has no effect)")
        logphi, logjacdet = make_logphi_logjacdet(ferminet_apply, sp_indices_twist, L)
        logpsi_grad_laplacian = make_logpsi_grad_laplacian(
            logpsi, forloop=args.forloop_laplacian, hutchinson=args.hutchinson,
            logphi=logphi, logjacdet=logjacdet)
    # this rank's pieces of the global batch's microbatch chunks; the clip
    # window of a chunk several ranks hold is reduced over exactly those
    observable_and_lossfn = make_loss(
        log_prob, logpsi, logpsi_grad_laplacian, args.kappa, G, L, args.rs, Vconst, beta)
    accumulate, apply_update = make_accumulate_and_apply(
        observable_and_lossfn, args.acc_steps, pieces=mesh.window_groups(layout), sr_opt=sr_opt,
        fisher_dtype=fisher_dtype(args))
    why = accumulate_graph_blocker(observable_and_lossfn, sr_opt, device)
    print("accumulate: %s" % ("eager (%s)" % why if why else "CUDA graph"))

    # one stream per rank; this rank's walkers
    generator = torch.Generator(device=device).manual_seed(rank_seed(grid.rank))
    x = L * torch.rand(local_batch, n, dim, generator=generator, dtype=rdtype, device=device)
    return Trainer(args, device, L, sp_indices_twist, van, flow, sampler, logp,
                   sample_step, accumulate, apply_update, optimizer, sr_state, fisher_cache,
                   generator, x, path, grid, observable_and_lossfn, sr_opt)


def restore(tr: Trainer) -> bool:
    """Load the checkpoint of ``--epoch_finished`` if the run directory has
    it (rank 0 reads it and sends it to the others).

    The global walkers are cut into this world's shares; the generators
    continue their saved streams where the checkpoint has one per rank of
    this world size, and are seeded anew from (seed, epoch, rank) otherwise.
    A ``main.py`` checkpoint's optimizer state carries over (optax Adam's
    moments and step count, or the hybrid-SR state); its JAX key does not.
    """
    args, grid = tr.args, tr.mesh
    fname = ckpt_filename(args.epoch_finished, tr.path)
    ckpt = None
    if grid.rank == 0 and os.path.isfile(fname):
        ckpt = load_data(fname)
    ckpt = mesh.broadcast_object(ckpt)
    if ckpt is None:
        return False
    print("Load checkpoint:", fname)
    if ckpt["x"].shape[0] != args.batch:
        raise ValueError("checkpoint walker batch %d != --batch %d; resume with the "
                         "original batch size" % (ckpt["x"].shape[0], args.batch))
    tr.x = torch.as_tensor(mesh.shard_batch(ckpt["x"])).to(tr.x)
    van_from_numpy(ckpt["params_van"], tr.van)
    flow_from_numpy(ckpt["params_flow"], tr.flow)
    if "torch_opt_state" in ckpt:  # this script's own
        if args.sr:  # the diagnostics of the last SR solve
            tr.sr_state = dict(ckpt["torch_opt_state"])
        else:
            tr.optimizer.load_state_dict(from_host(ckpt["torch_opt_state"]))
    elif "opt_state" in ckpt:  # main.py's
        opt = ckpt["opt_state"]
        if args.sr and isinstance(opt, dict):
            tr.sr_state = sr_state_from_reference(opt)
            print("Carried over main.py's SR state:", tr.sr_state)
        elif args.sr:  # older SR checkpoints keep an empty state
            print("The checkpoint holds no SR state")
        elif isinstance(opt, tuple) and opt and len(opt[0]) == 3:
            step = adam_state_from_reference(opt, tr.van, tr.flow, tr.optimizer)
            print("Carried over main.py's Adam moments at step %d" % step)
        else:
            raise ValueError("the checkpoint's optimizer state is not optax Adam's; "
                             "resume it with --sr")
    if "key" in ckpt:
        print("The checkpoint's JAX random key does not carry over; "
              "the generators keep their seeds")
    states = ckpt.get("torch_generators")
    if states is None and "torch_generator" in ckpt:
        states = [ckpt["torch_generator"]]
    if states is not None and len(states) == grid.world_size:
        tr.generator.set_state(torch.as_tensor(states[grid.rank]))
    elif states is not None:
        print("The checkpoint's %d generator streams do not fit %d ranks: each rank's is "
              "seeded from (seed, epoch %d, rank)"
              % (len(states), grid.world_size, args.epoch_finished))
        tr.generator.manual_seed(rank_seed(grid.rank, args.epoch_finished))
    return True


def checkpoint(tr: Trainer, epoch: int):
    """Rank 0 writes the global walkers (gathered in rank order), the
    parameters, the optimizer state and every rank's generator state; every
    rank must call it."""
    x = mesh.host_gather(tr.x)
    state = tr.generator.get_state()
    states = mesh.host_gather(state[None]) if tr.mesh.world_size > 1 else None
    if tr.mesh.rank != 0:
        return
    ckpt = {
        "x": x, "params_van": van_to_numpy(tr.van), "params_flow": flow_to_numpy(tr.flow),
        "torch_opt_state": tr.sr_state if tr.args.sr else tr.optimizer.state_dict(),
        "torch_generator": state,
    }
    if states is not None:
        ckpt["torch_generators"] = list(states)
    fname = ckpt_filename(epoch, tr.path)
    save_data(ckpt, fname)
    print("Save checkpoint file:", fname)


def fisher_dtype(args):
    """The precision the Fisher blocks are formed and summed in: float64
    for the float64 solve (``--sr_solver host64``), whose damped Cholesky a
    float32 sum can make indefinite; None (the working precision) else."""
    return torch.float64 if args.sr and args.sr_solver == "host64" else None


def stale_classical(tr: Trainer, epoch: int) -> bool:
    """Whether this epoch's host64 apply solves the classical block with the
    cached factor (``--fisher_refresh K``, between refreshes): it then reads
    no classical Fisher."""
    args = tr.args
    if not (args.sr and args.sr_solver == "host64"):
        return False
    refresh = (epoch - 1) % args.fisher_refresh == 0
    return tr.fisher_cache is not None and tr.fisher_cache.ready and not refresh


def apply_step(tr: Trainer, acc, epoch: int, seconds: dict, trust_scale: float = 1.0):
    """The epoch's update: Adam, the hybrid-SR solve in the working precision
    (``--sr_solver plain | refined | chol``), or the float64 apply
    (``host64``; with ``--fisher_refresh K`` the classical factor is renewed
    every K epochs).  Every SR solve's update and diagnostics are rank 0's.
    Returns (observables, SR diagnostics) as Python floats and adds the solve
    phases to ``seconds``."""
    args = tr.args
    t0 = time.time()
    if args.sr and args.sr_solver == "host64":
        stale = stale_classical(tr, epoch)
        view = {k: v for k, v in acc.items() if k != "classical_fisher"} if stale else acc
        upd_van, upd_flow, d, diag = host_hybrid_apply(
            view, args.acc_steps, args.damping, args.max_norm * trust_scale,
            cache=tr.fisher_cache, van=tr.van, flow=tr.flow)
        d, diag = mesh.replicate_update(upd_van, upd_flow, d, diag)
        tr.sync()
        seconds["solve64"] = time.time() - t0
        t1 = time.time()
        apply_raveled_update(tr.van, tr.flow, upd_van, upd_flow)
        tr.sync()
        seconds["param_update"] = time.time() - t1
    else:
        data = tr.apply_update(tr.van, tr.flow, tr.optimizer, acc, trust_scale)
        d = {k: float(v) for k, v in data.items()}
        diag = {k[5:]: d.pop(k) for k in [k for k in d if k.startswith("diag_")]}
        tr.sync()
    seconds["apply"] = time.time() - t0
    return d, diag


def snapshot_state(tr: Trainer):
    """What the update tripwire keeps of the state entering an epoch: the
    parameters, the optimizer or SR state, a COPY of the walkers (the loop
    rebinds ``tr.x``, and a revert may hand the same snapshot out twice) and
    the generator state — a bad step poisons the Markov chains as well."""
    return ({k: v.detach().clone() for k, v in tr.van.state_dict().items()},
            {k: v.detach().clone() for k, v in tr.flow.state_dict().items()},
            copy.deepcopy(tr.optimizer.state_dict()) if tr.optimizer is not None
            else dict(tr.sr_state),
            tr.x.clone(), tr.generator.get_state())


def restore_state(tr: Trainer, state):
    van, flow, opt, x, gen = state
    tr.van.load_state_dict(van)
    tr.flow.load_state_dict(flow)
    if tr.optimizer is not None:
        tr.optimizer.load_state_dict(opt)
    else:
        tr.sr_state = dict(opt)
    tr.x = x.clone()
    tr.generator.set_state(gen)


def train(args, out_folder=None) -> dict:
    """Run ``args.epoch - args.epoch_finished`` epochs on this process's rank
    (alone without a process group).  Returns the trainer, one record per
    logged epoch, the epochs the tripwire reverted and whether the
    parameters moved.  Every decision that ends or branches the loop is
    taken from values that are equal on every rank."""
    tr = build_trainer(args, out_folder)
    writer = tr.mesh.rank == 0
    if not restore(tr):
        print("No checkpoint found. Starting from scratch; thermalizing...")
        for i in range(args.mc_therm):
            t0 = time.time()
            _, tr.x, accept_rate = tr.sample_step(tr.van, tr.flow, tr.x, tr.generator)
            tr.sync()
            print("---- thermal step %d  accept %.4f  (%.3f s) ----"
                  % (i + 1, float(accept_rate), time.time() - t0))

    before = [p.detach().clone() for p in [*tr.van.parameters(), *tr.flow.parameters()]]
    log = ObservableLog(tr.path, resume=args.epoch_finished > 0) if writer else None
    diag_log = (open(os.path.join(tr.path, "sr_diag.txt"), "a", buffering=1)
                if args.sr and writer else None)
    total_batch = args.batch * args.acc_steps
    rs2 = args.rs**2
    records, reverted_epochs = [], []
    # Update tripwire: a rare catastrophic step shows as an upward F jump in
    # the NEXT epoch's observables (or as non-finite ones, an exploded
    # standard error, a collapsed accept rate); revert to the best healthy
    # state and go on; on bursts shrink the SR trust radius (train/tripwire.py).
    tripwire = UpdateTripwire(sigma=args.tripwire_sigma)
    watchdog = StepWatchdog(
        args.hang_timeout, context="n=%d rs=%g epoch>%d" % (args.n, args.rs, args.epoch_finished),
    ).start()
    try:
        for i in range(args.epoch_finished + 1, args.epoch + 1):
            tripwire.snapshot(snapshot_state(tr))
            acc = init_accumulators(tr.van, tr.flow, sr=args.sr, fisher_dtype=fisher_dtype(args))
            accept_sum = 0.0
            seconds = {"sample": 0.0, "accumulate": 0.0, "apply": 0.0}
            for _ in range(args.acc_steps):
                t0 = time.time()
                state_indices, tr.x, accept_rate = tr.sample_step(
                    tr.van, tr.flow, tr.x, tr.generator)
                tr.sync()
                seconds["sample"] += time.time() - t0
                accept_sum += float(accept_rate)
                t0 = time.time()
                acc = tr.accumulate(tr.van, tr.flow, state_indices, tr.x, tr.generator, acc)
                tr.sync()
                seconds["accumulate"] += time.time() - t0
            # one all-reduce makes every rank's accumulators the global batch's
            acc, accept_sum = reduce_accumulators(
                acc, accept_sum, leave_out=("classical_fisher",) if stale_classical(tr, i) else ())
            d, diag = apply_step(tr, acc, i, seconds, tripwire.trust_scale)
            accept = accept_sum / args.acc_steps

            # ---- tripwire check (the observables describe the PRE-apply state)
            finite = all(math.isfinite(v) for v in d.values())
            F_raw = d["F_mean"]
            F_sig = (stderr_from_moments(d["F_mean"], d["F2_mean"], total_batch)
                     if math.isfinite(d["F_mean"]) and math.isfinite(d["F2_mean"])
                     else float("nan"))
            revert_to = tripwire.check(F_raw, F_sig, finite, accept=accept,
                                       S=d["S_mean"] if math.isfinite(d["S_mean"]) else None)
            reverted = revert_to is not None
            if reverted:
                restore_state(tr, revert_to)
                reverted_epochs.append(i)
                msg = ("TRIPWIRE epoch %d: %s (F %.6f) — reverted parameters and "
                       "walkers to the best healthy state" % (i, tripwire.last_reason, F_raw))
                print(msg)
                if diag_log is not None:
                    diag_log.write("# " + msg + "\n")
                if args.sr and tripwire.trust_scale < 1.0:
                    print("TRIPWIRE: trust radius scaled to %g"
                          % (args.max_norm * tripwire.trust_scale))
            elif tripwire.drift_events and tripwire.drift_events[-1] == i - args.epoch_finished:
                # no revert target exists along a flat-F leak: warn loudly
                msg = ("TRIPWIRE epoch %d: entropy-drift ALARM — S %.4f has fallen below "
                       "the established plateau at non-improving F; suspect an "
                       "over-damped or ill-conditioned SR solve" % (i, d["S_mean"]))
                print(msg)
                if diag_log is not None:
                    diag_log.write("# " + msg + "\n")
            if args.timing:
                if tr.device.type == "cuda":
                    seconds["peak_GiB"] = torch.cuda.max_memory_allocated(tr.device) / 2**30
                print("TIMING %d: " % i + "  ".join("%s %.3f" % kv for kv in seconds.items()))
            if not reverted:
                # a reverted epoch's observables describe the corrupted state:
                # they stay out of data.txt (the event is in sr_diag.txt)
                if args.sr:
                    tr.sr_state = diag
                if diag_log is not None:
                    diag_log.write("%6d  %.6e  %.4f  %.6e  %.4f\n" % (
                        i, diag["gnorm_van"], diag["scale_van"], diag["gnorm_flow"],
                        diag["scale_flow"]))

                def col(name):
                    return (d[name + "_mean"],
                            stderr_from_moments(d[name + "_mean"], d[name + "2_mean"],
                                                total_batch))

                (F, F_std), (E, E_std), (K, K_std), (V, V_std), (S, S_std) = map(col, "FEKVS")
                if log is not None:
                    log.write_train(i, F / rs2, F_std / rs2, E / rs2, E_std / rs2, K / rs2,
                                    K_std / rs2, V / rs2, V_std / rs2, S, S_std, accept)
                records.append(dict({"epoch": i, "F": F / rs2, "E": E / rs2, "K": K / rs2,
                                     "V": V / rs2, "S": S, "accept_rate": accept,
                                     "sample_s": seconds["sample"],
                                     "accumulate_s": seconds["accumulate"],
                                     "apply_s": seconds["apply"]}, **diag))
            if i % args.ckpt_every == 0:
                checkpoint(tr, i)
            # the heartbeat ends the epoch body: every phase of it ended in a
            # device synchronize, so it certifies that the device answered,
            # and the first epoch (kernel builds, first launches) runs under
            # the watchdog's first-interval grace
            watchdog.beat()
    finally:
        watchdog.stop()
        if log is not None:
            log.close()
        if diag_log is not None:
            diag_log.close()

    after = [*tr.van.parameters(), *tr.flow.parameters()]
    changed = any(not torch.equal(a, b) for a, b in zip(after, before))
    h = hashlib.sha256()
    for p in after:
        h.update(p.detach().cpu().numpy().tobytes())
    print("final params checksum:", h.hexdigest())
    return {"trainer": tr, "epochs": records, "reverted": reverted_epochs,
            "trust_scale": tripwire.trust_scale, "params_changed": changed}


def _rank_main(rank: int, args, world_size: int, port: int):
    """One spawned rank of ``--num_devices K``: rank ``rank`` on GPU
    ``rank`` (or on the CPU under ``--cpu``)."""
    # the ranks share the launcher's stdout: one write a line keeps their
    # lines whole (a pipe takes a write of up to 4 KiB at once)
    sys.stdout.reconfigure(line_buffering=True)
    mesh.make_mesh("tcp://localhost:%d" % port, rank, world_size, _rank_device(args, rank))
    try:
        train(args, args.out_folder)
    finally:
        mesh.destroy()


def main(argv=None):
    args = parse_args(argv)
    reject_unmet(args)
    plan = plan_launch(args)
    if plan.spawn:
        import torch.multiprocessing as mp

        try:
            mp.start_processes(_rank_main, args=(args, plan.world_size, free_port()),
                               nprocs=plan.world_size, start_method="spawn")
        except mp.ProcessExitedException as err:  # e.g. a rank's watchdog (42)
            raise SystemExit(err.exit_code)
    elif args.multihost:
        mesh.make_mesh(plan.init_method, plan.rank, plan.world_size,
                       _rank_device(args, plan.local_index))
        try:
            train(args, args.out_folder)
        finally:
            mesh.destroy()
    else:
        train(args, args.out_folder)


if __name__ == "__main__":
    main()
