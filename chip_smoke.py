"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure ends the run with a non-zero
exit code:

  device   the card's name and power limit;
  build    compiles the CUDA kernels from coulombgas_tpu_torch/csrc with nvcc
           (all sources in parallel);
  kernels  each hand-written kernel against its plain PyTorch version at the
           main path's shapes (n = 29, dim = 2, depth 2, widths 16,
           batch 2048): error in f32 and against f64, a singular input, a
           ragged batch, and timings; the flow kernels (carried state K1,
           depth-2 closure K5, depth-2 carried form K4) also against each
           other; K4 also at n = 57, batch 512, on the trained weights and
           walkers of the checked-in n = 57 checkpoint, timed back to back
           in turns with K1 and K5 at both shapes, one call of it profiled
           (one kernel launch), with the carried-state kernel timed beside
           it there, the depth-2
           closure kernels there too (against both plain versions, K5 also
           against the carried-state kernel, the three timed in turns), and
           the fused tail on the carried-state kernel's (u, J) there; the
           fused tail also with one zero column of J at a panel's first,
           middle and last column; the depth-2 closure kernels' refusals of
           n 65 and a width of 48; the batched Cholesky log-det with its
           launch plans and their blocks an SM, against plain f32 and f64 at
           every shape it runs (m 171, 114, 58 at batches 2048 and 4096, 26)
           and at the largest m it takes, on singular inputs (a zero row and
           column at a panel's first, middle and last column, the zero
           matrix), on batches of 1 and 3, a ragged one and every other plan
           (bit for bit), and beside torch.linalg.cholesky at those shapes;
  train    two Adam epochs through main_torch.py's own functions at the
           default width, with the launch counters read around them, then one
           sample step on the route that uses the third kernel;
  sample_graph the sample step replayed as one CUDA graph against the same
           step run eagerly, from one generator state: states, walkers,
           accept rates, the generator's state and the launch counters (a
           replay's read from the graph's kernel nodes) bit for bit, also
           after a set_state between replays and on the --mc_d2_kernel
           route; --slow_logp left eager; torch.multinomial's checks as
           device flags; the memory a captured step keeps allocated and
           reserves in its pool, none allocated by a replay;
           ``python3 chip_smoke.py --sample_graph_only`` runs this phase
           alone;
  accumulate_graph the SR accumulate's graph part (observables, Hutchinson
           Laplacian, scores) replayed as one CUDA graph against the eager
           piece on the n 29 and n 57 SR lines: accumulators, generator state
           and launch counters bit for bit with the probe handed in and
           drawn, the graph's kernel nodes against the eager part's kernels,
           the memory it keeps; two gloo ranks on one chunk against one
           process; ``python3 chip_smoke.py --accumulate_graph_only`` runs
           this phase alone;
  train_default main.py's default command line (no --hutchinson: the exact
           Laplacian of log|det J|) for two Adam epochs at the same width,
           with its launch counters, seconds by phase and peak memory;
  engines  on 64 of those walkers, every exact engine (the analytic one in
           batched passes and column by column, the generic-AD one of
           --laplacian ad both ways, and the analytic one without an analytic
           flow Jacobian, as --slow_logp runs it) in f64 and in f32 against
           the analytic batched engine in f64; then one epoch at batch 256 of
           each of --laplacian ad, --laplacian ad --hutchinson, --slow_logp,
           --forloop_laplacian, --sr --sr_solver host64 --mc_d2_kernel
           --acc_d2_kernel (exact) and --sr --slow_logp, each with its
           launch counters;
  train_sr three epochs of stochastic reconfiguration (--sr --sr_solver host64
           --mc_d2_kernel --acc_d2_kernel) at the same width, counters set to
           zero before and read after, then the plain solver's step on the
           same accumulators beside host64's;
  train_n57 the production configuration (n = 57, rs 1.0, Emax 49, batch
           512, --sr --sr_solver host64 --tripwire_sigma 6) resumed from a
           copy of the checked-in epoch-100 checkpoint for 2 epochs (acc_steps
           cut from 16 to 2; no width is cut), then one sample step on the
           depth-2 carried-form kernel K4 (use_large_flow) with its counters, and
           its logp against the default route's on the same walkers;
  routes   the Metropolis logp past the kernels' size limits, left to
           choose its route: n = 65 (beyond the flow kernel: the analytic
           Jacobian into the fused tail) and n = 57 at dim 3 (nd 171, beyond
           the fused tail: the stacked Grams through chol_logdet), each with
           Metropolis sweeps, its launch counters, and logp against plain f64;
  pretrain 20 epochs of the free-fermion pretraining (n = 13, Emax 25,
           batch 8192, SR as main_torch.py runs it) with F beside the exact
           mpmath value;
  dist     data parallelism over torch.distributed, in subprocesses of
           main_torch.py on main.py's --sr --hutchinson line at the default
           width (n 29, batch 2048), 2 epochs, acc_steps 1, mc_therm 2:
           (a) a process group of world size 1 under NCCL, whose data.txt
           rows and checksum must equal the same run's without a group, bit
           for bit; (b) two ranks (NCCL on two cards, or gloo for two ranks
           on the one card, which NCCL refuses), with finite rows and equal
           checksums on both ranks; (d) where the machine has four cards,
           four NCCL ranks with --microbatch 1024 (chunks of two ranks:
           sub-groups), finite rows and four equal checksums; (c) one Adam
           accumulate and apply on one shared global batch in f32 (the
           walkers of (a)'s checkpoint) in two ranks against one process:
           observables, reduced accumulators and parameters within the
           tolerances below; (e) a microbatch chunk straddling the ranks'
           shares (--batch 1536 --microbatch 512: shares of 768, chunk 1
           across both), two ranks as (b) with finite rows and equal
           checksums, and (c)'s step with that batch and microbatch against
           one process; (f) two ranks of --multihost with no --coordinator,
           the layout read from a SLURM job's environment: (b)'s rows and
           checksum, bit for bit; the backend, world size and seconds by
           phase.  ``python3 chip_smoke.py --dist_only`` runs this phase
           alone.

The line before the last lists every kernel with its launches on the main
path, its error, its time and its bound; K1, K5 and K6 also with the time
of calls run back to back (``ms_b2b``), which leaves out their wrappers' host
work.  The last line is
{"ok": true, "device": {...}}.  Needs a CUDA device; exits non-zero without.
"""

from __future__ import annotations

import difflib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")

from coulombgas_tpu_torch.models.ferminet import FermiNet, FermiNetConfig, init_ferminet_params
from coulombgas_tpu_torch.io.checkpoint import load_data
from coulombgas_tpu_torch.io.convert import flow_from_numpy, ravel_params, van_from_numpy
from coulombgas_tpu_torch.ops import (
    _build, counters, cuda_flow_d2, cuda_flow_jac, cuda_flow_large, cuda_fused_logp, cuda_logdet,
)
from coulombgas_tpu_torch.ops.logdet import planewave_gram_embed
from coulombgas_tpu_torch.physics.orbitals import sp_orbitals, twist_sort
from coulombgas_tpu_torch.sampling.mcmc import mcmc
from coulombgas_tpu_torch.wavefunction.fast_logp import make_logp_fast

DEV = torch.device("cuda")

# Published peaks of one H100 SXM: device memory rate and f32 rate outside the
# tensor cores.  The bound of a kernel is the larger of bytes / rate and
# operations / rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# Main-path shapes.
N, DIM, DEPTH, SPSIZE, TPSIZE, EMAX, BATCH = 29, 2, 2, 16, 16, 25, 2048
K3_BATCH = 2 * BATCH
# The production configuration of the depth-2 carried-form kernel K4, and its checked-in
# checkpoint (trained weights and thermalised walkers).
N57, EMAX57, BATCH57 = 57, 49, 512
N57_FOLDER = os.path.join("data", "interacting_n57_goodseed")
N57_RUN = ("n_57_dim_2_rs_1.0_Theta_0.15_Emax_49_twist_0.250_0.250_nlayers_2_modelsize_16_"
           "nheads_4_nhidden_32_depth_2_spsize_16_tpsize_16_Gmax_15_kappa_10_mctherm_10_"
           "mcsteps_50_mcstddev_0.10_hutchinson_damping_0.00100_maxnorm_0.00100_batch_512_"
           "ndevices_1_accsteps_16")

# Tolerances.  u and J: the kernel and the plain version do the same f32
# arithmetic in another order, entries are O(1) (u up to L ~ 10).  logp: a
# log-determinant of a 58 x 58 f32 Gram matrix, whose conditioning squares
# that of J and D; 5e-3 is the reference tests' own bound for the same sizes.
TOL_UJ = 1e-5
TOL_U = 2e-5  # u carries x (up to L ~ 9.5, f32 ulp 1e-6) plus the flow's sum
TOL_LOGP = 5e-3  # held by the 99th percentile over the batch
# The largest error over 2048 walkers belongs to the worst-conditioned one:
# cond(D) reaches a few hundred on thermalised walkers, the Gram form squares
# it, and eps_f32 * cond^2 ~ 1e-2 — the plain f32 version strays from f64 by
# as much.  So the maximum gets ten times the percentile's tolerance.
TOL_LOGP_MAX = 5e-2
# The flow's coordinate Laplacian sums nd second derivatives per entry, some
# with 1 / d^3 of a pair distance; values are below 1.  J's tolerance, twenty
# times tighter than the bound the reference's own tests give its TPU kernel
# in interpret mode (2e-4).
TOL_LAP = 1e-5
# The exact engines against the analytic batched engine in f64, each error
# taken relative to the largest |value| over the walkers.  f64: the same sums
# in another order, 1e-8.  f32: the Slater part inverts D by LU
# in f32, 1.2e-7 times cond(D) (a few hundred on thermalised n = 29 walkers)
# is 1e-5 to 1e-4 of each walker's Hessian terms, which the Laplacian sums
# with some cancellation; ten times that.
TOL_ENGINE_F64 = 1e-8
TOL_ENGINE_F32 = 1e-3
# Two ranks against one process on the same global batch in f32: every
# per-walker value is the same arithmetic, only the batch means are summed
# in another order.  Observables: a mean of 2048 f32 numbers, relative
# error a few times 1e-7; 1e-5.  Accumulators (gradients, scores), relative
# in the norm of each module's whole vector: the means cancel (the scores
# average to about zero), which costs up to the ratio of the summed
# magnitudes to the sum; 1e-4.  (A tensor whose exact mean is zero, as the
# score of a direction the model is blind to, is rounding noise in both
# runs; it is reported, not held.)  Parameters after one Adam step of
# lr 1e-3: the first step is lr g / (|g| + 1e-8), the sign of g wherever
# |g| is above 1e-8, so it is held where the gradient (after the baseline)
# is determined to 1 % between the two runs, and moves there by at most lr
# times 1e-2 times 1e-8 / |g| -- below 1e-6.  Where it is not determined
# the step takes the sign of rounding noise in either run.  Those entries
# are counted and held to 2 % of all (about 1 % measured), so that a two-rank
# gradient wrong everywhere cannot pass by leaving nothing to hold.
TOL_DIST_OBS = 1e-5
TOL_DIST_ACC = 1e-4
TOL_DIST_PARAM = 1e-6
TOL_DIST_UNDETERMINED = 0.02


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median time of ``fn()`` on the device in milliseconds (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_ms_b2b(fn, reps: int = 20, warmup: int = 2) -> float:
    """Time of one ``fn()`` on the device in milliseconds when ``reps`` calls
    run back to back between two CUDA events: the host's work for the next
    call overlaps the device's for this one, so a kernel longer than its
    wrapper's host work is timed without that work (``time_ms`` times one
    call alone, with it)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(a, b) -> float:
    return float((a.detach().double() - b.detach().double()).abs().max())


def p99_err(a, b) -> float:
    return float((a.detach().double() - b.detach().double()).abs().quantile(0.99))


def check(cond: bool, what: str):
    if not cond:
        raise SystemExit("chip_smoke: FAILED: " + what)


# ---------------------------------------------------------------------------


def phase_device():
    line = smi_line()
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": line,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return line


def phase_build():
    t0 = time.time()
    logs = _build.build_all(force=True)
    for name in _build.KERNEL_SOURCES:  # load now so that a bad library fails here
        _build.load_library(name)
    ptxas = {name: ptxas_lines(log) for name, log in logs.items()}
    # the depth-2 closure kernels' dynamic shared memory, K5 and K6
    big = FermiNetConfig(DEPTH, SPSIZE, TPSIZE, 1.0)
    smem = {"%s_n%d" % (k, n): cuda_flow_d2.flow_d2_smem_bytes(n, DIM, big, k == "K6")
            for k in ("K5", "K6") for n in (N, N57)}
    # K4's registers and spills, one line per instantiation
    k4 = [ln for ln in ptxas.get("flow_large", []) if "cg_flow_large_kernel" in ln]
    check(len(k4) > 0, "build: no ptxas line for K4's kernel")
    emit({"phase": "build", "seconds": round(time.time() - t0, 2),
          "sources": ["coulombgas_tpu_torch/csrc/%s.cu" % s for s in _build.KERNEL_SOURCES],
          "ptxas": ptxas, "ptxas_K4": k4, "flow_d2_smem_bytes": smem})


def ptxas_lines(log: str) -> list:
    """One line per compiled kernel from ``nvcc -Xptxas -v``: its entry
    function, then its stack, spills, registers and static shared memory."""
    out = []
    for ln in log.splitlines():
        ln = ln.strip()
        if "Compiling entry function" in ln:
            out.append(ln.split("'")[1])
        elif out and ("spill" in ln or "registers" in ln):
            out[-1] += " | " + ln.replace("ptxas info    : ", "")
    return out


def make_inputs(seed: int = 0):
    """Flow, walkers and momenta at the main path's shapes, from a numpy seed."""
    rng = np.random.default_rng(seed)
    L = math.sqrt(math.pi * N)
    cfg = FermiNetConfig(DEPTH, SPSIZE, TPSIZE, L)
    flow = init_ferminet_params(cfg, DIM, torch.Generator().manual_seed(seed),
                                torch.float32, "cpu")
    with torch.no_grad():  # weights large enough that J is far from I
        for lin in [*flow.sp, *flow.tp, flow.final]:
            lin.w.copy_(torch.from_numpy(rng.normal(0, 0.1, lin.w.shape).astype(np.float32)))
            lin.b.copy_(torch.from_numpy(rng.normal(0, 0.1, lin.b.shape).astype(np.float32)))
    flow = flow.to(DEV)
    x = torch.from_numpy(rng.uniform(0, L, (BATCH, N, DIM)).astype(np.float32)).to(DEV)
    idx, _ = sp_orbitals(DIM, EMAX)
    tw, _ = twist_sort(idx, [0.25, 0.25])
    tw = tw[::-1].copy()
    si = np.stack([np.sort(rng.choice(len(tw), N, replace=False)) for _ in range(BATCH)])
    si = torch.from_numpy(si).to(DEV)
    kvec = (2 * math.pi / L * torch.from_numpy(tw).to(DEV, torch.float32))[si]
    # Uniform points include walkers near a node of the wavefunction, where
    # D is singular to f32 and the comparison says nothing about a kernel:
    # thermalise with one sample step's worth of Metropolis sweeps, as the
    # main path does before it evaluates anything.
    logp = make_logp_fast(tw, L)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    x, _ = mcmc(lambda q: logp(q, flow, si), x, gen, 50, 0.1)
    return L, cfg, flow, x.contiguous(), kvec, tw, si


def flow_flops(B, n, dim, depth, S, T):
    C0 = 2 * dim + 1
    fl, S_in, Cin = 0, dim, C0
    for k in range(depth):
        fl += 2 * n * (2 * S_in + Cin) * S            # sp layer
        fl += 2 * n * n * dim * (S_in + Cin) * S      # Jsp W1 and A W3
        if k < depth - 1:
            fl += 2 * n * n * Cin * T * (1 + dim)     # tp layer and its derivative
            Cin = T
        S_in = S
    fl += 2 * n * S * dim + 2 * n * n * dim * S * dim  # final layer, J
    return B * fl


def d2_flops(B, n, dim, S, T, lap: bool):
    """f32 operations of the depth-2 closure as the function needs them (the
    pair blocks A0 have 3 non-zero entries per coordinate), and beside them
    the transcendental calls (sincos, exp, log1p, sqrt, division by a sum),
    which the multiply-add count leaves out."""
    C0 = 2 * dim + 1
    pair = n * n
    fl = pair * (2 * C0 * T + dim * (6 * T + T))          # tp layer: pre, A0 wt, A1
    fl += pair * (C0 + 3 * dim + T + dim * T)             # sums over j
    fl += n * (2 * C0 * S + dim * 7 * S)                  # layer 0, D
    fl += n * 2 * (2 * S + T) * S + 2 * n * S * dim       # final layer, u
    fl += n * dim * 2 * S * (2 * S + T + C0) + n * dim * dim * 2 * (S + T)  # M R N K, diagonal
    fl += pair * dim * S * 8                              # G
    fl += pair * dim * dim * 2 * (3 + T + S)              # J blocks
    trans = pair * (2 * dim + 1 + 3 * T)                  # sincos, sqrt; exp, log1p, 1/(1+e)
    trans += n * 5 * S
    if lap:
        fl += pair * (dim * S * 8 + T * (2 * C0 + 6))     # sq0 pair part, Ltp1
        fl += pair * dim * S * (6 + 2 * T + 4)            # U and the squared sums
        fl += n * dim * 2 * S * (2 * S + T) + n * 2 * (2 * S + T) * S + 2 * n * S * dim
        trans += pair * dim
    return B * fl, B * trans


def large_flops(B, n, dim, S, T):
    """f32 operations of K4's depth-2 flow in its carried form as the function needs
    them (A0 has 3 non-zero entries per coordinate; AW, A1 and tp1 are each
    counted once, however often the kernels rebuild them), and the
    transcendental calls beside them."""
    C0 = 2 * dim + 1
    pair = n * n
    fl = pair * (C0 + dim * S * 9) + n * 2 * C0 * S       # layer 0: mean tp0, AW, sum_j, Jsp1
    fl += pair * dim * S                                  # jmean
    fl += pair * (2 * C0 * T + dim * T * 8 + T)           # pre_tp, A1, sums over j
    fl += n * dim * 2 * T * S + n * 2 * (2 * S + T) * S + n * dim * 2 * S * S  # sum AW1, pre, jmean W1b
    fl += pair * dim * S * (2 * S + 2 * T + 4)            # Jsp1 W1a, A1 W1c, assembly
    fl += pair * dim * dim * 2 * S + 2 * n * S * dim      # J, u
    trans = pair * (2 * dim + 1) + pair * 3 * T + n * 6 * S  # sincos, sqrt; exp, log1p, 1/(1+e)
    return B * fl, B * trans


def fused_bound(B, n, dim):
    """K2's least time in ms by bytes and by operations.  Lower triangles
    only: both Grams are symmetric / Hermitian (a complex multiply-add is 8
    flops), and a Cholesky elimination costs m^3 / 3."""
    nd = n * dim
    nbytes = 4 * B * (nd * nd + 2 * n * dim + 1)
    flops = B * (nd**3 + 4 * n**3 + nd**3 / 3 + 4 * n**3 / 3 + 2 * n * n * dim)
    return nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3


def n57_kvec(seed: int = 0):
    """Momenta for the n = 57 checkpoint's walkers: orbital states drawn by
    the checkpoint's trained VAN, as the sample step draws them (generator
    seeded with ``seed``)."""
    from coulombgas_tpu_torch.io.convert import van_from_numpy
    from coulombgas_tpu_torch.models.transformer import TransformerConfig, init_transformer_params
    from coulombgas_tpu_torch.sampling.autoregressive import make_autoregressive_sampler

    ckpt = load_data(os.path.join(N57_FOLDER, N57_RUN, "epoch_000100.pkl"))
    L = math.sqrt(math.pi * N57)
    idx, Es = sp_orbitals(DIM, EMAX57)
    tw, _ = twist_sort(idx, [0.25, 0.25])
    tw = tw[::-1].copy()  # the trainer's order: highest energy first
    van = init_transformer_params(TransformerConfig(Es.size, 2, 16, 4, 32), DIM,
                                  torch.Generator().manual_seed(seed), torch.float32, DEV)
    van_from_numpy(ckpt["params_van"], van)
    sampler, _ = make_autoregressive_sampler(tw, N57, Es.size)
    si = sampler(van, torch.Generator(DEV).manual_seed(seed), BATCH57)
    return (2 * math.pi / L * torch.from_numpy(tw).to(DEV, torch.float32))[si].contiguous()


def fused_n57():
    """K2 at n = 57, batch 512, on the carried-state kernel's (u, J) of the
    checkpoint's trained weights and walkers, with the momenta of states its
    VAN draws."""
    L57, flow57, x57 = load_n57()
    kvec = n57_kvec()
    with torch.no_grad():
        u, J = cuda_flow_jac.flow_u_jac_cuda(flow57, x57)
    lp = cuda_fused_logp.fused_logp_cuda(u, kvec, J, L57)
    torch.cuda.synchronize()
    lp32 = cuda_fused_logp.fused_logp_plain(u, kvec, J, L57)
    lp64 = cuda_fused_logp.fused_logp_plain(u.double(), kvec.double(), J.double(), L57)
    e = {"max_abs_err": max_err(lp, lp32), "max_abs_err_f64": max_err(lp, lp64),
         "p99_abs_err": p99_err(lp, lp32), "p99_abs_err_f64": p99_err(lp, lp64),
         "plain_f32_vs_f64_max": max_err(lp32, lp64), "plain_f32_vs_f64_p99": p99_err(lp32, lp64)}
    # Held against f64 at the n = 29 tolerances.  H = D^H D is far worse
    # conditioned here (cond ~4e5): the plain f32 version is itself about
    # 4e-3 from f64 at the 99th percentile (CPU check), so the comparison with
    # it is reported and not gated.
    check(bool(torch.isfinite(lp).all()) and e["max_abs_err_f64"] <= TOL_LOGP_MAX
          and e["p99_abs_err_f64"] <= TOL_LOGP, "fused_logp at n = 57 vs plain f64: %s" % e)
    ms = time_ms(lambda: cuda_fused_logp.fused_logp_cuda(u, kvec, J, L57), 20)
    t_b, t_o = fused_bound(BATCH57, N57, DIM)
    return {"ms_n57_b512": ms, "bound_ms_n57_b512": max(t_b, t_o),
            "bound_by_n57_b512": "bytes" if t_b >= t_o else "operations",
            "errors_n57_b512": e, "smem_bytes_n57": cuda_fused_logp.fused_smem_bytes(N57, DIM)}


def load_n57():
    """The trained flow (f32, on the card) and the 512 walkers of the
    checked-in n = 57 epoch-100 checkpoint."""
    ckpt = load_data(os.path.join(N57_FOLDER, N57_RUN, "epoch_000100.pkl"))
    L = math.sqrt(math.pi * N57)
    flow = FermiNet(FermiNetConfig(DEPTH, SPSIZE, TPSIZE, L), DIM, torch.float32, DEV)
    flow_from_numpy(ckpt["params_flow"], flow)
    x = torch.as_tensor(np.asarray(ckpt["x"], np.float32), device=DEV).contiguous()
    check(tuple(x.shape) == (BATCH57, N57, DIM), "n = 57 checkpoint walkers %s" % (tuple(x.shape),))
    return L, flow, x


def k4_device_kernels(cases):
    """The CUDA kernels that one K4 call on each ``(flow, x)`` of ``cases``
    launches, by name and count, from ``torch.profiler``'s device events.
    One profiling session for all of them: with torch 2.11 on an H100 a
    second session in the same process recorded no device events."""
    from coulombgas_tpu_torch.utils.profiling import trace

    torch.cuda.synchronize()
    with torch.no_grad(), trace(None, "cuda") as prof:
        for flow, x in cases:
            cuda_flow_large.flow_u_jac_large_cuda(flow, x)
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def kernels_large(flow29, x29, u1, J1):
    """K4 at the n = 57 production shape (trained weights, thermalised
    walkers) and at the main path's n = 29 shape; ``u1, J1`` are the
    carried-state kernel's results on ``x29``.  At both shapes K4 is timed
    back to back in turns with K1 and K5 on the same walkers (K1, K5, K4,
    K4, K5, K1), and one call is profiled: it must be one kernel launch."""
    lg = cuda_flow_large
    L57, flow57, x57 = load_n57()
    errs, turns = {}, {}
    for tag, flow, x, ref1 in (("n57", flow57, x57, None), ("n29", flow29, x29, (u1, J1))):
        flow64 = init_ferminet_params(flow.cfg, DIM, None, torch.float64, DEV)
        flow64.load_state_dict({k: v.double() for k, v in flow.state_dict().items()})
        u, J = lg.flow_u_jac_large_cuda(flow, x)
        torch.cuda.synchronize()
        with torch.no_grad():
            u32, J32 = lg.flow_u_jac_large_ref(flow, x)
            u64, J64 = lg.flow_u_jac_large_ref(flow64, x.double())
            if ref1 is None:
                ref1 = cuda_flow_jac.flow_u_jac_cuda(flow, x)
        e = {"f32": (max_err(u, u32), max_err(J, J32)), "f64": (max_err(u, u64), max_err(J, J64)),
             "flow_u_jac": (max_err(u, ref1[0]), max_err(J, ref1[1]))}
        for ref, (eu, eJ) in e.items():
            check(eu <= TOL_U and eJ <= TOL_UJ,
                  "flow_u_jac_large (%s) vs %s: u %g J %g" % (tag, ref, eu, eJ))
        # a ragged batch reproduces the full batch bit for bit
        ur, Jr = lg.flow_u_jac_large_cuda(flow, x[:-1])
        check(torch.equal(ur, u[:-1]) and torch.equal(Jr, J[:-1]),
              "flow_u_jac_large (%s): ragged batch differs" % tag)
        errs[tag] = e
        fns = {"flow_u_jac": cuda_flow_jac.flow_u_jac_cuda,
               "flow_u_jac_d2": cuda_flow_d2.flow_u_jac_d2_cuda,
               "flow_u_jac_large": lg.flow_u_jac_large_cuda}
        t = {k: [] for name in fns for k in (name, name + "_b2b")}
        with torch.no_grad():
            for name in ("flow_u_jac", "flow_u_jac_d2", "flow_u_jac_large", "flow_u_jac_large",
                         "flow_u_jac_d2", "flow_u_jac"):
                t[name].append(time_ms(lambda: fns[name](flow, x), 20))
                t[name + "_b2b"].append(time_ms_b2b(lambda: fns[name](flow, x), 20))
            if tag == "n57":
                plain_ms = time_ms(lambda: lg.flow_u_jac_large_ref(flow, x), 5)
        turns[tag] = {k: statistics.mean(v) for k, v in t.items()}
        turns[tag]["turns"] = t
    # one call is one launch of K4's kernel and nothing else on the card:
    # a call at each shape, two launches (one instantiation each)
    device_kernels = k4_device_kernels([(flow57, x57), (flow29, x29)])
    check(sum(device_kernels.values()) == 2
          and all("cg_flow_large_kernel" in k for k in device_kernels),
          "flow_u_jac_large: a call at n 57 and one at n 29 launched %s" % device_kernels)
    # dim 3, uneven widths, coincident particles
    for dim, S, T, n, B in [(3, 16, 16, 8, 65), (2, 8, 12, 13, 33)]:
        Lg = float(n) ** (1 / dim)
        fg = init_ferminet_params(FermiNetConfig(2, S, T, Lg, 0.2), dim,
                                  torch.Generator().manual_seed(n), torch.float32, DEV)
        xg = Lg * torch.rand(B, n, dim, device=DEV, generator=torch.Generator(DEV).manual_seed(n))
        xg[:, 1] = xg[:, 0]
        got = lg.flow_u_jac_large_cuda(fg, xg)
        with torch.no_grad():
            ref = lg.flow_u_jac_large_ref(fg, xg)
        e = [max_err(a, b) for a, b in zip(got, ref)]
        check(all(bool(torch.isfinite(a).all()) for a in got) and e[0] <= TOL_U and e[1] <= TOL_UJ,
              "flow_u_jac_large (n %d, dim %d, widths %d/%d) vs plain: %s" % (n, dim, S, T, e))
    # the budget, as the built library states it: n <= 64 (two pairs a lane)
    check(lg.flow_large_fits(N57, DIM, SPSIZE, TPSIZE) and lg.flow_large_fits(N, DIM, SPSIZE, TPSIZE)
          and lg.flow_large_fits(64, DIM, SPSIZE, TPSIZE)
          and lg.flow_large_smem_bytes(N57, DIM, SPSIZE, TPSIZE)
          > lg.flow_large_smem_bytes(N, DIM, SPSIZE, TPSIZE)
          and not lg.flow_large_fits(65, DIM, SPSIZE, TPSIZE)
          and not lg.flow_large_fits(2000, DIM, SPSIZE, TPSIZE)
          and not lg.flow_large_fits(N, 4, SPSIZE, TPSIZE),
          "flow_u_jac_large: size budget")
    try:  # a requested kernel launches or raises: depth 3 is refused
        lg.flow_u_jac_large_cuda(init_ferminet_params(
            FermiNetConfig(3, SPSIZE, TPSIZE, L57), DIM, None, torch.float32, DEV), x57[:4])
        check(False, "flow_u_jac_large accepted a depth-3 flow")
    except ValueError:
        pass
    nparams = cuda_flow_jac.pack_flow_params(flow57).numel()
    nd = N57 * DIM
    nbytes = 4 * (2 * BATCH57 * nd + BATCH57 * nd * nd + nparams)
    flops, trans = large_flops(BATCH57, N57, DIM, SPSIZE, TPSIZE)
    t_b, t_o = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    flops29, _ = large_flops(BATCH, N, DIM, SPSIZE, TPSIZE)
    return {
        "name": "flow_u_jac_large", "route": "cuda",
        "source": "coulombgas_tpu_torch/csrc/flow_large.cu",
        "replaces": "coulombgas_tpu/ops/pallas_flow_jac.py:403",
        "replaces_also": "coulombgas_tpu/ops/pallas_flow_jac.py:445",
        "shape": {"n": N57, "batch": BATCH57, "dim": DIM, "weights": "checkpoint epoch 100"},
        "max_abs_err": max(errs["n57"]["f32"]), "max_abs_err_f64": max(errs["n57"]["f64"]),
        "abs_err_vs_flow_u_jac": max(errs["n57"]["flow_u_jac"]),
        "errors_u_J": errs,  # u reaches L = 13.4 at n 57: its f32 ulp is 1e-6
        "tolerance": TOL_U, "ms": turns["n57"]["flow_u_jac_large"], "plain_ms": plain_ms,
        "ms_b2b": turns["n57"]["flow_u_jac_large_b2b"],
        "bound_ms": max(t_b, t_o), "bound_by": "bytes" if t_b >= t_o else "operations",
        "library_ms": None, "f32_operations": flops, "transcendentals": trans, "bytes": nbytes,
        "flow_u_jac_ms_same_shape": turns["n57"]["flow_u_jac"],
        "ms_n29_b2048": turns["n29"]["flow_u_jac_large"],
        "ms_b2b_n29_b2048": turns["n29"]["flow_u_jac_large_b2b"],
        "bound_ms_n29_b2048": flops29 / PEAK_F32_FLOPS * 1e3,
        "with_K1_K5_mean_and_turns": turns, "device_kernels_of_two_calls": device_kernels,
        "smem_bytes": {"n57": lg.flow_large_smem_bytes(N57, DIM, SPSIZE, TPSIZE),
                       "n29": lg.flow_large_smem_bytes(N, DIM, SPSIZE, TPSIZE)},
    }


def kernels_d2(L, cfg, flow, flow64, x, u1, J1):
    """K5 and K6 at the main path's shapes; ``u1, J1`` are the carried-state
    flow kernel's results on the same walkers."""
    nd = N * DIM
    d2 = cuda_flow_d2
    u, J = d2.flow_u_jac_d2_cuda(flow, x)
    ul, Jl, lap = d2.flow_u_jac_lap_d2_cuda(flow, x)
    torch.cuda.synchronize()
    with torch.no_grad():
        u32, J32, lap32 = d2.flow_u_jac_lap_d2_plain(flow, x)
        u64, J64, lap64 = d2.flow_u_jac_lap_d2_plain(flow64, x.double())
    errs = {}
    for name, got in (("flow_u_jac_d2", (u, J)), ("flow_u_jac_lap_d2", (ul, Jl, lap))):
        e32 = [max_err(a, b) for a, b in zip(got, (u32, J32, lap32))]
        e64 = [max_err(a, b) for a, b in zip(got, (u64, J64, lap64))]
        for e, ref in ((e32, "f32"), (e64, "f64")):
            check(e[0] <= TOL_U and e[1] <= TOL_UJ and (len(e) < 3 or e[2] <= TOL_LAP),
                  "%s vs plain %s: u, J, lap %s" % (name, ref, e))
        errs[name] = (e32, e64)
    # the closure equals the carried form to roundoff: two hand-written kernels
    e_k1 = (max_err(u, u1), max_err(J, J1))
    check(e_k1[0] <= TOL_U and e_k1[1] <= TOL_UJ,
          "flow_u_jac_d2 vs flow_u_jac (carried state): u %g J %g" % e_k1)
    # coincident particles: zero pair distance, the guarded 1 / d and 1 / d^3
    xs = x[:64].clone()
    xs[:, 1] = xs[:, 0]
    got = d2.flow_u_jac_lap_d2_cuda(flow, xs)
    got5 = d2.flow_u_jac_d2_cuda(flow, xs)
    with torch.no_grad():
        ref = d2.flow_u_jac_lap_d2_plain(flow, xs)
    check(all(bool(torch.isfinite(t).all()) for t in got + got5),
          "flow d2 kernels: non-finite output for coincident particles")
    e_co = [max_err(a, b) for a, b in zip(got, ref)] + [max_err(a, b) for a, b in zip(got5, ref)]
    check(e_co[0] <= TOL_U and e_co[1] <= TOL_UJ and e_co[2] <= TOL_LAP
          and e_co[3] <= TOL_U and e_co[4] <= TOL_UJ,
          "flow d2 kernels, coincident particles vs plain: %s" % e_co)
    # a ragged batch reproduces the full batch bit for bit
    ur, Jr = d2.flow_u_jac_d2_cuda(flow, x[:BATCH - 1])
    ulr, Jlr, lapr = d2.flow_u_jac_lap_d2_cuda(flow, x[:BATCH - 1])
    check(torch.equal(ur, u[:-1]) and torch.equal(Jr, J[:-1]), "flow_u_jac_d2: ragged batch differs")
    check(torch.equal(ulr, ul[:-1]) and torch.equal(Jlr, Jl[:-1]) and torch.equal(lapr, lap[:-1]),
          "flow_u_jac_lap_d2: ragged batch differs")
    # other sizes: n = 57 (beyond the carried-state kernel's single-kernel
    # range on the TPU), dim 3, uneven widths
    for dim, S, T, n, B in [(2, 16, 16, 57, 256), (3, 16, 16, 9, 65), (2, 8, 12, 13, 65),
                            (3, 8, 12, 7, 33)]:
        Lg = float(n) ** (1 / dim)
        cg = FermiNetConfig(2, S, T, Lg, 0.2)
        fg = init_ferminet_params(cg, dim, torch.Generator().manual_seed(n), torch.float32, DEV)
        xg = Lg * torch.rand(B, n, dim, device=DEV, generator=torch.Generator(DEV).manual_seed(n))
        got = d2.flow_u_jac_lap_d2_cuda(fg, xg)
        got5 = d2.flow_u_jac_d2_cuda(fg, xg)
        with torch.no_grad():
            ref = d2.flow_u_jac_lap_d2_plain(fg, xg)
        e = [max_err(a, b) for a, b in zip(got, ref)] + [max_err(a, b) for a, b in zip(got5, ref)]
        check(e[0] <= TOL_U and e[1] <= TOL_UJ and e[2] <= TOL_LAP and e[3] <= TOL_U
              and e[4] <= TOL_UJ,
              "flow d2 kernels (n %d, dim %d, widths %d/%d) vs plain: %s" % (n, dim, S, T, e))
    # the shared-memory budget, as the built library states it: O(n S) for
    # both kernels, K6 at n 57 under 64 KB
    big = FermiNetConfig(DEPTH, SPSIZE, TPSIZE, L)
    check(all(d2.flow_d2_fits(n, DIM, big, lap) for n in (N, 57) for lap in (False, True))
          and 64 * 1024 > d2.flow_d2_smem_bytes(57, DIM, big, True)
          > d2.flow_d2_smem_bytes(57, DIM, big) > d2.flow_d2_smem_bytes(N, DIM, big)
          and not any(d2.flow_d2_fits(n, dim, big, lap) for n, dim in ((65, DIM), (100, DIM), (N, 4))
                      for lap in (False, True))
          and not d2.flow_d2_fits(N, DIM, FermiNetConfig(3, SPSIZE, TPSIZE, L)),
          "flow d2 kernels: shared-memory budget")
    # K6 refuses what it does not take: a width of 48, n = 65
    for what, cg, n_r in (("width 48", FermiNetConfig(DEPTH, 48, TPSIZE, L), N),
                          ("n 65", big, 65)):
        fr = init_ferminet_params(cg, DIM, None, torch.float32, DEV)
        try:
            d2.flow_u_jac_lap_d2_cuda(fr, L * torch.rand(4, n_r, DIM, device=DEV))
            check(False, "flow_u_jac_lap_d2 accepted %s" % what)
        except ValueError:
            pass
    try:  # a requested kernel launches or raises: depth 3 is refused
        d2.flow_u_jac_d2_cuda(init_ferminet_params(
            FermiNetConfig(3, SPSIZE, TPSIZE, L), DIM, None, torch.float32, DEV), x[:4])
        check(False, "flow_u_jac_d2 accepted a depth-3 flow")
    except ValueError:
        pass
    n57 = kernel_d2_n57()
    rows = []
    nparams = cuda_flow_jac.pack_flow_params(flow).numel()
    for name, fn, plain, lap_on, line in (
        ("flow_u_jac_d2", d2.flow_u_jac_d2_cuda, d2.flow_u_jac_d2_plain, False, 1033),
        ("flow_u_jac_lap_d2", d2.flow_u_jac_lap_d2_cuda, d2.flow_u_jac_lap_d2_plain, True, 1237),
    ):
        with torch.no_grad():
            ms = time_ms(lambda: fn(flow, x), 20)
            ms_b2b = time_ms_b2b(lambda: fn(flow, x), 20)
            plain_ms = time_ms(lambda: plain(flow, x), 5)
        nbytes = 4 * (2 * BATCH * nd + BATCH * nd * nd + nparams + (BATCH * nd if lap_on else 0))
        flops, trans = d2_flops(BATCH, N, DIM, SPSIZE, TPSIZE, lap_on)
        t_b, t_o = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
        e32, e64 = errs[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": "coulombgas_tpu_torch/csrc/flow_d2.cu",
            "replaces": "coulombgas_tpu/ops/pallas_flow_jac.py:%d" % line,
            "max_abs_err": max(e32[:2]), "max_abs_err_f64": max(e64[:2]),
            "tolerance": TOL_U, "ms": ms, "ms_b2b": ms_b2b, "plain_ms": plain_ms,
            "bound_ms": max(t_b, t_o), "bound_by": "bytes" if t_b >= t_o else "operations",
            "library_ms": None, "f32_operations": flops, "transcendentals": trans,
            "bytes": nbytes,
        })
        rows[-1]["smem_bytes"] = d2.flow_d2_smem_bytes(N, DIM, cfg, lap_on)
        if lap_on:
            rows[-1].update({"lap_abs_err": e32[2], "lap_abs_err_f64": e64[2],
                             "lap_max_abs": float(lap64.abs().max()), "tolerance_lap": TOL_LAP})
        else:
            rows[-1].update({"abs_err_vs_flow_u_jac": max(e_k1),
                             "replaces_also": ["coulombgas_tpu/ops/pallas_flow_jac.py:1062",
                                               "coulombgas_tpu/ops/pallas_flow_jac.py:1125"]})
        rows[-1].update(n57[int(lap_on)])
        rows[-1]["coincident_abs_err"] = max(e_co)
    return rows


def kernel_d2_n57():
    """K5 and K6 at the production shape n = 57, batch 512, on the checked-in
    checkpoint's trained weights and walkers, beside K1 on the same walkers:
    errors against both plain versions (K5 also against K1), a ragged batch,
    and the kernels timed in turns (K1, K5, K6, K6, K5, K1).  Returns the
    extra fields of K5's row and of K6's."""
    d2 = cuda_flow_d2
    L57, flow57, x57 = load_n57()
    flow64 = init_ferminet_params(flow57.cfg, DIM, None, torch.float64, DEV)
    flow64.load_state_dict({k: v.double() for k, v in flow57.state_dict().items()})
    with torch.no_grad():
        u, J = d2.flow_u_jac_d2_cuda(flow57, x57)
        ul, Jl, lap = d2.flow_u_jac_lap_d2_cuda(flow57, x57)
        u1, J1 = cuda_flow_jac.flow_u_jac_cuda(flow57, x57)
        torch.cuda.synchronize()
        u32, J32, lap32 = d2.flow_u_jac_lap_d2_plain(flow57, x57)
        u64, J64, lap64 = d2.flow_u_jac_lap_d2_plain(flow64, x57.double())
        e = {"f32": (max_err(u, u32), max_err(J, J32)), "f64": (max_err(u, u64), max_err(J, J64)),
             "flow_u_jac": (max_err(u, u1), max_err(J, J1))}
        for ref, (eu, eJ) in e.items():  # u reaches L = 13.4 here: its f32 ulp is 1e-6
            check(eu <= TOL_U and eJ <= TOL_UJ,
                  "flow_u_jac_d2 (n 57, checkpoint) vs %s: u %g J %g" % (ref, eu, eJ))
        e6 = {"f32": [max_err(a, b) for a, b in zip((ul, Jl, lap), (u32, J32, lap32))],
              "f64": [max_err(a, b) for a, b in zip((ul, Jl, lap), (u64, J64, lap64))]}
        for ref, (eu, eJ, el) in e6.items():
            check(eu <= TOL_U and eJ <= TOL_UJ and el <= TOL_LAP,
                  "flow_u_jac_lap_d2 (n 57, checkpoint) vs %s: u %g J %g lap %g" % (ref, eu, eJ, el))
        ur, Jr = d2.flow_u_jac_d2_cuda(flow57, x57[:-1])
        check(torch.equal(ur, u[:-1]) and torch.equal(Jr, J[:-1]),
              "flow_u_jac_d2 (n 57): ragged batch differs")
        got = d2.flow_u_jac_lap_d2_cuda(flow57, x57[:-1])
        check(all(torch.equal(a, b[:-1]) for a, b in zip(got, (ul, Jl, lap))),
              "flow_u_jac_lap_d2 (n 57): ragged batch differs")
        fns = {"flow_u_jac": cuda_flow_jac.flow_u_jac_cuda, "flow_u_jac_d2": d2.flow_u_jac_d2_cuda,
               "flow_u_jac_lap_d2": d2.flow_u_jac_lap_d2_cuda}
        ms = {k: [] for name in fns for k in (name, name + "_b2b")}
        for name in ("flow_u_jac", "flow_u_jac_d2", "flow_u_jac_lap_d2", "flow_u_jac_lap_d2",
                     "flow_u_jac_d2", "flow_u_jac"):
            ms[name].append(time_ms(lambda: fns[name](flow57, x57), 20))
            ms[name + "_b2b"].append(time_ms_b2b(lambda: fns[name](flow57, x57), 20))
        plain6_ms = time_ms(lambda: d2.flow_u_jac_lap_d2_plain(flow57, x57), 3)
    nd = N57 * DIM
    nparams = cuda_flow_jac.pack_flow_params(flow57).numel()
    out = []
    for name, lap_on, errs in (("flow_u_jac_d2", False, e), ("flow_u_jac_lap_d2", True, e6)):
        nbytes = 4 * (2 * BATCH57 * nd + BATCH57 * nd * nd + nparams + (BATCH57 * nd if lap_on else 0))
        flops, _ = d2_flops(BATCH57, N57, DIM, SPSIZE, TPSIZE, lap_on)
        t_b, t_o = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
        out.append({"ms_n57_b512": statistics.mean(ms[name]),
                    "ms_b2b_n57_b512": statistics.mean(ms[name + "_b2b"]),
                    "ms_n57_b512_turns": ms, "bound_ms_n57_b512": max(t_b, t_o),
                    "bound_by_n57_b512": "bytes" if t_b >= t_o else "operations",
                    "errors_n57_b512": errs,
                    "smem_bytes_n57": d2.flow_d2_smem_bytes(N57, DIM, flow57.cfg, lap_on)})
    out[1].update({"plain_ms_n57_b512": plain6_ms, "lap_max_abs_n57": float(lap64.abs().max())})
    return out


def phase_kernels():
    L, cfg, flow, x, kvec, tw, si = make_inputs()
    flow64 = init_ferminet_params(cfg, DIM, None, torch.float64, DEV)
    flow64.load_state_dict({k: v.double() for k, v in flow.state_dict().items()})
    nd = N * DIM
    rows = []

    # ---- K1 flow_u_jac ------------------------------------------------------
    u, J = cuda_flow_jac.flow_u_jac_cuda(flow, x)
    torch.cuda.synchronize()
    with torch.no_grad():
        u32, J32 = cuda_flow_jac.flow_u_jac_plain(flow, x)
        u64, J64 = cuda_flow_jac.flow_u_jac_plain(flow64, x.double())
    e_u, e_J = max_err(u, u32), max_err(J, J32)
    e_u64, e_J64 = max_err(u, u64), max_err(J, J64)
    check(e_u <= TOL_U and e_J <= TOL_UJ, "flow_u_jac vs plain f32: u %g J %g" % (e_u, e_J))
    check(e_u64 <= TOL_U and e_J64 <= TOL_UJ, "flow_u_jac vs plain f64: u %g J %g" % (e_u64, e_J64))
    # coincident particles: the pair distance is 0 and takes the guarded branch
    xs = x[:64].clone()
    xs[:, 1] = xs[:, 0]
    us, Js = cuda_flow_jac.flow_u_jac_cuda(flow, xs)
    with torch.no_grad():
        us_p, Js_p = cuda_flow_jac.flow_u_jac_plain(flow, xs)
    check(bool(torch.isfinite(us).all() and torch.isfinite(Js).all()),
          "flow_u_jac: non-finite output for coincident particles")
    check(max_err(us, us_p) <= TOL_U and max_err(Js, Js_p) <= TOL_UJ,
          "flow_u_jac coincident vs plain: u %g J %g" % (max_err(us, us_p), max_err(Js, Js_p)))
    ur, Jr = cuda_flow_jac.flow_u_jac_cuda(flow, x[:BATCH - 1])
    check(ur.shape[0] == BATCH - 1 and torch.equal(ur, u[:-1]) and torch.equal(Jr, J[:-1]),
          "flow_u_jac: ragged batch differs from the full batch")
    # widths other than the production ones run the kernel's instantiation
    # with run-time widths: other depths, dim 3, uneven widths
    for depth, dim, S, T, n in [(3, 2, 8, 12, 13), (1, 3, 3, 5, 6), (2, 3, 16, 16, 9)]:
        Lg = float(n) ** (1 / dim)
        fg = init_ferminet_params(FermiNetConfig(depth, S, T, Lg, 0.2), dim,
                                  torch.Generator().manual_seed(depth), torch.float32, DEV)
        xg = Lg * torch.rand(65, n, dim, device=DEV, generator=torch.Generator(DEV).manual_seed(n))
        ug, Jg = cuda_flow_jac.flow_u_jac_cuda(fg, xg)
        with torch.no_grad():
            ug_p, Jg_p = cuda_flow_jac.flow_u_jac_plain(fg, xg)
        check(max_err(ug, ug_p) <= TOL_U and max_err(Jg, Jg_p) <= TOL_UJ,
              "flow_u_jac (depth %d, dim %d, widths %d/%d) vs plain: u %g J %g" % (
                  depth, dim, S, T, max_err(ug, ug_p), max_err(Jg, Jg_p)))
    # the shared-memory budget, as the built library states it
    big = FermiNetConfig(DEPTH, SPSIZE, TPSIZE, L)
    check(cuda_flow_jac.flow_jac_fits(N, DIM, cfg) and cuda_flow_jac.flow_jac_fits(57, DIM, big)
          and cuda_flow_jac.flow_jac_smem_bytes(57, DIM, big) > cuda_flow_jac.flow_jac_smem_bytes(N, DIM, cfg)
          and not cuda_flow_jac.flow_jac_fits(65, DIM, big)
          and not cuda_flow_jac.flow_jac_fits(2000, DIM, big)
          and not cuda_flow_jac.flow_jac_fits(N, DIM, FermiNetConfig(DEPTH, 64, TPSIZE, L)),
          "flow_u_jac: shared-memory budget")
    with torch.no_grad():
        ms = time_ms(lambda: cuda_flow_jac.flow_u_jac_cuda(flow, x), 20)
        ms_b2b = time_ms_b2b(lambda: cuda_flow_jac.flow_u_jac_cuda(flow, x), 20)
        plain_ms = time_ms(lambda: cuda_flow_jac.flow_u_jac_plain(flow, x), 5)
    nbytes = 4 * (2 * BATCH * N * DIM + BATCH * nd * nd
                  + cuda_flow_jac.pack_flow_params(flow).numel())
    t_b = nbytes / PEAK_BYTES_PER_S * 1e3
    t_o = flow_flops(BATCH, N, DIM, DEPTH, SPSIZE, TPSIZE) / PEAK_F32_FLOPS * 1e3
    rows.append({
        "name": "flow_u_jac", "route": "cuda",
        "source": "coulombgas_tpu_torch/csrc/flow_jac.cu",
        "replaces": "coulombgas_tpu/ops/pallas_flow_jac.py:231",
        "max_abs_err": max(e_u, e_J), "max_abs_err_f64": max(e_u64, e_J64),
        "tolerance": TOL_U, "ms": ms, "ms_b2b": ms_b2b, "plain_ms": plain_ms,
        "bound_ms": max(t_b, t_o), "bound_by": "bytes" if t_b >= t_o else "operations",
        "library_ms": None,
    })


    # ---- K5 / K6 flow_u_jac_d2, flow_u_jac_lap_d2: the depth-2 closure ---------
    rows += kernels_d2(L, cfg, flow, flow64, x, u, J)

    # ---- K4 flow_u_jac_large: the depth-2 flow in its carried form ----------------
    rows.append(kernels_large(flow, x, u, J))
    rows[0]["ms_n57_b512"] = rows[-1]["flow_u_jac_ms_same_shape"]
    rows[0]["bound_ms_n57_b512"] = flow_flops(BATCH57, N57, DIM, DEPTH, SPSIZE, TPSIZE) / PEAK_F32_FLOPS * 1e3

    # ---- K2 fused_logp ------------------------------------------------------
    lp = cuda_fused_logp.fused_logp_cuda(u, kvec, J, L)
    torch.cuda.synchronize()
    lp32 = cuda_fused_logp.fused_logp_plain(u, kvec, J, L)
    lp64 = cuda_fused_logp.fused_logp_plain(u.double(), kvec.double(), J.double(), L)
    e32, e64 = max_err(lp, lp32), max_err(lp, lp64)
    q32, q64 = p99_err(lp, lp32), p99_err(lp, lp64)
    check(bool(torch.isfinite(lp).all()), "fused_logp: non-finite logp")
    check(e32 <= TOL_LOGP_MAX and e64 <= TOL_LOGP_MAX,
          "fused_logp vs plain, max: f32 %g f64 %g" % (e32, e64))
    check(q32 <= TOL_LOGP and q64 <= TOL_LOGP, "fused_logp vs plain, p99: f32 %g f64 %g" % (q32, q64))
    # singular: two equal rows of u make D rank-deficient (walkers 0-31), a
    # zero J makes G zero (walkers 32-63)
    us = u[:64].clone()
    us[:32, 1] = us[:32, 0]
    Jz = J[:64].clone()
    Jz[32:] = 0
    lps = cuda_fused_logp.fused_logp_cuda(us, kvec[:64], Jz, L)
    check(bool(torch.isfinite(lps).all()) and float(lps.max()) < float(lp.min()) - 20,
          "fused_logp: singular input not finite and strongly negative: max %g" % float(lps.max()))
    # Held against the plain version where the deflation is exact.  Equal rows
    # leave a roundoff-sized last pivot, whose logarithm is noise in any f32
    # version, so those walkers are not compared.  A zero J deflates all nd
    # pivots of G; a box so large that n / L^dim is below the pivot floor
    # deflates all n pivots of H.
    lps_p = cuda_fused_logp.fused_logp_plain(us, kvec[:64], Jz, L)
    e_sing = max_err(lps[32:], lps_p[32:])
    L_huge = 1e17
    lph = cuda_fused_logp.fused_logp_cuda(u[:64], kvec[:64], J[:64], L_huge)
    e_sing = max(e_sing, max_err(lph, cuda_fused_logp.fused_logp_plain(u[:64], kvec[:64], J[:64], L_huge)))
    check(bool(torch.isfinite(lph).all()) and float(lph.max()) < N * math.log(1e-30) + 100,
          "fused_logp: all-deflated Hermitian part: max %g" % float(lph.max()))
    check(e_sing <= TOL_LOGP_MAX, "fused_logp singular vs plain: %g" % e_sing)
    # partial deflation: a zero column of J makes that pivot of G exactly zero
    # and leaves the other steps as they were; at a panel's (8 columns) first,
    # middle and last column, so the deflated column is kept out of the rest
    # of its panel and of the trailing product
    e_part = {}
    for col in (8, 12, 15):
        Jp = J[:256].clone()
        Jp[:, :, col] = 0
        got = cuda_fused_logp.fused_logp_cuda(u[:256], kvec[:256], Jp, L)
        ref = cuda_fused_logp.fused_logp_plain(u[:256], kvec[:256], Jp, L)
        e_part[col] = (max_err(got, ref), p99_err(got, ref))
        check(bool(torch.isfinite(got).all()) and float((got - lp[:256]).max()) < -20
              and e_part[col][0] <= TOL_LOGP_MAX and e_part[col][1] <= TOL_LOGP,
              "fused_logp, J column %d zero, vs plain: max %g p99 %g" % ((col,) + e_part[col]))
    check(cuda_fused_logp.fused_fits(N, DIM) and cuda_fused_logp.fused_fits(57, 2)
          and not cuda_fused_logp.fused_fits(200, 2)
          and cuda_fused_logp.fused_smem_bytes(N, DIM) < 48 * 1024,
          "fused_logp: shared-memory budget")
    lpr = cuda_fused_logp.fused_logp_cuda(u[:-1], kvec[:-1], J[:-1], L)
    check(lpr.shape[0] == BATCH - 1 and torch.equal(lpr, lp[:-1]), "fused_logp: ragged batch differs")
    ms = time_ms(lambda: cuda_fused_logp.fused_logp_cuda(u, kvec, J, L), 20)
    plain_ms = time_ms(lambda: cuda_fused_logp.fused_logp_plain(u, kvec, J, L), 5)
    t_b, t_o = fused_bound(BATCH, N, DIM)
    rows.append({
        "name": "fused_logp", "route": "cuda",
        "source": "coulombgas_tpu_torch/csrc/fused_logp.cu",
        "replaces": "coulombgas_tpu/ops/pallas_fused_logp.py:188",
        "max_abs_err": e32, "max_abs_err_f64": e64, "p99_abs_err": q32,
        "p99_abs_err_f64": q64, "singular_abs_err": e_sing,
        "partial_deflation_abs_err_max_p99": e_part,
        "tolerance": TOL_LOGP_MAX, "tolerance_p99": TOL_LOGP,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_b, t_o), "bound_by": "bytes" if t_b >= t_o else "operations",
        "library_ms": None,
    })
    rows[-1].update(fused_n57())

    # ---- K3 chol_logdet: the stacked Grams of the unfused route ---------------
    ang = torch.einsum("bnd,bmd->bnm", u, kvec)
    c = L ** (-DIM / 2)
    A = torch.cat([planewave_gram_embed(c * torch.cos(ang), c * torch.sin(ang)),
                   torch.einsum("bij,bkj->bik", J, J)], dim=0).contiguous()
    check(A.shape == (K3_BATCH, nd, nd), "K3 input shape %s" % (tuple(A.shape),))
    ld = cuda_logdet.chol_logdet_cuda(A)
    torch.cuda.synchronize()
    ld32 = cuda_logdet.chol_logdet_plain(A)
    ld64 = cuda_logdet.chol_logdet_plain(A.double())
    # ld enters logp with weight 1/2, so twice the logp tolerances
    e32, e64 = max_err(ld, ld32), max_err(ld, ld64)
    q32, q64 = p99_err(ld, ld32), p99_err(ld, ld64)
    check(e32 <= 2 * TOL_LOGP_MAX and e64 <= 2 * TOL_LOGP_MAX,
          "chol_logdet vs plain, max: f32 %g f64 %g" % (e32, e64))
    check(q32 <= 2 * TOL_LOGP and q64 <= 2 * TOL_LOGP,
          "chol_logdet vs plain, p99: f32 %g f64 %g" % (q32, q64))
    As = A[:64].clone()
    As[:32] = 0
    As[32:, :, 5] = 0
    As[32:, 5, :] = 0
    lds = cuda_logdet.chol_logdet_cuda(As)
    check(bool(torch.isfinite(lds).all()) and float(lds.max()) < -40,
          "chol_logdet: singular input not finite and strongly negative: max %g" % float(lds.max()))
    check(max_err(lds, cuda_logdet.chol_logdet_plain(As)) <= 2 * TOL_LOGP, "chol_logdet singular vs plain")
    check(cuda_logdet.chol_logdet_fits(nd) and not cuda_logdet.chol_logdet_fits(400),
          "chol_logdet: shared-memory budget")
    ldr = cuda_logdet.chol_logdet_cuda(A[:-1])
    check(ldr.shape[0] == K3_BATCH - 1 and torch.equal(ldr, ld[:-1]), "chol_logdet: ragged batch differs")
    cases = k3_cases(J, A)
    ms = time_ms(lambda: cuda_logdet.chol_logdet_cuda(A), 20)
    plain_ms = time_ms(lambda: cuda_logdet.chol_logdet_plain(A), 5)
    library_ms = time_ms(
        lambda: 2 * torch.linalg.cholesky(A).diagonal(dim1=-2, dim2=-1).log().sum(-1), 10)
    t_b, t_o = k3_bound(K3_BATCH, nd)
    rows.append({
        "name": "chol_logdet", "route": "cuda",
        "source": "coulombgas_tpu_torch/csrc/chol_logdet.cu",
        "replaces": "coulombgas_tpu/ops/pallas_logdet.py:90",
        "max_abs_err": e32, "max_abs_err_f64": e64, "p99_abs_err": q32,
        "p99_abs_err_f64": q64, "tolerance": 2 * TOL_LOGP_MAX, "tolerance_p99": 2 * TOL_LOGP,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_b, t_o), "bound_by": "bytes" if t_b >= t_o else "operations",
        "library_ms": library_ms, "other_shapes": k3_shapes(J, A), "cases": cases,
    })
    emit({"phase": "kernels", "shapes": {"n": N, "dim": DIM, "depth": DEPTH, "spsize": SPSIZE,
                                         "tpsize": TPSIZE, "batch": BATCH, "k3_batch": K3_BATCH,
                                         "m": nd},
          "kernels": rows})
    return rows


def k3_bound(B, m):
    """K3's least times in ms on the card, (by bytes, by operations), for B
    m x m matrices: the lower triangles, m (m + 1) / 2 floats each, read
    once and one float a matrix written; m^3 / 3 f32 operations a matrix."""
    nbytes = 4 * B * (m * (m + 1) // 2 + 1)
    return nbytes / PEAK_BYTES_PER_S * 1e3, B * m**3 / 3 / PEAK_F32_FLOPS * 1e3


def random_spd(B, m, seed):
    """B random SPD matrices X X^T / m + I / 2 on the card, f32."""
    X = torch.randn(B, m, m, device=DEV, generator=torch.Generator(DEV).manual_seed(seed))
    return (X @ X.mT / m + 0.5 * torch.eye(m, device=DEV)).contiguous()


# K3's shapes: who calls it, batch, m (PERF.md section 6)
K3_SHAPES = (("stacked_b512_m171", 512, 171), ("stacked_b512_m114", 512, 114),
             ("accumulate_b2048_m58", BATCH, N * DIM), ("unfused_b4096_m58", K3_BATCH, N * DIM),
             ("demo_accumulate_b2048_m26", 2048, 26))


def k3_cases(J, A_stacked):
    """K3 beyond the stacked Grams: its launch plan at each shape (with the
    blocks an SM the runtime allows); against plain f32 and f64 at each shape
    of ``K3_SHAPES`` and at the largest m it takes (random SPD matrices, J J^T
    at the accumulate's shape, ``A_stacked`` at the unfused route's);
    singular inputs, a zero row and column at a panel's first, middle and
    last column and the zero matrix; batches of 1 and 3 and a ragged one,
    and every other plan that fits, bit for bit against the full batch."""
    out = {"plans": {}, "errors": {}}
    inputs = {"accumulate_b2048_m58": torch.einsum("bij,bkj->bik", J, J).contiguous(),
              "unfused_b4096_m58": A_stacked}
    shapes = K3_SHAPES + (("largest_b64_m%d" % cuda_logdet.K3_MAX_M, 64, cuda_logdet.K3_MAX_M),)
    for k, (tag, B, m) in enumerate(shapes):
        A = inputs[tag] if tag in inputs else random_spd(B, m, 10 + k)
        plan = cuda_logdet._plan(m, B, DEV.index or 0)
        out["plans"][tag] = dict(plan._asdict(), occupancy=cuda_logdet.occupancy(plan))
        check(out["plans"][tag]["occupancy"] >= plan.blocks_per_sm,
              "chol_logdet plan %s: the runtime holds %d blocks an SM" % (plan, out["plans"][tag]["occupancy"]))
        ld = cuda_logdet.chol_logdet_cuda(A)
        torch.cuda.synchronize()
        ld32 = cuda_logdet.chol_logdet_plain(A)
        ld64 = cuda_logdet.chol_logdet_plain(A.double())
        e = {"f32": [max_err(ld, ld32), p99_err(ld, ld32)], "f64": [max_err(ld, ld64), p99_err(ld, ld64)]}
        out["errors"][tag] = e
        check(bool(torch.isfinite(ld).all()) and all(v[0] <= 2 * TOL_LOGP_MAX and v[1] <= 2 * TOL_LOGP
                                                     for v in e.values()),
              "chol_logdet at %s vs plain: %s" % (tag, e))
        # batches of 1 and 3, a ragged one, and the other plans: the same bits
        for sub in (1, 3, B - 1):
            check(torch.equal(cuda_logdet.chol_logdet_cuda(A[:sub].contiguous()), ld[:sub]),
                  "chol_logdet at %s: batch of %d differs from the full batch" % (tag, sub))
        others = 0
        sms = torch.cuda.get_device_properties(DEV).multi_processor_count
        for p in cuda_logdet.k3_plans(m, B, sms):
            if p != plan:
                others += 1
                check(torch.equal(cuda_logdet._launch(A, p), ld),
                      "chol_logdet at %s: plan %s differs from %s" % (tag, p, plan))
        out["plans"][tag]["other_plans_bit_equal"] = others
        if tag in ("stacked_b512_m171", "accumulate_b2048_m58", "demo_accumulate_b2048_m26"):
            out["errors"][tag]["singular"] = k3_singular(A[:64], ld[:64])
    return out


def k3_singular(A, ld):
    """A zero row and column at a panel's (8 columns) first, middle and last
    column, 8, 12 and 15 (below m 16: the last), and the zero matrix: finite,
    strongly negative, against plain f32 and f64; the zero matrix's m
    deflated pivots against m log(PIVOT_FLOOR).  The matrices are scaled to
    determinant 1 first (random SPD ones at m 171 have log det near +35), so
    that one deflated pivot, log(PIVOT_FLOOR) = -69, puts the value below
    -40."""
    m = A.shape[-1]
    scale = torch.exp(-ld.double() / m).float()
    As = A * scale[:, None, None]
    ld = cuda_logdet.chol_logdet_cuda(As.contiguous())
    for b in range(1, As.shape[0]):
        col = (8, 12, 15)[b % 3] if m > 15 else m - 1
        As[b, col, :] = 0
        As[b, :, col] = 0
    As[0] = 0
    got = cuda_logdet.chol_logdet_cuda(As)
    torch.cuda.synchronize()
    e = {"f32": max_err(got, cuda_logdet.chol_logdet_plain(As)),
         "f64": max_err(got, cuda_logdet.chol_logdet_plain(As.double())),
         "zero_matrix_rel": abs(float(got[0]) / (m * math.log(1e-30)) - 1)}
    check(bool(torch.isfinite(got).all()) and float(got.max()) < -40
          and float((got[1:] - ld[1:]).max()) < -40 and e["f32"] <= 2 * TOL_LOGP
          and e["f64"] <= 2 * TOL_LOGP_MAX and e["zero_matrix_rel"] <= 1e-5,
          "chol_logdet, singular inputs at m %d: max %g, %s" % (m, float(got.max()), e))
    return e


def k3_shapes(J, A_stacked):
    """K3 beside ``torch.linalg.cholesky`` + log-diag, in turns (K3, library,
    library, K3), at the shapes of ``K3_SHAPES``: the accumulate's (J J^T of
    the main path, batch 2048, m 58; the n 13 demo's, m 26), the stacked
    route's past K2 (n 57, dim 3, batch 512: the plane-wave Gram embedding,
    m 114, and J's Gram, m 171) and the unfused route's (both Grams stacked,
    batch 4096, m 58); random SPD matrices except at m 58."""
    out = {}
    inputs = {"accumulate_b2048_m58": torch.einsum("bij,bkj->bik", J, J).contiguous(),
              "unfused_b4096_m58": A_stacked}
    for k, (tag, B, m) in enumerate(K3_SHAPES):
        A = inputs[tag] if tag in inputs else random_spd(B, m, 3 + k)
        ld = cuda_logdet.chol_logdet_cuda(A)
        ld64 = cuda_logdet.chol_logdet_plain(A.double())
        err = max_err(ld, ld64)
        check(err <= 2 * TOL_LOGP_MAX, "chol_logdet at B %d, m %d vs plain f64: %g" % (B, m, err))

        def lib():
            return 2 * torch.linalg.cholesky(A).diagonal(dim1=-2, dim2=-1).log().sum(-1)

        ms = {"k3": [], "library": []}
        for who in ("k3", "library", "library", "k3"):
            ms[who].append(time_ms(lib if who == "library" else
                                   (lambda: cuda_logdet.chol_logdet_cuda(A)), 20))
        t_b, t_o = k3_bound(B, m)
        out[tag] = {"batch": B, "m": m, "ms": statistics.mean(ms["k3"]),
                    "ms_b2b": time_ms_b2b(lambda: cuda_logdet.chol_logdet_cuda(A), 20),
                    "library_ms": statistics.mean(ms["library"]), "turns": ms,
                    "bound_ms": max(t_b, t_o), "bound_by": "bytes" if t_b >= t_o else "operations",
                    "max_abs_err_f64": err}
    return out


def reset_counts():
    counters.reset()


def read_counts():
    """Each kernel's runs since ``reset_counts``: eager launches, and a
    graph replay's kernel nodes as read from the captured graph."""
    return dict(counters.launches)


def phase_train():
    """Two Adam epochs of the trainer at the default width, then the third route."""
    import tempfile

    import main_torch

    mc_therm, epochs = 2, 2
    with tempfile.TemporaryDirectory() as out:
        args = main_torch.parse_args([
            "--folder", "data/interacting/", "--hutchinson", "--mc_therm", str(mc_therm),
            "--acc_steps", "1", "--epoch", str(epochs), "--ckpt_every", "1000000",
        ])
        check((args.n, args.dim, args.Emax, args.batch, args.mc_steps) == (N, DIM, EMAX, BATCH, 50),
              "main_torch defaults are not the main path's width")
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        run = main_torch.train(args, out_folder=out)
        counts = read_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for row in run["epochs"]:
        emit(dict({"phase": "train"}, **row))
        vals = [row[k] for k in ("F", "E", "K", "V", "S", "accept_rate")]
        check(all(math.isfinite(v) for v in vals), "non-finite observable in epoch %d" % row["epoch"])
        check(0.05 < row["accept_rate"] < 0.95, "accept rate %g out of (0.05, 0.95)" % row["accept_rate"])
    expect = 51 * (mc_therm + epochs)
    check(counts["flow_u_jac"] == expect and counts["fused_logp"] == expect,
          "launch counters %s, expected %d for flow_u_jac and fused_logp" % (counts, expect))
    # accumulate takes the value of log det(J J^T) from the chol_logdet kernel:
    # once for the Hutchinson term and once for log Psi, every epoch
    check(counts["chol_logdet"] == 2 * epochs,
          "chol_logdet launches %d on the main path, expected %d" % (counts["chol_logdet"], 2 * epochs))
    check(counts["flow_u_jac_d2"] == 0 and counts["flow_u_jac_lap_d2"] == 0,
          "the Adam path launched a depth-2 closure kernel: %s" % counts)
    check(run["params_changed"], "parameters did not change")

    # One sample step on the route without the fused tail: the stacked Grams
    # of all 51 logp evaluations go through the chol_logdet kernel.
    trainer = run["trainer"]
    logp3 = make_logp_fast(trainer.sp_indices, trainer.L, use_fused=False, use_flow_kernel=False)
    sample3 = main_torch.make_sample_step(
        trainer.sampler, logp3, args.mc_steps, args.mc_stddev, trainer.L, args.batch)
    before = counters.launches["chol_logdet"]
    x0 = trainer.x.clone()
    si, x3, acc3 = sample3(trainer.van, trainer.flow, trainer.x, trainer.generator)
    route3 = counters.launches["chol_logdet"] - before
    check(route3 == 51, "chol_logdet launches %d on the unfused route, expected 51" % route3)
    lp_fused = trainer.logp(x3, trainer.flow, si)
    lp_chol = logp3(x3, trainer.flow, si)
    err = max_err(lp_fused, lp_chol)
    check(bool(torch.isfinite(lp_chol).all()) and err <= TOL_LOGP_MAX,
          "logp of the chol_logdet route differs from the fused route by %g" % err)
    check(bool(torch.isfinite(x3).all()) and x3.shape == x0.shape, "walkers of the third route")
    emit({"phase": "train", "route": "chol_logdet", "accept_rate": float(acc3),
          "logp_max_abs_diff_vs_fused": err, "launches_on_this_route": route3,
          "launches_main_path": counts, "peak_GiB": round(peak_gib, 3)})
    return counts


def phase_sample_graph(steps: int = 4):
    """The sample step replayed as one CUDA graph against the same step run
    eagerly (a twin of the Metropolis log-density without the graph-safe
    mark), on the trainer of main.py's --hutchinson line: from one generator
    state, ``steps`` graphed steps (one capture, then replays) and ``steps``
    eager ones, bit for bit in states, walkers, accept rates, the generator's
    state and the launch counters (a replay counts the kernel nodes of the
    captured graph: 51 of K1 or K5 and of K2 a step); a ``set_state``
    between replays (the tripwire's revert, a resume); the --mc_d2_kernel
    route graphed too, and --slow_logp's left eager; torch.multinomial's
    checks as device flags; the memory a captured step keeps allocated and
    the pool it reserves, and both steps' wall time."""
    import tempfile

    import main_torch
    from coulombgas_tpu_torch.models.ferminet import ferminet_apply
    from coulombgas_tpu_torch.sampling.autoregressive import drawable
    from coulombgas_tpu_torch.train.train import make_sample_step, sample_graph
    from coulombgas_tpu_torch.wavefunction.logpsi import make_logp, make_logpsi

    with tempfile.TemporaryDirectory() as out:
        args = main_torch.parse_args(["--folder", "data/interacting/", "--hutchinson"])
        tr = main_torch.build_trainer(args, out_folder=out)
    check(main_torch.sample_graph_blocker(tr.logp, DEV) == "",
          "the main path's sample step would not be graphed")
    van, flow, B = tr.van, tr.flow, args.batch

    def pair(logp):
        """(graphed, eager) sample steps on ``logp``: the eager one's
        log-density is the same closure without the mark."""
        def unmarked(x, f, si):
            return logp(x, f, si)
        return [make_sample_step(tr.sampler, lp, args.mc_steps, args.mc_stddev, tr.L, B)
                for lp in (logp, unmarked)]

    def run(step, gen, state, x, k):
        gen.set_state(state)
        reset_counts()
        outs = []
        for _ in range(k):
            si, x, acc = step(van, flow, x, gen)
            outs.append((si, x, acc))
        torch.cuda.synchronize()
        return outs, gen.get_state(), read_counts()

    def same(a, b):
        return all(torch.equal(p, q) for ra, rb in zip(a, b) for p, q in zip(ra, rb))

    gen_g, gen_e = torch.Generator(DEV).manual_seed(7), torch.Generator(DEV)
    for _ in range(3):  # walkers off the uniform start
        _, tr.x, _ = tr.sample_step(van, flow, tr.x, gen_g)
    x0, s0 = tr.x.clone(), gen_g.get_state()
    report = {}
    for route, logp in (("flow kernel", tr.logp),
                        ("--mc_d2_kernel", make_logp_fast(tr.sp_indices, tr.L, use_d2_flow=True))):
        graphed, eager = pair(logp)
        before = dict(sample_graph)
        outs_g, end_g, counts_g = run(graphed, gen_g, s0, x0, steps)
        moved = {k: sample_graph[k] - before[k] for k in sample_graph}
        outs_e, end_e, counts_e = run(eager, gen_e, s0, x0, steps)
        check(moved == {"captures": 1, "replays": steps - 1, "eager": 0},
              "%s: sample_graph moved %s over %d steps" % (route, moved, steps))
        check(same(outs_g, outs_e) and torch.equal(end_g, end_e),
              "%s: graphed and eager sample steps differ" % route)
        kernel = "flow_u_jac" if route == "flow kernel" else "flow_u_jac_d2"
        check(counts_g == counts_e and counts_g[kernel] == 51 * steps
              and counts_g["fused_logp"] == 51 * steps,
              "%s: launch counters graphed %s, eager %s" % (route, counts_g, counts_e))
        # the tripwire's revert: the generator set back between two replays
        x1, s1 = outs_g[-1][1], end_g
        gen_g.set_state(s1)
        again = [graphed(van, flow, x1, gen_g)]
        gen_g.set_state(s1)
        again.append(graphed(van, flow, x1, gen_g))
        gen_e.set_state(s1)
        ref = [eager(van, flow, x1, gen_e)]
        check(same(again[:1], again[1:]) and same(again[:1], ref)
              and torch.equal(gen_g.get_state(), gen_e.get_state()),
              "%s: replays after set_state differ from the eager step" % route)
        report[route] = {"accept_rates": [float(o[2]) for o in outs_g], "launches": counts_g}

    # --slow_logp: no mark, so eager; at a batch its jacfwd and slogdet fit
    slow = make_logp(make_logpsi(ferminet_apply, tr.sp_indices, tr.L))
    check(main_torch.sample_graph_blocker(slow, DEV) != "", "--slow_logp would be graphed")
    before = dict(sample_graph)
    step = make_sample_step(tr.sampler, slow, 2, args.mc_stddev, tr.L, 256)
    step(van, flow, x0[:256], gen_e)
    check(sample_graph == dict(before, eager=before["eager"] + 1),
          "--slow_logp: sample_graph %s from %s" % (sample_graph, before))

    # torch.multinomial's checks, as flags on the card (a device-side assert
    # would end the process)
    good = torch.full((64, 81), 1 / 81, device=DEV)
    flags = {}
    for kind, val, at in (("good", None, None), ("nan", float("nan"), (5, 7)),
                          ("inf", float("inf"), (0, 0)), ("negative", -1e-3, (63, 80)),
                          ("zero_row", 0.0, 9)):
        probs = good.clone()
        if at is not None:
            probs[at] = val
        low, high = torch.aminmax(probs)
        f = drawable(low[None], high[None], probs.sum(-1)[None])
        flags[kind] = [bool(f[0]), bool(f[1])]
    check(flags == {"good": [True, True], "nan": [False, True], "inf": [False, True],
                    "negative": [False, True], "zero_row": [True, False]},
          "torch.multinomial's checks on the card: %s" % flags)

    # memory: a captured step keeps the capture stream's cuBLAS workspace and
    # its static walkers and outputs allocated, and its pool reserves the
    # step's intermediates; a replay allocates nothing
    graphed, eager = pair(tr.logp)
    gen = torch.Generator(DEV).manual_seed(11)
    eager(van, flow, x0, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    at = torch.cuda.memory_allocated()
    out = eager(van, flow, x0, gen)
    torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated() - at
    static = x0.nbytes + sum(t.nbytes for t in out)
    del out

    def held():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # reserved: live segments and the graph's pool
        return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()

    base = held()
    graphed(van, flow, x0, gen)  # the capture
    after_capture = held()
    for _ in range(3):
        graphed(van, flow, x0, gen)
    after_replays = held()
    allocated, pool = (c - b for c, b in zip(after_capture, base))
    check(after_replays[0] <= after_capture[0] and after_replays[1] == after_capture[1],
          "replays allocated: %s after the capture, %s after 3 replays"
          % (after_capture, after_replays))
    # the pool holds one step's intermediates (at most twice over for the
    # caching allocator's rounding of segments) beside what stays allocated
    check(pool <= allocated + 2 * eager_peak,
          "a captured sample step reserves %d bytes (%d allocated, an eager step's peak %d)"
          % (pool, allocated, eager_peak))
    walls = {"eager": [], "graphed": []}
    for name in ("eager", "graphed", "graphed", "eager", "eager", "graphed"):
        step = graphed if name == "graphed" else eager
        torch.cuda.synchronize()
        t0 = time.time()
        step(van, flow, x0, gen)
        torch.cuda.synchronize()
        walls[name].append(round(1e3 * (time.time() - t0), 2))
    emit({"phase": "sample_graph", "steps": steps, "routes": report, "check_flags": flags,
          "graph_allocated_bytes": allocated, "graph_reserved_bytes": pool,
          "static_bytes": static, "eager_step_peak_bytes": eager_peak, "step_wall_ms": walls,
          "counters": dict(sample_graph)})


def phase_accumulate_graph(rounds: int = 3):
    """The SR accumulate's graph part (observables, Hutchinson Laplacian,
    scores) replayed as one CUDA graph against the same piece run eagerly,
    on main.py's --sr --hutchinson line (n 29, B 2048) and the n 57
    production line (B 512, --sr_solver host64): ``rounds`` accumulates of
    one sample step's walkers, the probe handed in and then drawn from a
    generator set back to one state before each, graphed (one capture, then
    replays) and by an eager twin (the loss without the graph-safe mark) on
    the capture's cuSOLVER backend: the accumulators and the generator's
    state bit for bit, the launch counters alike; the graph's kernel nodes
    against the kernels of the eager graph part (profiled); the eager twin
    on the default backend beside them (the largest relative gap of an
    accumulator); the memory the graph keeps; a round's wall time each way.
    Then two gloo ranks on the card holding one chunk of the n 29 line
    (shares of 1024, the clip window reduced eagerly between replays)
    against one process."""
    import tempfile

    import main_torch
    from coulombgas_tpu_torch.io.checkpoint import save_data, to_host
    from coulombgas_tpu_torch.io.convert import flatten_tree, flow_to_numpy, van_to_numpy
    from coulombgas_tpu_torch.optim.sr import quantum_score_mean
    from coulombgas_tpu_torch.train.train import (
        _capturable_linalg, accumulate_graph, init_accumulators, make_accumulate_and_apply,
    )

    def unmarked(loss):
        def twin(*a, **k):
            return loss(*a, **k)
        twin.observables, twin.clip_window = loss.observables, loss.clip_window
        return twin

    def kernels(prof):
        return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                and not e.name.startswith(("Memcpy", "Memset")) and "spin_kernel" not in e.name]

    def core_seq(names):
        """Kernel names without template arguments or parameters."""
        return (re.sub(r"^void ", "", n).split("<")[0].split("(")[0] for n in names)

    def demangled(symbols):
        try:
            return subprocess.run(["c++filt"], input="\n".join(symbols), capture_output=True,
                                  text=True, check=True).stdout.splitlines()
        except (OSError, subprocess.SubprocessError):
            return symbols

    def gaps(a, b):
        """Relative gap of each accumulator, its leaves taken together."""
        groups = {}
        for k in b:
            parts = k.split(".")
            groups.setdefault(".".join(parts[:2]) if parts[0] in ("data", "grads") else parts[0],
                              []).append(k)
        return {g: _rel(np.concatenate([np.ravel(a[k]) for k in ks]),
                        np.concatenate([np.ravel(b[k]) for k in ks])) for g, ks in groups.items()}

    lines = {"n29": ["--folder", "data/interacting/", "--sr", "--hutchinson"],
             "n57": ["--n", str(N57), "--rs", "1.0", "--Emax", str(EMAX57), "--batch",
                     str(BATCH57), "--sr", "--hutchinson", "--sr_solver", "host64",
                     "--folder", "data/interacting_n57/"]}
    report = {}
    for name, argv in lines.items():
        with tempfile.TemporaryDirectory() as out:
            args = main_torch.parse_args(argv)
            tr = main_torch.build_trainer(args, out_folder=out)
        check(main_torch.accumulate_graph_blocker(tr.loss, tr.sr_opt, DEV) == "",
              "%s: the SR accumulate would not be graphed" % name)
        for _ in range(3):  # walkers off the uniform start
            si, tr.x, _ = tr.sample_step(tr.van, tr.flow, tr.x, tr.generator)
        x, B = tr.x, args.batch
        fd = main_torch.fisher_dtype(args)
        graphed, _ = make_accumulate_and_apply(tr.loss, 1, sr_opt=tr.sr_opt, fisher_dtype=fd)
        eager, _ = make_accumulate_and_apply(unmarked(tr.loss), 1, sr_opt=tr.sr_opt,
                                             fisher_dtype=fd)
        gen = torch.Generator(DEV).manual_seed(5)
        s0 = gen.get_state()
        v = torch.randn(x.shape, generator=torch.Generator(DEV).manual_seed(6), device=DEV)

        def run(fn, probe):
            reset_counts()
            accs, ends = [], []
            for _ in range(rounds):
                gen.set_state(s0)
                acc = init_accumulators(tr.van, tr.flow, sr=True, fisher_dtype=fd)
                accs.append(to_host(fn(tr.van, tr.flow, si, x, gen, acc, probe)))
                ends.append(gen.get_state())
            torch.cuda.synchronize()
            return [flatten_tree(a) for a in accs], ends, read_counts()

        case = {}
        for probe_name, probe in (("handed_in", v), ("drawn", None)):
            before = dict(accumulate_graph)
            accs_g, ends_g, counts_g = run(graphed, probe)
            moved = {k: accumulate_graph[k] - before[k] for k in before}
            check(moved == {"captures": 1, "replays": rounds - 1, "eager": 0},
                  "%s, probe %s: accumulate_graph moved %s" % (name, probe_name, moved))
            with _capturable_linalg():
                accs_e, ends_e, counts_e = run(eager, probe)
            accs_d, _, _ = run(eager, probe)  # the default backend
            keys = sorted(accs_e[0])
            same = all(np.array_equal(a[k], accs_e[0][k]) for a in accs_g + accs_e for k in keys)
            check(same and all(torch.equal(e, ends_e[0]) for e in ends_g + ends_e),
                  "%s, probe %s: graphed and eager accumulates differ" % (name, probe_name))
            check(counts_g == counts_e and counts_g["chol_logdet"] > 0,
                  "%s, probe %s: launch counters graphed %s, eager %s"
                  % (name, probe_name, counts_g, counts_e))
            case[probe_name] = {"default_backend_rel_gaps": gaps(accs_e[0], accs_d[0]),
                                "launches": counts_g}

        # the graph's kernel nodes against the eager graph part's kernels
        graph = graphed.graphs[B]["graph"]
        nodes = demangled(counters.graph_kernels(graph))
        with _capturable_linalg(), torch.no_grad():
            tr.loss.observables(tr.van, tr.flow, si, x, gen, None)  # warm
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                # a fence the count leaves out: the trace may miss the first
                # kernel after the profiler starts
                torch.cuda._sleep(1000)
                torch.cuda.synchronize()
                tr.loss.observables(tr.van, tr.flow, si, x, gen, None)
                s_c, s_q = tr.sr_opt.scores(tr.van, tr.flow, si, x)
                s_c.mean(dim=0), quantum_score_mean(s_q)
                torch.cuda.synchronize()
        eager_kernels = kernels(prof)
        if len(nodes) != len(eager_kernels):
            a, b = (list(core_seq(n)) for n in (nodes, eager_kernels))
            ops = [(tag, i1, i2, j1, j2) for tag, i1, i2, j1, j2
                   in difflib.SequenceMatcher(None, a, b, autojunk=False).get_opcodes()
                   if tag != "equal"]
            emit({"phase": "accumulate_graph", "line": name, "graph_against_eager": [
                {"op": tag, "graph": a[max(i1 - 3, 0):i2 + 3], "eager": b[max(j1 - 3, 0):j2 + 3],
                 "at": [i1, j1]} for tag, i1, i2, j1, j2 in ops[:5]]})
        check(len(nodes) == len(eager_kernels),
              "%s: the graph holds %d kernels, the eager graph part runs %d"
              % (name, len(nodes), len(eager_kernels)))

        # memory: what the graph keeps allocated and reserves; a replay allocates nothing
        def held():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()

        graphed.graphs.clear()
        acc = init_accumulators(tr.van, tr.flow, sr=True, fisher_dtype=fd)
        eager(tr.van, tr.flow, si, x, gen, acc, v)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        at = torch.cuda.memory_allocated()
        eager(tr.van, tr.flow, si, x, gen, acc, v)
        torch.cuda.synchronize()
        eager_peak = torch.cuda.max_memory_allocated() - at
        base = held()
        graphed(tr.van, tr.flow, si, x, gen, acc, v)  # the capture
        after_capture = held()
        for _ in range(3):
            graphed(tr.van, tr.flow, si, x, gen, acc, v)
        after_replays = held()
        check(after_replays[0] <= after_capture[0] and after_replays[1] == after_capture[1],
              "%s: replays allocated: %s after the capture, %s after 3 replays"
              % (name, after_capture, after_replays))
        walls = {"eager": [], "graphed": []}
        for which in ("eager", "graphed", "graphed", "eager", "eager", "graphed"):
            fn = graphed if which == "graphed" else eager
            torch.cuda.synchronize()
            t0 = time.time()
            fn(tr.van, tr.flow, si, x, gen, acc, v)
            torch.cuda.synchronize()
            walls[which].append(round(1e3 * (time.time() - t0), 2))
        report[name] = dict(case, graph_kernels=len(nodes), eager_kernels=len(eager_kernels),
                            eager_round_peak_bytes=eager_peak,
                            graph_allocated_bytes=after_capture[0] - base[0],
                            graph_reserved_bytes=after_capture[1] - base[1], round_wall_ms=walls)
        emit(dict({"phase": "accumulate_graph", "line": name, "batch": B}, **report[name]))
        if name == "n29":
            shared = (tr, si, v, argv)
        del tr, graphed, eager, graph

    # two gloo ranks on the card, one chunk of 2048 across both: the clip
    # window's means reduced eagerly between the replays of each rank's graph
    tr, si, v, argv = shared
    names = ([k for k, _ in tr.van.named_parameters()], [k for k, _ in tr.flow.named_parameters()])
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "walkers.pkl")
        save_data({"x": tr.x.cpu().numpy(), "params_van": van_to_numpy(tr.van),
                   "params_flow": flow_to_numpy(tr.flow)}, ckpt)
        out = _shared_batch_step(tmp, "accumulate_graph", argv + ["--sr_solver", "host64"], ckpt,
                                 si.cpu().numpy(), v.cpu().numpy(), names, rounds=2,
                                 params=False)
    want = {"captures": 1, "replays": 1, "eager": 0}
    check(out["accumulate_graph"] == {"ranks": want, "one_process": want},
          "two ranks: accumulate_graph moved %s" % out["accumulate_graph"])
    emit(dict({"phase": "accumulate_graph", "case": "two_gloo_ranks_one_chunk"}, **out))
    emit({"phase": "accumulate_graph", "counters": dict(accumulate_graph)})


def phase_train_default():
    """main.py's default command line through main_torch.py's functions: Adam
    and the exact Laplacian (no --hutchinson) at the default width."""
    import tempfile

    import main_torch

    mc_therm, epochs = 2, 2
    with tempfile.TemporaryDirectory() as out:
        args = main_torch.parse_args([
            "--folder", "data/interacting/", "--mc_therm", str(mc_therm),
            "--acc_steps", "1", "--epoch", str(epochs), "--ckpt_every", "1000000",
        ])
        check((args.n, args.dim, args.Emax, args.batch, args.mc_steps, args.depth, args.hutchinson,
               args.laplacian, args.sr) == (N, DIM, EMAX, BATCH, 50, DEPTH, False, "analytic", False),
              "main_torch defaults are not main.py's default line")
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        run = main_torch.train(args, out_folder=out)
        counts = read_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        check(os.path.basename(run["trainer"].path).endswith(
            "_mcstddev_0.10_lr_0.001_batch_2048_ndevices_1_accsteps_1"), "run directory name")
    for row in run["epochs"]:
        emit(dict({"phase": "train_default"}, **row))
        vals = [row[k] for k in ("F", "E", "K", "V", "S", "accept_rate")]
        check(all(math.isfinite(v) for v in vals), "non-finite observable in epoch %d" % row["epoch"])
        check(0.05 < row["accept_rate"] < 0.95, "accept rate %g out of (0.05, 0.95)" % row["accept_rate"])
    check(len(run["epochs"]) == epochs and run["params_changed"], "default line: epochs %s" % run["epochs"])
    expect = 51 * (mc_therm + epochs)
    # the accumulate takes log det(J J^T) from chol_logdet twice, as the
    # Hutchinson line does: the exact term's primal (its Hessian columns are
    # reverse passes over the closed-form rules, no further value) and log Psi
    check(counts["flow_u_jac"] == expect and counts["fused_logp"] == expect
          and counts["chol_logdet"] == 2 * epochs
          and counts["flow_u_jac_d2"] == 0 and counts["flow_u_jac_lap_d2"] == 0,
          "default line launch counters %s, expected %d for flow_u_jac and fused_logp and %d "
          "for chol_logdet" % (counts, expect, 2 * epochs))
    emit({"phase": "train_default", "s_per_epoch_by_phase": {
        k: [r[k + "_s"] for r in run["epochs"]] for k in ("sample", "accumulate", "apply")},
        "peak_GiB": round(peak_gib, 3), "launches": counts})
    return counts, run["trainer"]


def phase_engines(tr, walkers: int = 64, batch: int = 256):
    """Every exact engine on the card against the analytic batched one in
    f64, then one epoch of each newly accepted flag set at batch 256."""
    import copy
    import tempfile

    import main_torch
    from coulombgas_tpu_torch.models.ferminet import ferminet_apply
    from coulombgas_tpu_torch.models.ferminet_jac import (
        ferminet_apply_and_jac, ferminet_apply_jac_lap,
    )
    from coulombgas_tpu_torch.wavefunction.fast_laplacian import (
        make_logpsi_grad_laplacian_analytic,
    )
    from coulombgas_tpu_torch.wavefunction.logpsi import make_logpsi_fast, make_logpsi_grad_laplacian

    si, x, _ = tr.sample_step(tr.van, tr.flow, tr.x, tr.generator)
    si, x = si[:walkers], x[:walkers]
    sp, L = tr.sp_indices, tr.L

    def analytic(**kw):
        return make_logpsi_grad_laplacian_analytic(sp, L, ferminet_apply_jac_lap, hutchinson=False,
                                                   flow_jac=ferminet_apply_and_jac, **kw)

    logpsi = make_logpsi_fast(ferminet_apply_and_jac, sp, L)
    engines = {
        "analytic": analytic(), "analytic_forloop": analytic(forloop=True),
        "ad": make_logpsi_grad_laplacian(logpsi),
        "ad_forloop": make_logpsi_grad_laplacian(logpsi, forloop=True),
        "slow_logp_analytic": make_logpsi_grad_laplacian_analytic(sp, L, hutchinson=False,
                                                                  flow_apply=ferminet_apply),
    }
    flow64 = copy.deepcopy(tr.flow).double()
    res = {}
    for prec, flow, xx in (("f64", flow64, x.double()), ("f32", tr.flow, x)):
        for name, fn in engines.items():
            torch.cuda.synchronize()
            t0 = time.time()
            g, lap = fn(xx, flow, si)
            torch.cuda.synchronize()
            res[prec, name] = (g.to(torch.complex128), lap.to(torch.complex128), time.time() - t0)
    ref_g, ref_lap, _ = res["f64", "analytic"]

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    errors = {}
    for (prec, name), (g, lap, secs) in res.items():
        e = {"grad": rel(g, ref_g), "laplacian": rel(lap, ref_lap), "s": secs,
             "finite": bool(torch.isfinite(torch.view_as_real(lap)).all()
                            and torch.isfinite(torch.view_as_real(g)).all())}
        errors[prec + " " + name] = e
        tol = TOL_ENGINE_F64 if prec == "f64" else TOL_ENGINE_F32
        check(e["finite"] and e["grad"] <= tol and e["laplacian"] <= tol,
              "engine %s %s against the analytic batched engine in f64: %s (tolerance %g)"
              % (prec, name, e, tol))
    emit({"phase": "engines", "walkers": walkers, "reference": "analytic batched, f64",
          "relative_to": "largest |value| over the walkers",
          "tolerance_f64_f32": [TOL_ENGINE_F64, TOL_ENGINE_F32],
          "max_abs_laplacian": float(ref_lap.abs().max()), "errors": errors})

    lines = {
        "laplacian_ad": ["--laplacian", "ad"],
        "laplacian_ad_hutchinson": ["--laplacian", "ad", "--hutchinson"],
        "slow_logp": ["--slow_logp"],
        "forloop_laplacian": ["--forloop_laplacian"],
        "sr_exact_d2": ["--sr", "--sr_solver", "host64", "--mc_d2_kernel", "--acc_d2_kernel"],
        "sr_slow_logp": ["--sr", "--slow_logp"],
    }
    mc_therm, epochs = 1, 1
    sweeps = 51 * (mc_therm + epochs)
    paths = {}
    for name, flags in lines.items():
        with tempfile.TemporaryDirectory() as out:
            args = main_torch.parse_args([
                "--folder", "data/interacting/", "--batch", str(batch), "--mc_therm", str(mc_therm),
                "--acc_steps", "1", "--epoch", str(epochs), "--ckpt_every", "1000000"] + flags)
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.time()
            run = main_torch.train(args, out_folder=out)
            seconds = time.time() - t0
            counts = read_counts()
        check(len(run["epochs"]) == epochs, "%s: epochs %s" % (name, run["epochs"]))
        row = run["epochs"][0]
        vals = [row[k] for k in ("F", "E", "K", "V", "S", "accept_rate")]
        check(all(math.isfinite(v) for v in vals), "%s: non-finite observable" % name)
        check(0.05 < row["accept_rate"] < 0.95, "%s: accept rate %g" % (name, row["accept_rate"]))
        want = dict.fromkeys(counts, 0)
        if args.mc_d2_kernel:
            want.update(flow_u_jac_d2=sweeps, fused_logp=sweeps, flow_u_jac_lap_d2=epochs,
                        chol_logdet=2 * epochs)
        elif not args.slow_logp:
            # log det(J J^T) twice an accumulate, but once under the split
            # Hutchinson engine, whose log|det J| term is jacfwd + slogdet
            want.update(flow_u_jac=sweeps, fused_logp=sweeps,
                        chol_logdet=(1 if args.hutchinson else 2) * epochs)
        check(counts == want, "%s: launch counters %s, expected %s" % (name, counts, want))
        paths[name] = counts
        emit({"phase": "engines", "line": " ".join(flags), "batch": batch, "epoch": row,
              "seconds": seconds, "peak_GiB": round(torch.cuda.max_memory_allocated() / 2**30, 3),
              "launches": counts})
    return paths


def check_scores(tr, si, walkers: int = 32, rows: int = 2):
    """The quantum score matrix on the card (f32, ``vmap(jacrev)``) against
    the same on the CPU in f64, and that against per-walker autograd — an
    independent route to the same rows — on thermalised walkers."""
    import copy

    from coulombgas_tpu_torch.io.convert import ravel_params as ravel
    from coulombgas_tpu_torch.models.ferminet_jac import ferminet_apply_and_jac
    from coulombgas_tpu_torch.wavefunction.logpsi import make_logpsi_fast, make_quantum_score

    logpsi = make_logpsi_fast(ferminet_apply_and_jac, tr.sp_indices, tr.L)
    score = make_quantum_score(logpsi)
    x, s = tr.x[:walkers], si[:walkers]
    S32 = score(x, tr.flow, s).cpu().to(torch.complex128)
    flow64 = copy.deepcopy(tr.flow).to("cpu", torch.float64)
    x64, s64 = x.cpu().double(), s.cpu()
    S64 = score(x64, flow64, s64)
    e_rows = 0.0
    for b in range(rows):
        lp = logpsi(x64[b:b + 1], flow64, s64[b:b + 1])[0]
        parts = [ravel(flow64, list(torch.autograd.grad(lp[c], list(flow64.parameters()),
                                                        retain_graph=True))) for c in (0, 1)]
        e_rows = max(e_rows, float((torch.complex(*parts) - S64[b]).abs().max()))
    rel = (S32 - S64).abs().amax(dim=1) / S64.abs().amax(dim=1)
    out = {"phase": "train_sr", "quantum_score": "f32 on the card vs f64 on the CPU",
           "walkers": walkers, "rel_err_median": float(rel.median()),
           "rel_err_p90": float(rel.quantile(0.9)), "rel_err_max": float(rel.max()),
           "rows_vs_per_walker_autograd_f64": e_rows}
    emit(out)
    check(e_rows <= 1e-8, "quantum score rows differ from per-walker autograd by %g" % e_rows)
    check(out["rel_err_median"] <= 1e-3,
          "quantum score f32 vs f64: median relative error %g" % out["rel_err_median"])


def phase_train_sr():
    """Three epochs of stochastic reconfiguration on the depth-2 closure
    kernels at the default width, through main_torch.py's own functions."""
    import tempfile

    import main_torch
    from coulombgas_tpu_torch.optim.host_sr import host_hybrid_apply
    from coulombgas_tpu_torch.train.train import init_accumulators

    mc_therm, epochs = 2, 3
    with tempfile.TemporaryDirectory() as out:
        args = main_torch.parse_args([
            "--folder", "data/interacting/", "--sr", "--sr_solver", "host64", "--hutchinson",
            "--mc_d2_kernel", "--acc_d2_kernel", "--mc_therm", str(mc_therm),
            "--acc_steps", "1", "--epoch", str(epochs), "--ckpt_every", "1000000",
        ])
        check((args.n, args.dim, args.Emax, args.batch, args.mc_steps, args.depth)
              == (N, DIM, EMAX, BATCH, 50, DEPTH), "main_torch defaults are not the main path's width")
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        run = main_torch.train(args, out_folder=out)
        counts = read_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for row in run["epochs"]:
        emit(dict({"phase": "train_sr"}, **row))
        vals = [row[k] for k in ("F", "E", "K", "V", "S", "accept_rate")]
        check(all(math.isfinite(v) for v in vals), "non-finite observable in SR epoch %d" % row["epoch"])
        check(0.05 < row["accept_rate"] < 0.95, "accept rate %g out of (0.05, 0.95)" % row["accept_rate"])
        check(0 < row["scale_van"] <= 1 and 0 < row["scale_flow"] <= 1,
              "SR trust-region scales (%g, %g) out of (0, 1]" % (row["scale_van"], row["scale_flow"]))
        check(row["gnorm_van"] > 0 and row["gnorm_flow"] > 0,
              "SR curvature g^T F^-1 g (%g, %g) not positive" % (row["gnorm_van"], row["gnorm_flow"]))
    # every Metropolis logp goes flow_u_jac_d2 -> fused_logp; accumulate takes the
    # primal flow from flow_u_jac_lap_d2, and log det(J J^T) from chol_logdet
    # twice: in the Hutchinson term and in the per-sample scores of log Psi
    expect = 51 * (mc_therm + epochs)
    check(counts["flow_u_jac_d2"] == expect and counts["fused_logp"] == expect
          and counts["flow_u_jac"] == 0,
          "SR path launch counters %s, expected %d for flow_u_jac_d2 and fused_logp, 0 for "
          "flow_u_jac" % (counts, expect))
    check(counts["flow_u_jac_lap_d2"] == epochs and counts["chol_logdet"] == 2 * epochs,
          "SR path launch counters %s, expected %d for flow_u_jac_lap_d2 and %d for chol_logdet"
          % (counts, epochs, 2 * epochs))
    tr = run["trainer"]
    params = [*tr.van.parameters(), *tr.flow.parameters()]
    check(run["params_changed"] and all(bool(torch.isfinite(p).all()) for p in params),
          "SR: parameters did not change or are not finite")

    # The plain (f32 LU) solver's step beside host64's on the same accumulators.
    si, tr.x, _ = tr.sample_step(tr.van, tr.flow, tr.x, tr.generator)
    check_scores(tr, si)
    acc = tr.accumulate(tr.van, tr.flow, si, tr.x, tr.generator,
                        init_accumulators(tr.van, tr.flow, sr=True))
    u64 = host_hybrid_apply(acc, 1, args.damping, args.max_norm, van=tr.van, flow=tr.flow)
    before = [ravel_params(tr.van).double(), ravel_params(tr.flow).double()]
    data = tr.apply_update(tr.van, tr.flow, None, acc)
    steps = [ravel_params(m).double() - b for m, b in zip((tr.van, tr.flow), before)]
    rel = [float((s - h).norm() / h.norm()) for s, h in zip(steps, u64[:2])]
    emit({"phase": "train_sr", "solver_comparison": "plain (f32 LU) vs host64 (f64 Cholesky)",
          "rel_step_diff_van": rel[0], "rel_step_diff_flow": rel[1],
          "host64": u64[3], "plain": {k[5:]: float(v) for k, v in data.items() if k.startswith("diag_")},
          "p_van": before[0].numel(), "p_flow": before[1].numel(),
          "peak_GiB": round(peak_gib, 3), "launches_sr_path": counts})
    check(all(math.isfinite(r) for r in rel), "solver comparison is not finite")
    return counts


def phase_train_n57():
    """The n = 57 production recipe through main_torch.py's own functions,
    resumed from a copy of the checked-in epoch-100 checkpoint, then one
    sample step on K4, the depth-2 flow in its carried form."""
    import main_torch

    epochs, acc_steps = 2, 2
    out = os.path.join("runs", "chip_smoke_n57")  # listed in .gitignore; data/ stays unwritten
    shutil.rmtree(out, ignore_errors=True)
    args = main_torch.parse_args([
        "--n", str(N57), "--rs", "1.0", "--Emax", str(EMAX57), "--batch", str(BATCH57),
        "--acc_steps", str(acc_steps), "--sr", "--hutchinson", "--sr_solver", "host64",
        "--tripwire_sigma", "6", "--epoch_finished", "100", "--epoch", str(100 + epochs),
        "--ckpt_every", "1000000", "--folder", N57_FOLDER + os.sep, "--out_folder", out,
    ])
    run_dir = main_torch.run_directory(args, np.array(args.twist), out)
    shutil.copy(os.path.join(N57_FOLDER, N57_RUN, "epoch_000100.pkl"), run_dir)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    run = main_torch.train(args, out_folder=out)
    seconds = time.time() - t0
    counts = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for row in run["epochs"]:
        emit(dict({"phase": "train_n57"}, **row))
        vals = [row[k] for k in ("F", "E", "K", "V", "S", "accept_rate")]
        check(all(math.isfinite(v) for v in vals), "n = 57: non-finite observable in epoch %d" % row["epoch"])
        check(0.05 < row["accept_rate"] < 0.95,
              "n = 57: accept rate %g out of (0.05, 0.95)" % row["accept_rate"])
    check(len(run["epochs"]) + len(run["reverted"]) == epochs, "n = 57: epochs %s" % run["epochs"])
    check(run["params_changed"], "n = 57: parameters did not change")
    # the default route: the carried-state flow kernel and the fused tail;
    # the trainer restored from the checkpoint, so no thermalisation sweeps
    expect = 51 * epochs * acc_steps
    check(counts["flow_u_jac"] == expect and counts["fused_logp"] == expect
          and counts["flow_u_jac_large"] == 0 and counts["chol_logdet"] == 2 * epochs * acc_steps,
          "n = 57 launch counters %s, expected %d for flow_u_jac and fused_logp" % (counts, expect))
    emit({"phase": "train_n57", "seconds": seconds, "peak_GiB": round(peak_gib, 3),
          "tripwire_reverts": run["reverted"], "trust_scale": run["trust_scale"],
          "cuts": {"acc_steps": [16, acc_steps], "epochs": epochs}, "launches": counts})

    # one sample step with K4 behind the Metropolis logp
    tr = run["trainer"]
    logp4 = make_logp_fast(tr.sp_indices, tr.L, use_large_flow=True)
    sample4 = main_torch.make_sample_step(tr.sampler, logp4, args.mc_steps, args.mc_stddev,
                                          tr.L, args.batch)
    reset_counts()
    si, x4, acc4 = sample4(tr.van, tr.flow, tr.x, tr.generator)
    torch.cuda.synchronize()
    counts4 = read_counts()
    check(counts4["flow_u_jac_large"] == 51 and counts4["fused_logp"] == 51
          and counts4["flow_u_jac"] == 0,
          "large-flow sample step launch counters %s, expected 51, 51 and 0 flow_u_jac" % counts4)
    lp4 = logp4(x4, tr.flow, si)
    lp1 = tr.logp(x4, tr.flow, si)
    e_max, e_p99 = max_err(lp4, lp1), p99_err(lp4, lp1)
    check(bool(torch.isfinite(lp4).all()) and e_p99 <= TOL_LOGP and e_max <= TOL_LOGP_MAX,
          "n = 57 logp, K4 vs the default route: p99 %g max %g" % (e_p99, e_max))
    # the two routes' sample steps in turns (default, large, large, default),
    # host clock around a synchronize, on copies of the same walkers
    walls = {"default": [], "use_large_flow": []}
    for name in ("default", "use_large_flow", "use_large_flow", "default"):
        step = tr.sample_step if name == "default" else sample4
        xs = x4.clone()
        torch.cuda.synchronize()
        t0 = time.time()
        step(tr.van, tr.flow, xs, tr.generator)
        torch.cuda.synchronize()
        walls[name].append(time.time() - t0)
    emit({"phase": "train_n57", "route": "use_large_flow", "accept_rate": float(acc4),
          "logp_p99_abs_diff_vs_default_route": e_p99, "logp_max_abs_diff_vs_default_route": e_max,
          "sample_step_wall_s": walls, "launches": counts4})
    shutil.rmtree(out)
    return counts, counts4


def phase_routes(sweeps: int = 10):
    """The Metropolis logp past the kernels' size limits: ``make_logp_fast``
    left to choose, at n = 65, dim 2 (beyond the flow kernel, within the fused
    tail) and at n = 57, dim 3 (nd 171, beyond the fused tail too: the stacked
    Grams through chol_logdet), each with a fresh flow, random walkers and
    occupations, thermalised and then sampled by ``sampling/mcmc.py``.  Held
    against the same logp in plain f64 on the card at the smoke's logp
    tolerances (5e-3 at the 99th percentile, 5e-2 at the maximum); what the
    plain f32 version strays from f64 on the same walkers is reported beside
    it."""
    from coulombgas_tpu_torch.models.ferminet_jac import ferminet_apply_and_jac

    results = {}
    for tag, n, dim, Emax, B, route in (
        ("n65_dim2", 65, 2, 36, 512, "analytic flow Jacobian + fused_logp"),
        ("n57_dim3", 57, 3, 9, 512, "analytic flow Jacobian + stacked chol_logdet"),
    ):
        rng = np.random.default_rng(n)
        L = math.sqrt(math.pi * n) if dim == 2 else (4 / 3 * math.pi * n) ** (1 / 3)
        cfg = FermiNetConfig(DEPTH, SPSIZE, TPSIZE, L)
        flow = init_ferminet_params(cfg, dim, torch.Generator().manual_seed(n), torch.float32, DEV)
        flow64 = init_ferminet_params(cfg, dim, None, torch.float64, DEV)
        flow64.load_state_dict({k: v.double() for k, v in flow.state_dict().items()})
        idx, _ = sp_orbitals(dim, Emax)
        tw, _ = twist_sort(idx, [0.25] * dim)
        tw = tw[::-1].copy()
        si = np.stack([np.sort(rng.choice(len(tw), n, replace=False)) for _ in range(B)])
        si = torch.from_numpy(si).to(DEV)
        x = torch.from_numpy(rng.uniform(0, L, (B, n, dim)).astype(np.float32)).to(DEV)
        logp = make_logp_fast(tw, L)
        name = logp.route(n, dim, cfg, DEV)
        check(name.startswith(route), "%s: route %r, expected %r" % (tag, name, route))
        gen = torch.Generator(DEV).manual_seed(n)
        reset_counts()
        x, _ = mcmc(lambda q: logp(q, flow, si), x, gen, sweeps, 0.1)  # thermalise
        torch.cuda.synchronize()
        t0 = time.time()
        x, acc = mcmc(lambda q: logp(q, flow, si), x, gen, sweeps, 0.1)
        torch.cuda.synchronize()
        sweep_s = (time.time() - t0) / sweeps
        counts = read_counts()
        evals = 2 * (sweeps + 1)
        if dim == 2:
            ok = counts["fused_logp"] == evals and counts["chol_logdet"] == 0
        else:
            ok = counts["fused_logp"] == 0 and counts["chol_logdet"] == 2 * evals
        check(ok and counts["flow_u_jac"] == 0 and counts["flow_u_jac_d2"] == 0,
              "%s: launch counters %s for %d logp evaluations" % (tag, counts, evals))
        check(0.05 < float(acc) < 0.95, "%s: accept rate %g out of (0.05, 0.95)" % (tag, float(acc)))
        with torch.no_grad():
            lp = logp(x, flow, si)
            k32 = (2 * math.pi / L * torch.from_numpy(tw).to(DEV, torch.float32))[si]
            u32, J32 = ferminet_apply_and_jac(flow, x)
            lp32 = cuda_fused_logp.fused_logp_plain(u32, k32, J32, L)
            u64, J64 = ferminet_apply_and_jac(flow64, x.double())
            lp64 = cuda_fused_logp.fused_logp_plain(u64, k32.double(), J64, L)
            ms = time_ms(lambda: logp(x, flow, si), 10)
        e = {"max_abs_err_f64": max_err(lp, lp64), "p99_abs_err_f64": p99_err(lp, lp64),
             "plain_f32_vs_f64_max": max_err(lp32, lp64), "plain_f32_vs_f64_p99": p99_err(lp32, lp64)}
        check(bool(torch.isfinite(lp).all()) and e["max_abs_err_f64"] <= TOL_LOGP_MAX
              and e["p99_abs_err_f64"] <= TOL_LOGP, "%s: logp vs plain f64: %s" % (tag, e))
        results[tag] = counts
        emit({"phase": "routes", "case": tag, "n": n, "dim": dim, "batch": B, "route": name,
              "accept_rate": float(acc), "sweeps": sweeps, "logp_ms": ms, "sweep_s": sweep_s,
              "errors": e, "tolerance_max_p99": [TOL_LOGP_MAX, TOL_LOGP], "launches": counts})
    return results


def phase_pretrain(epochs: int = 20):
    """The free-fermion pretraining on the card, with main_torch.py's settings."""
    import main_torch
    from coulombgas_tpu_torch.analytic.canonical import Z_E
    from coulombgas_tpu_torch.models.transformer import TransformerConfig, init_transformer_params
    from coulombgas_tpu_torch.train.pretrain import pretrain

    n, Emax, batch = 13, 25, 8192
    t0 = time.time()
    F_exact = float(Z_E(n, DIM, 0.15, [0.25, 0.25], Emax, dps=600)[0])
    oracle_s = time.time() - t0
    van = init_transformer_params(TransformerConfig(sp_orbitals(DIM, Emax)[1].size, 2, 16, 4, 32),
                                  DIM, torch.Generator().manual_seed(0), torch.float32, DEV)
    path = os.path.join("runs", "chip_smoke_pretrain")
    shutil.rmtree(path, ignore_errors=True)
    t0 = time.time()
    pretrain(van, n, DIM, 0.15, Emax, np.array([0.25, 0.25]), path,
             torch.Generator(DEV).manual_seed(0), main_torch.PRE_LR, main_torch.PRE_SR,
             main_torch.PRE_DAMPING, main_torch.PRE_MAXNORM, batch, epoch=epochs,
             check_analytic=False)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    rows = np.loadtxt(os.path.join(path, "data.txt"), ndmin=2)
    shutil.rmtree(path)
    check(rows.shape[1] == 7 and np.isfinite(rows).all() and len(rows) >= epochs // 2,
          "pretrain: data.txt rows %s" % (rows.shape,))
    check(rows[-1, 1] < rows[0, 1], "pretrain: F did not fall (%g -> %g)" % (rows[0, 1], rows[-1, 1]))
    emit({"phase": "pretrain", "n": n, "Emax": Emax, "batch": batch, "epochs": epochs,
          "logged_epochs": len(rows), "F_first": rows[0, 1], "F_last": rows[-1, 1],
          "F_last_stderr": rows[-1, 2], "F_exact": F_exact, "S_last": rows[-1, 5],
          "seconds": seconds, "s_per_epoch": seconds / epochs, "oracle_s": oracle_s})


# --num_devices 1: the default 0 is every visible GPU; the two-rank runs of
# (b) give 2 after it
DIST_LINE = ["--folder", "data/interacting/", "--sr", "--hutchinson", "--mc_therm", "2",
             "--acc_steps", "1", "--epoch", "2", "--ckpt_every", "2", "--num_devices", "1"]


def _run_all(cmds, timeout=600, envs=None):
    """Start every command at once (command i with ``envs[i]`` added to its
    environment where given); wait for all; return (exit codes, outputs,
    seconds).  Every process started here is stopped here."""
    t0 = time.time()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=dict(os.environ, **(envs[i] if envs else {})))
             for i, c in enumerate(cmds)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs, time.time() - t0


def _checked(rcs, outs, what):
    for r, (rc, out) in enumerate(zip(rcs, outs)):
        if rc != 0:
            print(out[-6000:], flush=True)
        check(rc == 0, "%s: process %d exited with %d" % (what, r, rc))


def _checksums(outs):
    """Every ``final params checksum:`` in ``outs``.  Searched anywhere in a
    line: ranks that share a pipe write whole lines from Python, but a
    library's log line written to stderr in pieces may start before one."""
    return [m for out in outs for m in re.findall(r"final params checksum: ([0-9a-f]{64})", out)]


def _same_checksums(outs, ranks, what):
    """The one checksum of ``ranks`` ranks, after checking that every rank
    printed it; the processes' output ends are printed if not."""
    sums = _checksums(outs)
    if len(sums) != ranks or len(set(sums)) != 1:
        for out in outs:
            print(out[-6000:], flush=True)
    check(len(sums) == ranks and len(set(sums)) == 1,
          "%s: the ranks' checksums differ: %s" % (what, sums))
    return sums[0]


def _rows(folder):
    runs = [d for d in os.listdir(folder) if d.startswith("n_29_")]
    check(len(runs) == 1, "dist: run directories %s under %s" % (runs, folder))
    with open(os.path.join(folder, runs[0], "data.txt")) as f:
        return runs[0], f.read().splitlines()


def dist_step(argv, ckpt, si, v, out_folder, rounds: int = 1):
    """One accumulate and apply of main_torch.py with ``argv`` on this
    rank's share of the global batch: the walkers and parameters of the
    checkpoint ``ckpt``, the occupations ``si`` and Hutchinson probe ``v``.
    With ``rounds`` > 1 the accumulate runs that often on fresh accumulators
    (on the SR route the first captures its graph part, the next replay it),
    and the last is reduced and applied."""
    import main_torch
    from coulombgas_tpu_torch.io.checkpoint import to_host
    from coulombgas_tpu_torch.io.convert import flow_to_numpy, van_to_numpy
    from coulombgas_tpu_torch.parallel import mesh
    from coulombgas_tpu_torch.train.train import (
        accumulate_graph, init_accumulators, reduce_accumulators,
    )

    args = main_torch.parse_args(argv)
    tr = main_torch.build_trainer(args, out_folder)
    state = load_data(ckpt)
    van_from_numpy(state["params_van"], tr.van)
    flow_from_numpy(state["params_flow"], tr.flow)
    # the checkpoint's first len(si) walkers are the global batch
    x, si, v = (torch.as_tensor(mesh.shard_batch(a)).to(tr.device)
                for a in (state["x"][:len(si)], si, v))
    before = dict(accumulate_graph)
    for _ in range(rounds):
        acc = tr.accumulate(tr.van, tr.flow, si.long(), x.to(torch.float32), None,
                            init_accumulators(tr.van, tr.flow, sr=args.sr), v=v.to(torch.float32))
    acc, _ = reduce_accumulators(acc)
    reduced = to_host(acc)
    d, _ = main_torch.apply_step(tr, acc, 1, {})
    return {"d": d, "acc": reduced, "van": van_to_numpy(tr.van), "flow": flow_to_numpy(tr.flow),
            "accumulate_graph": {k: accumulate_graph[k] - before[k] for k in before}}


def dist_rank_main(rank: int, world: int, port: int, job: str):
    """``python3 chip_smoke.py --dist_rank R W PORT JOB``: rank R of W for
    the dist phase's shared-batch step; rank 0 writes the result."""
    import pickle

    from coulombgas_tpu_torch.parallel import mesh

    with open(job, "rb") as f:
        spec = pickle.load(f)
    grid = mesh.make_mesh("tcp://localhost:%d" % port, rank, world,
                          torch.device("cuda", rank % torch.cuda.device_count()))
    try:
        res = dist_step(spec["argv"], spec["ckpt"], spec["si"], spec["v"], spec["out"],
                        spec.get("rounds", 1))
    finally:
        mesh.destroy()
    res["backend"] = grid.backend
    if rank == 0:
        with open(job + ".out", "wb") as f:
            pickle.dump(res, f)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def compare_dist_step(ranks, one, names) -> dict:
    """The dist phase's shared-batch step in two ranks (``ranks``) against
    one process (``one``), each a result of ``dist_step``; ``names`` the
    parameter names of the VAN and the flow in module order."""
    from coulombgas_tpu_torch.io.convert import flatten_tree

    obs = max(abs(ranks["d"][k] - one["d"][k]) / max(abs(one["d"][k]), 1e-30)
              for k in one["d"])
    flat, flat_one = flatten_tree(ranks["acc"]), flatten_tree(one["acc"])
    groups = {}
    for k in flat_one:  # one vector per accumulator and module
        groups.setdefault(k if k.startswith("data.") else k.rsplit(".", 1)[0], []).append(k)
    acc = {g: _rel(np.concatenate([np.ravel(flat[k]) for k in ks]),
                   np.concatenate([np.ravel(flat_one[k]) for k in ks]))
           for g, ks in groups.items()}
    tensors = {k: _rel(flat[k], flat_one[k]) for k in flat_one if not k.startswith("data.")}

    def adam_gradient(f):  # what Adam is given: the baseline-corrected gradient
        return {"%s.%s" % (mod, name): np.asarray(
                    f["grads.%d.%d" % (i, j)] - f["data." + base] * f["%s.%d" % (sc, j)],
                    np.float64)
                for i, (mod, base, sc) in enumerate((("van", "F_mean", "classical_score"),
                                                     ("flow", "E_mean", "quantum_score")))
                for j, name in enumerate(names[i])}

    g, g_one = adam_gradient(flat), adam_gradient(flat_one)
    p, p_one = (flatten_tree({"van": r["van"], "flow": r["flow"]}) for r in (ranks, one))
    held = {k: np.abs(g[k] - g_one[k]) <= 1e-2 * np.abs(g_one[k]) for k in g_one}
    param = max(float(np.abs(np.asarray(p[k], np.float64) - p_one[k])[held[k]].max(initial=0))
                for k in p_one)
    undetermined = sum(int((~h).sum()) for h in held.values())
    return {"observables_max_rel_err": obs, "accumulators_max_rel_err": max(acc.values()),
            "accumulators_rel_err": acc,
            "tensors_rel_err_over_tol": {k: v for k, v in tensors.items() if v > TOL_DIST_ACC},
            "params_max_abs_err_where_gradient_determined": param,
            "params_undetermined": [undetermined, sum(h.size for h in held.values())],
            "params_max_abs_err_all": max(float(np.abs(np.asarray(p[k], np.float64)
                                                       - p_one[k]).max()) for k in p_one),
            "tolerances": [TOL_DIST_OBS, TOL_DIST_ACC, TOL_DIST_PARAM, TOL_DIST_UNDETERMINED]}


def _free_slurm_job() -> int:
    """A SLURM job id whose coordinator port (61440 + id mod 4096, as
    ``main_torch.cluster_environment`` and JAX derive it) is free now."""
    import socket

    for job in range(4096):
        with socket.socket() as s:
            try:
                s.bind(("localhost", 61440 + job))
            except OSError:
                continue
        return job
    raise RuntimeError("no free port in 61440-65535")


def _shared_batch_step(tmp, name, argv, ckpt, si, v, names, rounds: int = 1,
                       params: bool = True):
    """(c)'s check for ``argv``: one accumulate and apply on one shared
    global batch in two ranks against one process (``rounds`` as
    ``dist_step`` takes it); returns the comparison and the seconds of both.
    Without ``params`` the parameters after the apply are reported, not held
    to ``TOL_DIST_PARAM`` (an SR step is a solve that magnifies the
    accumulators' rounding)."""
    import pickle

    import main_torch

    t0 = time.time()
    one = dist_step(argv, ckpt, si, v, os.path.join(tmp, name + "_one"), rounds)
    seconds = {"one_process_step": time.time() - t0}
    job = os.path.join(tmp, name + "_job.pkl")
    with open(job, "wb") as f:
        pickle.dump({"argv": argv, "ckpt": ckpt, "si": si, "v": v, "rounds": rounds,
                     "out": os.path.join(tmp, name + "_ranks")}, f)
    port = main_torch.free_port()
    rcs, outs, seconds["two_rank_step"] = _run_all([
        [sys.executable, "chip_smoke.py", "--dist_rank", str(r), "2", str(port), job]
        for r in range(2)])
    _checked(rcs, outs, "dist %s" % name)
    with open(job + ".out", "rb") as f:
        ranks = pickle.load(f)
    out = compare_dist_step(ranks, one, names)
    out["backend"], out["seconds"] = ranks["backend"], seconds
    out["accumulate_graph"] = {"ranks": ranks["accumulate_graph"],
                               "one_process": one["accumulate_graph"]}
    obs, acc = out["observables_max_rel_err"], out["accumulators_rel_err"]
    param = out["params_max_abs_err_where_gradient_determined"]
    check(obs <= TOL_DIST_OBS, "dist %s: observables differ by %g" % (name, obs))
    check(max(acc.values()) <= TOL_DIST_ACC, "dist %s: accumulators differ: %s" % (name, acc))
    check(param <= TOL_DIST_PARAM or not params,
          "dist %s: parameters differ by %g" % (name, param))
    undetermined, entries = out["params_undetermined"]
    check(undetermined <= TOL_DIST_UNDETERMINED * entries or not params,
          "dist %s: the gradient is undetermined in %d of %d entries"
          % (name, undetermined, entries))
    return out


def phase_dist():
    """Data parallelism through main_torch.py's entry points: a world of one
    under NCCL against no group, two ranks, four ranks in sub-groups of two
    where the machine has four cards, one shared-batch step in two ranks
    against one process, a microbatch chunk straddling the two ranks'
    shares, and two ranks that read their layout from a SLURM job's
    environment."""
    import tempfile

    import main_torch

    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    me = [sys.executable, "main_torch.py", *DIST_LINE]
    seconds = {}
    with tempfile.TemporaryDirectory() as tmp:
        alone, world1, two = (os.path.join(tmp, k) for k in ("alone", "world1", "two"))
        # (a) a world of one under NCCL, and the same run without a group
        rcs, outs, seconds["no_group_and_world_1"] = _run_all([
            me + ["--out_folder", alone],
            me + ["--out_folder", world1, "--multihost", "--coordinator",
                  "localhost:%d" % main_torch.free_port(), "--num_processes", "1",
                  "--process_id", "0"]])
        _checked(rcs, outs, "dist (a)")
        check("rank 0 of 1 (nccl)" in outs[1], "dist (a): the world of one is not under NCCL")
        name_a, rows_a = _rows(alone)
        name_1, rows_1 = _rows(world1)
        sums_a = _checksums(outs)
        check(name_a == name_1 and name_a.endswith("_ndevices_1_accsteps_1"),
              "dist (a): run directories %s, %s" % (name_a, name_1))
        check(len(rows_a) == 2 and rows_a == rows_1 and len(sums_a) == 2
              and sums_a[0] == sums_a[1],
              "dist (a): the world of one differs from no group: %s / %s, %s"
              % (rows_a, rows_1, sums_a))
        emit({"phase": "dist", "case": "world_1", "backend": "nccl", "world_size": 1,
              "rows_equal": True, "checksum_equal": True, "checksum": sums_a[0],
              "seconds": seconds["no_group_and_world_1"]})

        # (b) two ranks: NCCL on two cards, gloo for two ranks on one card
        if cards >= 2:
            cmds = [me + ["--out_folder", two, "--num_devices", "2"]]
        else:
            port = main_torch.free_port()
            cmds = [me + ["--out_folder", two, "--num_devices", "2", "--multihost",
                          "--coordinator", "localhost:%d" % port, "--num_processes", "2",
                          "--process_id", str(r)]
                    for r in range(2)]
        rcs, outs, seconds["two_ranks"] = _run_all(cmds)
        _checked(rcs, outs, "dist (b)")
        outs_b = outs
        text = "\n".join(outs)
        backend = "nccl" if "rank 1 of 2 (nccl)" in text else "gloo"
        check("rank 0 of 2 (%s)" % backend in text and "rank 1 of 2 (%s)" % backend in text,
              "dist (b): the two ranks did not both join")
        name_b, rows_b = _rows(two)
        data = np.array([r.split() for r in rows_b], float)
        _same_checksums(outs, 2, "dist (b)")
        check(name_b.endswith("_batch_2048_ndevices_2_accsteps_1") and data.shape == (2, 12)
              and np.isfinite(data).all() and ((data[:, 11] > 0.05) & (data[:, 11] < 0.95)).all(),
              "dist (b): run directory %s, rows %s" % (name_b, rows_b))
        emit({"phase": "dist", "case": "two_ranks", "backend": backend, "world_size": 2,
              "cards": cards, "rows": rows_b, "checksums_equal": True,
              "seconds": seconds["two_ranks"]})

        if cards >= 4:
            # (d) four ranks, microbatch chunks of two ranks: NCCL sub-groups
            four = os.path.join(tmp, "four")
            rcs, outs, seconds["four_ranks_subgroups"] = _run_all(
                [me + ["--out_folder", four, "--num_devices", "4", "--microbatch", "1024"]])
            _checked(rcs, outs, "dist (d)")
            name_d, rows_d = _rows(four)
            data = np.array([r.split() for r in rows_d], float)
            check("rank 3 of 4 (nccl)" in outs[0] and name_d.endswith("_ndevices_4_accsteps_1")
                  and data.shape == (2, 12) and np.isfinite(data).all(),
                  "dist (d): run directory %s, rows %s" % (name_d, rows_d))
            _same_checksums(outs, 4, "dist (d)")
            joined = [ln for ln in outs[0].splitlines() if "final params checksum:" in ln
                      and not ln.startswith("final params checksum:")]
            emit({"phase": "dist", "case": "four_ranks_subgroups", "backend": "nccl",
                  "world_size": 4, "microbatch": 1024, "rows": rows_d,
                  "checksums_equal": True, "checksum_lines_joined": joined,
                  "seconds": seconds["four_ranks_subgroups"]})

        # (c) one Adam step on one shared global batch: two ranks against one
        argv = ["--folder", "data/interacting/", "--hutchinson", "--acc_steps", "1"]
        ckpt = os.path.join(alone, name_a, "epoch_000002.pkl")
        tr = main_torch.build_trainer(main_torch.parse_args(argv), os.path.join(tmp, "one"))
        van_from_numpy(load_data(ckpt)["params_van"], tr.van)
        gen = torch.Generator(device=DEV).manual_seed(5)
        si = tr.sampler(tr.van, gen, BATCH).cpu().numpy()
        v = torch.randn(BATCH, N, DIM, generator=gen, device=DEV).cpu().numpy()
        names = [[k for k, _ in m.named_parameters()] for m in (tr.van, tr.flow)]
        del tr
        out = _shared_batch_step(tmp, "(c)", argv, ckpt, si, v, names)
        seconds.update(out.pop("seconds"))
        emit(dict({"phase": "dist", "case": "shared_batch_step", "optimizer": "adam",
                   "world_size": 2, "dtype": "float32",
                   "seconds": {k: seconds[k] for k in ("one_process_step", "two_rank_step")}},
                  **out))

        # (e) a microbatch chunk straddling the ranks' shares: batch 1536 in
        # shares of 768, chunks of 512, chunk 1 = walkers 512-1023 of both;
        # and (f) two ranks reading their layout from a SLURM job's
        # environment, no --coordinator: (b)'s layout, so (b)'s rows
        straddle, slurm = os.path.join(tmp, "straddle"), os.path.join(tmp, "slurm")
        flags_e = ["--batch", "1536", "--microbatch", "512"]
        if cards >= 2:
            cmds = [me + ["--out_folder", straddle, "--num_devices", "2", *flags_e]]
            envs = [{}]
        else:
            port = main_torch.free_port()
            cmds = [me + ["--out_folder", straddle, "--num_devices", "2", *flags_e,
                          "--multihost", "--coordinator", "localhost:%d" % port,
                          "--num_processes", "2", "--process_id", str(r)] for r in range(2)]
            envs = [{}, {}]
        job = str(_free_slurm_job())
        cmds += [me + ["--out_folder", slurm, "--num_devices", "2", "--multihost"]
                 for r in range(2)]
        envs += [{"SLURM_JOB_ID": job, "SLURM_STEP_NODELIST": "localhost", "SLURM_NTASKS": "2",
                  "SLURM_PROCID": str(r), "SLURM_LOCALID": str(r)} for r in range(2)]
        rcs, outs, seconds["straddle_and_slurm"] = _run_all(cmds, envs=envs)
        n_e = len(cmds) - 2
        _checked(rcs[:n_e], outs[:n_e], "dist (e)")
        _checked(rcs[n_e:], outs[n_e:], "dist (f)")
        name_e, rows_e = _rows(straddle)
        data = np.array([r.split() for r in rows_e], float)
        _same_checksums(outs[:n_e], 2, "dist (e)")
        check(name_e.endswith("_batch_1536_ndevices_2_accsteps_1") and data.shape == (2, 12)
              and np.isfinite(data).all() and ((data[:, 11] > 0.05) & (data[:, 11] < 0.95)).all(),
              "dist (e): run directory %s, rows %s" % (name_e, rows_e))
        emit({"phase": "dist", "case": "straddling_chunk", "backend": backend, "world_size": 2,
              "batch": 1536, "microbatch": 512, "rows": rows_e, "checksums_equal": True,
              "seconds": seconds["straddle_and_slurm"]})
        name_f, rows_f = _rows(slurm)
        text = "\n".join(outs[n_e:])
        sum_f = _same_checksums(outs[n_e:], 2, "dist (f)")
        check("rank 1 of 2 (%s)" % backend in text and name_f == name_b and rows_f == rows_b
              and sum_f == _checksums(outs_b)[0],
              "dist (f): the SLURM job's run %s, rows %s differ from (b)'s %s, %s"
              % (name_f, rows_f, name_b, rows_b))
        emit({"phase": "dist", "case": "slurm_environment", "backend": backend,
              "world_size": 2, "rows_equal_to_two_ranks": True, "checksum": sum_f,
              "seconds": seconds["straddle_and_slurm"]})

        # (e)'s shared-batch step: the chunks of 512 of the first 1536
        # walkers, in two ranks against one process with that microbatch
        out = _shared_batch_step(tmp, "(e)", argv + flags_e, ckpt, si[:1536], v[:1536], names)
        seconds.update({k + "_straddling": t for k, t in out.pop("seconds").items()})
        emit(dict({"phase": "dist", "case": "shared_batch_step_straddling_chunk",
                   "optimizer": "adam", "world_size": 2, "dtype": "float32", "batch": 1536,
                   "microbatch": 512}, **out))
    emit({"phase": "dist", "seconds_by_phase": seconds})


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--dist_rank":
        rank, world, port = (int(a) for a in sys.argv[2:5])
        dist_rank_main(rank, world, port, sys.argv[5])
        return
    if sys.argv[1:] == ["--sample_graph_only"]:
        # the sample step's CUDA graph alone
        smi = phase_device()
        phase_sample_graph()
        print(smi, flush=True)
        return
    if sys.argv[1:] == ["--accumulate_graph_only"]:
        # the SR accumulate's CUDA graph alone
        smi = phase_device()
        phase_accumulate_graph()
        print(smi, flush=True)
        return
    if sys.argv[1:] == ["--dist_only"]:
        # the dist phase alone, for a machine with several cards
        smi = phase_device()
        phase_dist()
        print(smi, flush=True)
        return
    t0 = time.time()
    smi = phase_device()
    phase_build()
    rows = phase_kernels()
    counts = phase_train()
    phase_sample_graph()
    phase_accumulate_graph()
    counts_default, tr_default = phase_train_default()
    counts_engines = phase_engines(tr_default)
    del tr_default
    counts_sr = phase_train_sr()
    counts_n57, counts_k4 = phase_train_n57()
    counts_routes = phase_routes()
    phase_pretrain()
    phase_dist()
    paths = {"default": counts_default, "adam": counts, "sr": counts_sr,
             **{"engines_" + k: c for k, c in counts_engines.items()}, "n57": counts_n57, "n57_large_flow_step": counts_k4,
             **{"route_" + k: c for k, c in counts_routes.items()}}
    for row in rows:
        # each kernel's count on the path that runs it: the carried-state flow
        # kernel and the log-det kernels on main.py's default line (Adam, the
        # exact Laplacian), the depth-2 closure kernels on the SR path,
        # K4 on the large-flow sample step
        row["launches"] = next((c[row["name"]] for c in paths.values() if c[row["name"]]), 0)
        row["launches_by_path"] = {k: c[row["name"]] for k, c in paths.items()}
        check(row["launches"] > 0, "kernel %s was not launched on a main path" % row["name"])
    emit({"phase": "done", "seconds": round(time.time() - t0, 1)})
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
