"""Time and device memory of the exact Laplacian of 1/2 log|det J| on the GPU.

    python3 scripts/probe_exact_laplacian_torch.py [--n 29] [--batch 2048] [--chunks 1 4 8]

Builds a fresh depth-2 flow (widths 16, seed 0) and uniform walkers at the
given (n, batch), dim 2, and times:

  * the analytic engine of ``wavefunction/fast_laplacian.py`` as the
    accumulate calls it, with the Hutchinson estimate and with the exact
    trace of the Hessian (``logpsi.COLUMNS_PER_PASS`` basis vectors a pass);
  * the exact term 1/4 log det(J J^T) alone, by the engine's
    reverse-over-reverse passes (``logpsi.coordinate_derivatives``) at each
    count of basis vectors a pass in ``--chunks``;
  * the same term by forward-over-reverse, as the JAX package takes it:
    ``vmap`` over a chunk of basis tangents of ``jvp`` of ``grad``, through
    copies of the package's closed-form log-det rules that also carry
    forward-mode (``jvp``) rules.

Each variant runs once to warm up and then ``--reps`` times; one JSON line
each with the seconds a call (host clock around a synchronize), the peak
device memory of the call above its inputs, and the largest difference of its
Laplacian from the first variant of its kind.  The first line is the card's
name and power limit.  Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from coulombgas_tpu_torch.models.ferminet import FermiNetConfig, init_ferminet_params  # noqa: E402
from coulombgas_tpu_torch.models.ferminet_jac import (  # noqa: E402
    ferminet_apply_and_jac, ferminet_apply_jac_lap,
)
from coulombgas_tpu_torch.ops.logdet import (  # noqa: E402
    chol_logdet, gj_inverse_single, logdet_spd_single,
)
from coulombgas_tpu_torch.physics.orbitals import sp_orbitals, twist_sort  # noqa: E402
from coulombgas_tpu_torch.wavefunction import logpsi as logpsi_mod  # noqa: E402
from coulombgas_tpu_torch.wavefunction.fast_laplacian import (  # noqa: E402
    make_logpsi_grad_laplacian_analytic,
)


class _InverseFwd(torch.autograd.Function):
    """``ops.logdet._SpdInverse`` with a forward-mode rule beside its reverse one."""
    generate_vmap_rule = True

    @staticmethod
    def forward(A):
        return gj_inverse_single(A)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)
        ctx.save_for_forward(output)

    @staticmethod
    def backward(ctx, grad):
        (inv,) = ctx.saved_tensors
        invT = inv.transpose(-1, -2)
        return -(invT @ grad @ invT)

    @staticmethod
    def jvp(ctx, A_t):
        (inv,) = ctx.saved_tensors
        return -(inv @ A_t @ inv)


class _LogdetFwd(torch.autograd.Function):
    """``ops.logdet._LogdetSpd`` (value from ``chol_logdet``: K3 on the card)
    with a forward-mode rule, tr(A^-1 dA)."""
    generate_vmap_rule = True

    @staticmethod
    def forward(A):
        return chol_logdet(A.reshape(-1, *A.shape[-2:])).reshape(A.shape[:-2])

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])
        ctx.save_for_forward(inputs[0])

    @staticmethod
    def backward(ctx, grad):
        (A,) = ctx.saved_tensors
        return grad[..., None, None] * _InverseFwd.apply(A)

    @staticmethod
    def jvp(ctx, A_t):
        (A,) = ctx.saved_tensors
        return (_InverseFwd.apply(A).transpose(-1, -2) * A_t).sum(dim=(-2, -1))


def logjacdet_term(flow, x, logdet):
    """1/2 log|det J| = 1/4 log det(J J^T) per walker (B,)."""
    _, J = ferminet_apply_and_jac(flow, x)
    return 0.25 * logdet(J @ J.transpose(-1, -2))


def reverse_over_reverse(flow, x, k):
    logpsi_mod.COLUMNS_PER_PASS = k
    f = lambda q: logjacdet_term(flow, q, logdet_spd_single)[:, None]  # noqa: E731
    return logpsi_mod.coordinate_derivatives(f, x)[1][:, 0]


def forward_over_reverse(flow, x, k):
    B, n, dim = x.shape
    nd = n * dim
    grad = torch.func.grad(lambda q: logjacdet_term(flow, q, _LogdetFwd.apply).sum())
    column = lambda e: torch.func.jvp(grad, (x,), (e,))[1]  # noqa: E731
    eye = torch.eye(nd, dtype=x.dtype, device=x.device)
    lap = x.new_zeros(B)
    for s in range(0, nd, k):  # torch.func.grad differentiates under an outer no_grad
        cols = eye[s:s + k]  # (k, nd), the same tangent for every walker
        t = torch.func.vmap(column)(cols[:, None, :].expand(-1, B, -1).reshape(-1, B, n, dim))
        lap += (t.reshape(-1, B, nd) * cols[:, None, :]).sum(dim=(0, 2))
    return lap


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=29)
    parser.add_argument("--batch", type=int, default=2048)
    parser.add_argument("--chunks", type=int, nargs="*", default=[1, 4, 8])
    parser.add_argument("--reps", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("probe_exact_laplacian_torch.py needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)

    dev = torch.device("cuda")
    n, dim, B = args.n, 2, args.batch
    L = float(np.sqrt(np.pi * n))
    flow = init_ferminet_params(FermiNetConfig(2, 16, 16, L), dim,
                                torch.Generator().manual_seed(0), torch.float32, dev)
    idx, _ = sp_orbitals(dim, 25)
    sp, _ = twist_sort(idx, [0.25, 0.25])
    sp = sp[::-1].copy()
    rng = np.random.default_rng(0)
    si = torch.from_numpy(np.stack([np.sort(rng.choice(len(sp), n, replace=False))
                                    for _ in range(B)])).to(dev)
    x = torch.from_numpy(rng.uniform(0, L, (B, n, dim)).astype(np.float32)).to(dev)
    v = torch.randn(x.shape, generator=torch.Generator(dev).manual_seed(1), device=dev)

    shipped = logpsi_mod.COLUMNS_PER_PASS

    def engine(hutchinson):
        fn = make_logpsi_grad_laplacian_analytic(sp, L, ferminet_apply_jac_lap,
                                                 hutchinson=hutchinson,
                                                 flow_jac=ferminet_apply_and_jac)

        def call():
            logpsi_mod.COLUMNS_PER_PASS = shipped
            return fn(x, flow, si, v=v)[1]
        return call

    variants = [("hutchinson", "engine hutchinson", engine(True)),
                ("exact", "engine exact, %d a pass" % shipped, engine(False))]
    for kind, fn in (("term rev-over-rev", reverse_over_reverse),
                     ("term fwd-over-rev", forward_over_reverse)):
        variants += [("term", "%s, %d a pass" % (kind, k),
                      lambda fn=fn, k=k: fn(flow, x, k)) for k in args.chunks]
    first = {}
    for kind, name, call in variants:
        with torch.no_grad():
            call()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            secs = []
            for _ in range(args.reps):
                t0 = time.time()
                lap = call()
                torch.cuda.synchronize()
                secs.append(time.time() - t0)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        row = {"variant": name, "n": n, "batch": B, "s_per_call": secs,
               "peak_GiB_above_inputs": round(peak, 3), "finite": bool(torch.isfinite(lap).all())}
        ref = first.setdefault(kind, lap)
        row["max_abs_diff_vs_first_of_kind"] = float((lap - ref).abs().max())
        row["max_abs_lap"] = float(lap.abs().max())
        print(json.dumps(row), flush=True)
    logpsi_mod.COLUMNS_PER_PASS = shipped


if __name__ == "__main__":
    main()
