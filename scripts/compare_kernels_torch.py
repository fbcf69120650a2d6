"""Times two versions of the Metropolis logp kernels K1 and K2 in turns on one GPU.

    python3 scripts/compare_kernels_torch.py --other DIR [--out FILE]

DIR holds the other version's ``flow_jac.cu``, ``fused_logp.cu`` and
``chol.cuh`` (for example written there by ``git show
<commit>:coulombgas_tpu_torch/csrc/<file>``).  Both versions are built with
the same ``nvcc`` flags, the package's into ``build/`` and the other into
``build/other/``, all sources in parallel.  At the two shapes the main paths
run — n = 29, batch 2048 (``chip_smoke.make_inputs``) and n = 57, batch 512
on the checked-in checkpoint's weights and walkers (``chip_smoke.load_n57``)
— each kernel is timed in the order other, this, this, other (median of 20
launches by CUDA events each), and the two versions' outputs on the same
inputs are compared.  Prints one JSON line per shape and kernel, and the
``nvidia-smi`` name and power limit; ``--out`` also writes them to a file.
A flow source of the earlier two-launch design (a separate forward kernel
joined to the Jacobian kernel by a ``sig`` scratch, one more pointer in
``cg_flow_u_jac``) is called with that scratch; the branch is kept so that
the one-launch K1 can be timed against that design.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from coulombgas_tpu_torch.ops import _build, cuda_flow_jac, cuda_fused_logp  # noqa: E402


def build_other(src_dir: str) -> dict:
    """Build the other version's two libraries; returns their ctypes handles
    and ptxas lines."""
    out_dir = os.path.join(_build.BUILD_DIR, "other")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in ("flow_jac", "fused_logp"):
        cmd = _build._command(name)
        cmd[cmd.index("-o") + 1] = os.path.join(out_dir, "lib%s.so" % name)
        cmd[-1] = os.path.join(src_dir, name + ".cu")
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    _build.build_all(("flow_jac", "fused_logp"), force=True)
    libs, ptxas = {}, {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for the other %s:\n%s" % (name, log))
        ptxas[name] = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        libs[name] = ctypes.CDLL(os.path.join(out_dir, "lib%s.so" % name))
    with open(os.path.join(src_dir, "flow_jac.cu")) as f:
        takes_sig = "cg_flow_fwd_kernel" in f.read()  # the two-launch design
    f = libs["flow_jac"].cg_flow_u_jac
    f.argtypes = [ctypes.c_void_p] * (5 if takes_sig else 4) + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    f.restype = ctypes.c_int
    g = libs["fused_logp"].cg_fused_logp
    g.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    g.restype = ctypes.c_int
    return {"flow": f, "fused": g, "takes_sig": takes_sig, "ptxas": ptxas}


def other_flow(lib, flow, x):
    B, n, dim = x.shape
    cfg = flow.cfg
    params = cuda_flow_jac.pack_flow_params(flow)
    u = torch.empty_like(x)
    J = torch.empty(B, n * dim, n * dim, device=x.device)
    ptrs = [x.data_ptr(), params.data_ptr()]
    if lib["takes_sig"]:
        sig = torch.empty(B, cfg.depth, n, cfg.spsize, device=x.device)
        ptrs.append(sig.data_ptr())
    code = lib["flow"](*ptrs, u.data_ptr(), J.data_ptr(), B, n, dim, cfg.depth, cfg.spsize,
                       cfg.tpsize, float(cfg.L), torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, "other flow_u_jac")
    return u, J


def other_fused(lib, u, kvec, J, L):
    B, n, dim = u.shape
    out = torch.empty(B, device=u.device)
    code = lib["fused"](u.data_ptr(), kvec.data_ptr(), J.data_ptr(), out.data_ptr(), B, n, dim,
                        float(L) ** (-dim / 2), torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, "other fused_logp")
    return out


def turns(fn_other, fn_this, reps: int = 20) -> dict:
    ms = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        ms[who].append(cs.time_ms(fn_other if who == "other" else fn_this, reps))
    return ms


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    smi = cs.smi_line()
    lib = build_other(args.other)
    lines = [{"nvidia_smi": smi, "other": args.other, "other_takes_sig": lib["takes_sig"],
              "ptxas_other": lib["ptxas"]}]
    L29, _, flow29, x29, kvec29, _, _ = cs.make_inputs()
    L57, flow57, x57 = cs.load_n57()
    kvec57 = cs.n57_kvec()
    with torch.no_grad():
        for tag, L, flow, x, kvec in (("n29_b2048", L29, flow29, x29, kvec29),
                                      ("n57_b512", L57, flow57, x57, kvec57)):
            u, J = cuda_flow_jac.flow_u_jac_cuda(flow, x)
            uo, Jo = other_flow(lib, flow, x)
            lp = cuda_fused_logp.fused_logp_cuda(u, kvec, J, L)
            lpo = other_fused(lib, u, kvec, J, L)
            lp64 = cuda_fused_logp.fused_logp_plain(u.double(), kvec.double(), J.double(), L)
            torch.cuda.synchronize()
            B, n, _ = x.shape
            lines.append({
                "shape": tag, "kernel": "flow_u_jac",
                "ms": turns(lambda: other_flow(lib, flow, x),
                            lambda: cuda_flow_jac.flow_u_jac_cuda(flow, x)),
                "u_max_abs_diff": cs.max_err(u, uo), "J_max_abs_diff": cs.max_err(J, Jo),
                "bound_ms": cs.flow_flops(B, n, cs.DIM, cs.DEPTH, cs.SPSIZE, cs.TPSIZE)
                / cs.PEAK_F32_FLOPS * 1e3})
            lines.append({
                "shape": tag, "kernel": "fused_logp",
                "ms": turns(lambda: other_fused(lib, u, kvec, J, L),
                            lambda: cuda_fused_logp.fused_logp_cuda(u, kvec, J, L)),
                "logp_max_abs_diff": cs.max_err(lp, lpo), "logp_p99_abs_diff": cs.p99_err(lp, lpo),
                "this_vs_plain_f64_max_p99": [cs.max_err(lp, lp64), cs.p99_err(lp, lp64)],
                "other_vs_plain_f64_max_p99": [cs.max_err(lpo, lp64), cs.p99_err(lpo, lp64)],
                "bound_ms": max(cs.fused_bound(B, n, cs.DIM))})
    for line in lines:
        print(json.dumps(line), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(line) + "\n" for line in lines))


if __name__ == "__main__":
    main()
