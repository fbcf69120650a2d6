"""Times two versions of the kernels K1-K6 in turns on one GPU.

    python3 scripts/compare_kernels_torch.py [--other DIR [DIR ...]] [--k3_plans] [--out FILE]

Each DIR holds another version's sources, any of ``flow_jac.cu`` (K1),
``fused_logp.cu`` with the headers it includes (K2: ``chol.cuh``,
``chol_blocked.cuh``), ``chol_logdet.cu`` with the same headers (K3),
``flow_large.cu`` (K4) and ``flow_d2.cu`` (K5 and K6; both with
``flow_pair.cuh`` where they include it), for example written there by
``git show <commit>:coulombgas_tpu_torch/csrc/<file>``.  Both versions are
built with the same ``nvcc`` flags, the package's into ``build/`` and the
other into ``build/other<k>/``, all sources in parallel.  At the two shapes
the main paths run — n = 29, batch 2048 (``chip_smoke.make_inputs``) and
n = 57, batch 512 on the checked-in checkpoint's weights and walkers
(``chip_smoke.load_n57``) — each kernel of DIR is timed in the order other,
this, this, other (median of 20 launches by CUDA events each), and the two
versions' outputs on the same inputs are compared; K5's lines also time the
package's K1 on the same walkers, K6's give its outputs' distance from the
plain f64 closure.  K4's lines time the two versions and, in the same
turns, the package's K1 and K5 on the same walkers (each of the four turns:
K4, K1, K5), and give both K4s' distance from the plain f64 version; a K4
with the parent's two kernels (``cg_flow_large_layer0``,
``cg_flow_large_final``) runs as the parent's wrapper ran it, the two
``torch.mean`` between its launches included.  Every line of K1, K4, K5
and K6 says whether the two versions' outputs are equal bit for bit.  K3 is compared at its own shapes (``chip_smoke.K3_SHAPES``,
random SPD matrices) in the order other, this, library, library, this, other,
the library being ``torch.linalg.cholesky`` + log-diag; another K3 with the
parent's launcher (A, out, B, m, stream) runs as it is, one with a launch
plan gets the package's ``k3_plan``.  ``--k3_plans`` times the package's K3
under every launch plan it can run (``cuda_logdet.k3_plans``) at those shapes
and at m 241, back to back, checks that each gives the package's plan's bits,
and times the library call beside them.  Prints one JSON line per shape and
kernel, and the ``nvidia-smi`` name and power limit; ``--out`` also writes
them to a file.  Needs a CUDA device.
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
from coulombgas_tpu_torch.ops import (  # noqa: E402
    _build, cuda_flow_d2, cuda_flow_jac, cuda_flow_large, cuda_fused_logp, cuda_logdet,
)


def build_other(src_dir: str, tag: str = "other", rebuild_this: bool = True) -> dict:
    """Build another version's libraries, those of DIR's sources, into
    ``build/<tag>/``, and (``rebuild_this``) the package's of the same names
    beside them; returns their entry points as ctypes functions and the
    ptxas lines of both."""
    out_dir = os.path.join(_build.BUILD_DIR, tag)
    os.makedirs(out_dir, exist_ok=True)
    names = [nm for nm in ("flow_jac", "fused_logp", "flow_d2", "chol_logdet", "flow_large")
             if os.path.isfile(os.path.join(src_dir, nm + ".cu"))]
    procs = {}
    for name in names:
        cmd = _build._command(name)
        cmd[cmd.index("-o") + 1] = os.path.join(out_dir, "lib%s.so" % name)
        cmd[-1] = os.path.join(src_dir, name + ".cu")
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    this_logs = _build.build_all(names, force=True) if rebuild_this else {}
    libs, ptxas = {}, {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for the other %s:\n%s" % (name, log))
        ptxas[name] = cs.ptxas_lines(log)
        libs[name] = ctypes.CDLL(os.path.join(out_dir, "lib%s.so" % name))
    fns = {"ptxas": ptxas, "ptxas_this": {name: cs.ptxas_lines(log)
                                          for name, log in this_logs.items()}}
    if "flow_jac" in libs:
        fns["flow"] = libs["flow_jac"].cg_flow_u_jac
        fns["flow"].argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_void_p]
    if "fused_logp" in libs:
        fns["fused"] = libs["fused_logp"].cg_fused_logp
        fns["fused"].argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_void_p]
    if "flow_d2" in libs:
        fns["d2"] = libs["flow_d2"].cg_flow_d2_u_jac
        fns["d2"].argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
        fns["d2lap"] = libs["flow_d2"].cg_flow_d2_u_jac_lap
        fns["d2lap"].argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
    if "flow_large" in libs:
        lib = libs["flow_large"]
        if hasattr(lib, "cg_flow_large"):  # one launch: (x, 8 weights, u, J, ints, L, stream)
            fns["large"] = lib.cg_flow_large
            fns["large"].argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [
                ctypes.c_float, ctypes.c_void_p]
        else:  # the parent's two kernels, packed weights
            fns["large0"] = lib.cg_flow_large_layer0
            fns["large0"].argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
                ctypes.c_float, ctypes.c_void_p]
            fns["large1"] = lib.cg_flow_large_final
            fns["large1"].argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
                ctypes.c_float, ctypes.c_void_p]
    if "chol_logdet" in libs:
        lib = libs["chol_logdet"]
        fns["k3"] = lib.cg_chol_logdet
        fns["k3_planned"] = hasattr(lib, "cg_chol_logdet_occupancy")
        if fns["k3_planned"]:  # (A, out, B, m, warps, groups, smem, grid, stream)
            fns["k3"].argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            fns["k3_smem"] = lib.cg_chol_logdet_smem
            fns["k3_smem"].argtypes = [ctypes.c_int] * 2
            fns["k3_smem"].restype = ctypes.c_int
        else:  # the parent's: (A, out, B, m, stream)
            fns["k3"].argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    for key in ("flow", "fused", "d2", "d2lap", "k3", "large", "large0", "large1"):
        if key in fns:
            fns[key].restype = ctypes.c_int
    return fns


def other_flow(lib, flow, x, key="flow"):
    """The other K1 (``key="flow"``), K5 (``"d2"``) or K6 (``"d2lap"``, which
    also returns lap) on x."""
    B, n, dim = x.shape
    cfg = flow.cfg
    params = cuda_flow_jac.pack_flow_params(flow)
    u = torch.empty_like(x)
    J = torch.empty(B, n * dim, n * dim, device=x.device)
    lap = torch.empty(B, n * dim, device=x.device)
    args = [x.data_ptr(), params.data_ptr(), u.data_ptr(), J.data_ptr()]
    if key == "d2lap":
        args.append(lap.data_ptr())
    args += [B, n, dim]
    if key == "flow":
        args.append(cfg.depth)
    code = lib[key](*args, cfg.spsize, cfg.tpsize, float(cfg.L),
                    torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, "other " + key)
    return (u, J, lap) if key == "d2lap" else (u, J)


def other_large(lib, flow, x):
    """The other K4 on x: one launch, or the parent's two kernels with the
    two means over rows between them, as its wrapper ran them."""
    B, n, dim = x.shape
    cfg = flow.cfg
    S, T = cfg.spsize, cfg.tpsize
    u = torch.empty_like(x)
    J = torch.empty(B, n * dim, n * dim, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    tail = (B, n, dim, S, T, float(cfg.L), stream)
    if "large" in lib:
        ws = [t for lin in (flow.sp[0], flow.sp[1], flow.tp[0], flow.final) for t in (lin.w, lin.b)]
        code = lib["large"](x.data_ptr(), *(w.data_ptr() for w in ws), u.data_ptr(), J.data_ptr(),
                            *tail)
        _build.check_launch(code, "other flow_large")
        return u, J
    params = cuda_flow_jac.pack_flow_params(flow)
    sp1 = torch.empty(B, n, S, device=x.device)
    Jsp1 = torch.empty(B, n, n, dim, S, device=x.device)
    code = lib["large0"](x.data_ptr(), params.data_ptr(), sp1.data_ptr(), Jsp1.data_ptr(), *tail)
    _build.check_launch(code, "other flow_large (layer 0)")
    spmean = sp1.mean(dim=1).contiguous()
    jmean = Jsp1.mean(dim=1).contiguous()
    code = lib["large1"](x.data_ptr(), params.data_ptr(), sp1.data_ptr(), Jsp1.data_ptr(),
                         spmean.data_ptr(), jmean.data_ptr(), u.data_ptr(), J.data_ptr(), *tail)
    _build.check_launch(code, "other flow_large (final layer)")
    return u, J


def compare_large(lib, flow, x, tag, reps: int = 20) -> dict:
    """K4's line at one shape: the other K4 and the package's in turns
    (other, this, this, other), each turn also timing the package's K1 and
    K5 on the same walkers; outputs against each other and plain f64."""
    B, n, _ = x.shape
    this = lambda: cuda_flow_large.flow_u_jac_large_cuda(flow, x)  # noqa: E731
    fns = {"other": lambda: other_large(lib, flow, x), "this": this,
           "flow_u_jac": lambda: cuda_flow_jac.flow_u_jac_cuda(flow, x),
           "flow_u_jac_d2": lambda: cuda_flow_d2.flow_u_jac_d2_cuda(flow, x)}
    ms = {k: [] for name in fns for k in (name, name + "_b2b")}
    for who in ("other", "this", "this", "other"):
        for name in (who, "flow_u_jac", "flow_u_jac_d2"):
            ms[name].append(cs.time_ms(fns[name], reps))
            ms[name + "_b2b"].append(cs.time_ms_b2b(fns[name], reps))
    got, oth = this(), other_large(lib, flow, x)
    flow64 = cs.init_ferminet_params(flow.cfg, cs.DIM, None, torch.float64, x.device)
    flow64.load_state_dict({k: v.double() for k, v in flow.state_dict().items()})
    ref = cuda_flow_large.flow_u_jac_large_ref(flow64, x.double())
    flops, _ = cs.large_flops(B, n, cs.DIM, cs.SPSIZE, cs.TPSIZE)
    return {"shape": tag, "kernel": "flow_u_jac_large", "ms": ms,
            "bit_equal": all(torch.equal(a, b) for a, b in zip(got, oth)),
            "u_J_max_abs_diff": [cs.max_err(a, b) for a, b in zip(got, oth)],
            "this_vs_plain_f64_u_J": [cs.max_err(a, b) for a, b in zip(got, ref)],
            "other_vs_plain_f64_u_J": [cs.max_err(a, b) for a, b in zip(oth, ref)],
            "bound_ms": flops / cs.PEAK_F32_FLOPS * 1e3}


def other_fused(lib, u, kvec, J, L):
    B, n, dim = u.shape
    out = torch.empty(B, device=u.device)
    code = lib["fused"](u.data_ptr(), kvec.data_ptr(), J.data_ptr(), out.data_ptr(), B, n, dim,
                        float(L) ** (-dim / 2), torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, "other fused_logp")
    return out


def other_k3(lib, A):
    """The other K3 on A (B, m, m); with a launch plan, the package's."""
    B, m, _ = A.shape
    out = torch.empty(B, device=A.device)
    stream = torch.cuda.current_stream().cuda_stream
    if lib["k3_planned"]:
        p = cuda_logdet._plan(m, B, A.device.index)
        code = lib["k3"](A.data_ptr(), out.data_ptr(), B, m, p.warps, p.groups,
                         lib["k3_smem"](m, p.groups), p.grid, stream)
    else:
        code = lib["k3"](A.data_ptr(), out.data_ptr(), B, m, stream)
    _build.check_launch(code, "other chol_logdet")
    return out


def compare_k3(lib, reps: int = 20) -> list:
    """One JSON line per K3 shape: the two versions and the library call in
    turns (other, this, library, library, this, other), per call and back to
    back, and the versions' outputs against each other and plain f64."""
    lines = []
    for k, (tag, B, m) in enumerate(cs.K3_SHAPES):
        A = cs.random_spd(B, m, 3 + k)
        got, oth = cuda_logdet.chol_logdet_cuda(A), other_k3(lib, A)
        ref = cuda_logdet.chol_logdet_plain(A.double())
        fns = {"other": lambda: other_k3(lib, A), "this": lambda: cuda_logdet.chol_logdet_cuda(A),
               "library": lambda: library_k3(A)}
        ms = {k2: [] for name in fns for k2 in (name, name + "_b2b")}
        for who in ("other", "this", "library", "library", "this", "other"):
            ms[who].append(cs.time_ms(fns[who], reps))
            ms[who + "_b2b"].append(cs.time_ms_b2b(fns[who], reps))
        t_b, t_o = cs.k3_bound(B, m)
        lines.append({"shape": tag, "kernel": "chol_logdet", "batch": B, "m": m, "ms": ms,
                      "bit_equal": bool(torch.equal(got, oth)), "max_abs_diff": cs.max_err(got, oth),
                      "this_vs_plain_f64": cs.max_err(got, ref),
                      "other_vs_plain_f64": cs.max_err(oth, ref),
                      "bound_ms": max(t_b, t_o), "bound_by": "bytes" if t_b >= t_o else "operations"})
    return lines


def sweep_k3_plans(reps: int = 20) -> list:
    """One JSON line per K3 shape (``chip_smoke.K3_SHAPES`` and B 512 /
    m 241, random SPD matrices): every plan of ``cuda_logdet.k3_plans``
    timed back to back and checked bit for bit against the package's plan,
    beside the library call timed the same way before and after."""
    lines = []
    sms = torch.cuda.get_device_properties(cs.DEV).multi_processor_count
    for k, (tag, B, m) in enumerate(cs.K3_SHAPES + (("b512_m241", 512, 241),)):
        A = cs.random_spd(B, m, 20 + k)
        default = cuda_logdet.k3_plan(m, B, sms)
        ref = cuda_logdet.chol_logdet_cuda(A)
        lib_ms = [cs.time_ms_b2b(lambda: library_k3(A), reps)]
        rows = []
        for p in cuda_logdet.k3_plans(m, B, sms):
            cs.check(torch.equal(cuda_logdet._launch(A, p), ref),
                     "K3 at %s: plan %s differs from %s" % (tag, p, default))
            rows.append(dict(p._asdict(), occupancy=cuda_logdet.occupancy(p),
                             ms_b2b=cs.time_ms_b2b(lambda: cuda_logdet._launch(A, p), reps)))
        lib_ms.append(cs.time_ms_b2b(lambda: library_k3(A), reps))
        rows.sort(key=lambda r: r["ms_b2b"])
        t_b, t_o = cs.k3_bound(B, m)
        lines.append({"shape": tag, "kernel": "chol_logdet_plans", "batch": B, "m": m,
                      "default": default._asdict(),
                      "default_ms_b2b": next(r["ms_b2b"] for r in rows
                                             if (r["warps"], r["groups"])
                                             == (default.warps, default.groups)),
                      "library_ms_b2b": lib_ms, "bound_ms": max(t_b, t_o),
                      "bound_by": "bytes" if t_b >= t_o else "operations", "plans": rows})
    return lines


def library_k3(A):
    """``torch.linalg.cholesky`` + log-diag: the library call for K3."""
    return 2 * torch.linalg.cholesky(A).diagonal(dim1=-2, dim2=-1).log().sum(-1)


def turns(fn_other, fn_this, reps: int = 20) -> dict:
    """ms per call of each version in the order other, this, this, other:
    ``ms`` of calls timed one by one (``chip_smoke.time_ms``), ``b2b`` of
    calls run back to back (``chip_smoke.time_ms_b2b``)."""
    ms = {"other": [], "this": [], "other_b2b": [], "this_b2b": []}
    for who in ("other", "this", "this", "other"):
        fn = fn_other if who == "other" else fn_this
        ms[who].append(cs.time_ms(fn, reps))
        ms[who + "_b2b"].append(cs.time_ms_b2b(fn, reps))
    return ms


def compare(lib, case29, case57) -> list:
    """One JSON line per shape and kernel of ``lib``: the two versions in
    turns, their outputs against each other."""
    lines = []
    with torch.no_grad():
        for tag, (L, flow, x, kvec) in (("n29_b2048", case29), ("n57_b512", case57)):
            B, n, _ = x.shape
            u, J = cuda_flow_jac.flow_u_jac_cuda(flow, x)
            if "flow" in lib:
                uo, Jo = other_flow(lib, flow, x)
                lines.append({
                    "shape": tag, "kernel": "flow_u_jac",
                    "ms": turns(lambda: other_flow(lib, flow, x),
                                lambda: cuda_flow_jac.flow_u_jac_cuda(flow, x)),
                    "u_max_abs_diff": cs.max_err(u, uo), "J_max_abs_diff": cs.max_err(J, Jo),
                    "bit_equal": bool(torch.equal(u, uo) and torch.equal(J, Jo)),
                    "bound_ms": cs.flow_flops(B, n, cs.DIM, cs.DEPTH, cs.SPSIZE, cs.TPSIZE)
                    / cs.PEAK_F32_FLOPS * 1e3})
            if "d2" in lib:
                u5, J5 = cuda_flow_d2.flow_u_jac_d2_cuda(flow, x)
                uo, Jo = other_flow(lib, flow, x, "d2")
                lines.append({
                    "shape": tag, "kernel": "flow_u_jac_d2",
                    "ms": turns(lambda: other_flow(lib, flow, x, "d2"),
                                lambda: cuda_flow_d2.flow_u_jac_d2_cuda(flow, x)),
                    "flow_u_jac_ms": cs.time_ms(lambda: cuda_flow_jac.flow_u_jac_cuda(flow, x), 20),
                    "flow_u_jac_ms_b2b": cs.time_ms_b2b(
                        lambda: cuda_flow_jac.flow_u_jac_cuda(flow, x), 20),
                    "u_max_abs_diff": cs.max_err(u5, uo), "J_max_abs_diff": cs.max_err(J5, Jo),
                    "bit_equal": bool(torch.equal(u5, uo) and torch.equal(J5, Jo)),
                    "vs_flow_u_jac_u_J": [cs.max_err(u5, u), cs.max_err(J5, J)],
                    "bound_ms": cs.d2_flops(B, n, cs.DIM, cs.SPSIZE, cs.TPSIZE, False)[0]
                    / cs.PEAK_F32_FLOPS * 1e3})
                got = cuda_flow_d2.flow_u_jac_lap_d2_cuda(flow, x)
                oth = other_flow(lib, flow, x, "d2lap")
                flow64 = cs.init_ferminet_params(flow.cfg, cs.DIM, None, torch.float64, x.device)
                flow64.load_state_dict({k: v.double() for k, v in flow.state_dict().items()})
                ref = cuda_flow_d2.flow_u_jac_lap_d2_plain(flow64, x.double())
                lines.append({
                    "shape": tag, "kernel": "flow_u_jac_lap_d2",
                    "ms": turns(lambda: other_flow(lib, flow, x, "d2lap"),
                                lambda: cuda_flow_d2.flow_u_jac_lap_d2_cuda(flow, x)),
                    "u_J_lap_max_abs_diff": [cs.max_err(a, b) for a, b in zip(got, oth)],
                    "bit_equal": all(torch.equal(a, b) for a, b in zip(got, oth)),
                    "this_vs_plain_f64_u_J_lap": [cs.max_err(a, b) for a, b in zip(got, ref)],
                    "other_vs_plain_f64_u_J_lap": [cs.max_err(a, b) for a, b in zip(oth, ref)],
                    "bound_ms": cs.d2_flops(B, n, cs.DIM, cs.SPSIZE, cs.TPSIZE, True)[0]
                    / cs.PEAK_F32_FLOPS * 1e3})
            if "large" in lib or "large0" in lib:
                lines.append(compare_large(lib, flow, x, tag))
            if "fused" in lib:
                lp = cuda_fused_logp.fused_logp_cuda(u, kvec, J, L)
                lpo = other_fused(lib, u, kvec, J, L)
                lp64 = cuda_fused_logp.fused_logp_plain(u.double(), kvec.double(), J.double(), L)
                torch.cuda.synchronize()
                lines.append({
                    "shape": tag, "kernel": "fused_logp",
                    "ms": turns(lambda: other_fused(lib, u, kvec, J, L),
                                lambda: cuda_fused_logp.fused_logp_cuda(u, kvec, J, L)),
                    "logp_max_abs_diff": cs.max_err(lp, lpo),
                    "logp_p99_abs_diff": cs.p99_err(lp, lpo),
                    "this_vs_plain_f64_max_p99": [cs.max_err(lp, lp64), cs.p99_err(lp, lp64)],
                    "other_vs_plain_f64_max_p99": [cs.max_err(lpo, lp64), cs.p99_err(lpo, lp64)],
                    "bound_ms": max(cs.fused_bound(B, n, cs.DIM))})
    return lines


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", default=[], nargs="*")
    ap.add_argument("--k3_plans", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not args.other and not args.k3_plans:
        ap.error("nothing to do: give --other DIR and/or --k3_plans")
    smi = cs.smi_line()
    libs = [build_other(d, "other%d" % k, k == 0) for k, d in enumerate(args.other)]
    flow_keys = ("flow", "fused", "d2", "large", "large0")
    if any(key in lib for lib in libs for key in flow_keys):
        L29, _, flow29, x29, kvec29, _, _ = cs.make_inputs()
        L57, flow57, x57 = cs.load_n57()
        kvec57 = cs.n57_kvec()
    lines = []
    for other, lib in zip(args.other, libs):
        lines.append({"nvidia_smi": smi, "other": other, "ptxas_other": lib["ptxas"],
                      "ptxas_this": lib["ptxas_this"]})
        if any(key in lib for key in flow_keys):
            lines += compare(lib, (L29, flow29, x29, kvec29), (L57, flow57, x57, kvec57))
        if "k3" in lib:
            lines += compare_k3(lib)
    if args.k3_plans:
        if not libs:
            lines.append({"nvidia_smi": smi, "ptxas_this": {
                name: cs.ptxas_lines(log)
                for name, log in _build.build_all(("chol_logdet",), force=True).items()}})
        lines += sweep_k3_plans()

    for line in lines:
        print(json.dumps(line), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(line) + "\n" for line in lines))


if __name__ == "__main__":
    main()
