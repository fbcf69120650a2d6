"""Where the depth-2 closure kernels K5 and K6 spend their cycles, phase by phase.

    python3 scripts/probe_flow_d2_torch.py [--src coulombgas_tpu_torch/csrc/flow_d2.cu]

``ncu`` does not run on the test machine, so this script writes an
instrumented copy of the kernels' source (``--src``, by default the
package's) to the git-ignored ``build/probe_src/`` and builds it into
``build/probe/``: the block's thread 0 reads ``clock64()`` at the start and
at each of the three phases, and lane 0 of every warp sums the cycles of its
rows' parts in phase 3 (the tp layer; the row sums, pre1 and u; the row's
matrices; the J blocks; K6's Laplacian of the row, 0 for K5).  The copy
writes these counts into u, so its u is not the flow's.  K5 and K6 are built
and run at the two shapes of ``scripts/compare_kernels_torch.py`` (n = 29,
batch 2048; n = 57, batch 512 on the checked-in checkpoint); one JSON line
each with the cycles per block averaged over the batch.  The anchors it
instruments are lines of ``cg_flow_d2_rows_kernel``; it fails if one is
missing.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import chip_smoke as cs  # noqa: E402
import compare_kernels_torch as ck  # noqa: E402

PHASES = ("  // ---- phase 1: a warp per row i", "  // ---- phase 2: a warp per column l",
          "  // ---- phase 3: a warp per row i")
ROW_LOOP = "  for (int i = warp; i < n; i += CG_D2R_WARPS) {\n"
PARTS = ("    cg_d2r_tree_to<TM>(part, lane, rs);", "    // the row's matrices",
         "    // the blocks (i, l)", "    if constexpr (LAP) {\n      // ---- the Laplacian of row i")
ROW_END = "    __syncwarp();\n  }\n"
KERNEL = "cg_flow_d2_rows_kernel(const float* __restrict__ x"
LAUNCHERS = "#ifndef CG_CPU_SHIM"


def clock(k: int) -> str:
    return "    { long long cg_b = clock64(); cg_acc[%d] += cg_b - cg_a; cg_a = cg_b; }\n" % k


def instrument(src: str) -> str:
    for anchor in (KERNEL, LAUNCHERS, ROW_LOOP, ROW_END) + PHASES + PARTS:
        if anchor not in src:
            raise SystemExit("probe: anchor %r not found in the source" % anchor)
    head = src.index(KERNEL)
    body = src.index("{", head) + 1
    s = src[:body] + "\n  long long cg_t[4] = {clock64(), 0, 0, 0};\n" + src[body:]
    for k, anchor in enumerate(PHASES, 1):
        at = s.index(anchor)
        s = s[:at] + "  cg_t[%d] = clock64();\n" % k + s[at:]
    p3 = s.index(PHASES[2])
    seg = s[p3:]
    at = seg.index(ROW_LOOP)
    seg = (seg[:at] + "  long long cg_acc[5] = {0, 0, 0, 0, 0};\n" + ROW_LOOP
           + "    long long cg_a = clock64();\n" + seg[at + len(ROW_LOOP):])
    for k, anchor in enumerate(PARTS):
        at = seg.index(anchor)
        seg = seg[:at] + clock(k) + seg[at:]
    end = seg.rindex("}", 0, seg.index(LAUNCHERS))  # the kernel's closing brace
    last = seg.rindex(ROW_END, 0, end)
    seg = seg[:last] + "    __syncwarp();\n" + clock(len(PARTS)) + "  }\n" + seg[last + len(ROW_END):]
    end = seg.rindex("}", 0, seg.index(LAUNCHERS))
    seg = seg[:end] + """  {
    const long long cg_t4 = clock64();
    __syncthreads();
    if (lane == 0)
      for (int q = 0; q < 5; ++q) u[w * nd + 8 + 5 * warp + q] = (float)cg_acc[q];
    if (threadIdx.x == 0) {
      u[w * nd + 0] = (float)(cg_t[1] - cg_t[0]);
      u[w * nd + 1] = (float)(cg_t[2] - cg_t[1]);
      u[w * nd + 2] = (float)(cg_t[3] - cg_t[2]);
      u[w * nd + 3] = (float)(cg_t4 - cg_t[3]);
    }
  }
""" + seg[end:]
    return s[:p3] + seg


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "coulombgas_tpu_torch", "csrc", "flow_d2.cu"))
    args = ap.parse_args()
    out_dir = os.path.join(ROOT, "build", "probe_src")
    os.makedirs(out_dir, exist_ok=True)
    with open(args.src) as f:
        src = f.read()
    with open(os.path.join(out_dir, "flow_d2.cu"), "w") as f:
        f.write(instrument(src))
    lib = ck.build_other(out_dir, "probe", rebuild_this=False)
    L29, _, flow29, x29, _, _, _ = cs.make_inputs()
    L57, flow57, x57 = cs.load_n57()
    print(json.dumps({"nvidia_smi": cs.smi_line(), "src": args.src}), flush=True)
    for tag, flow, x in (("n29_b2048", flow29, x29), ("n57_b512", flow57, x57)):
        for kernel, key in (("flow_u_jac_d2", "d2"), ("flow_u_jac_lap_d2", "d2lap")):
            with torch.no_grad():
                u = ck.other_flow(lib, flow, x, key)[0]
                torch.cuda.synchronize()
            c = u.reshape(u.shape[0], -1)[:, :48].double().mean(0).cpu().tolist()
            print(json.dumps({
                "shape": tag, "kernel": kernel,
                "cycles_per_block": dict(zip(("load", "phase1", "phase2", "phase3"), c[:4])),
                "phase3_by_warp_tp_rowsums_matrices_J_lap": [c[8 + 5 * k:13 + 5 * k]
                                                             for k in range(8)],
            }), flush=True)


if __name__ == "__main__":
    main()
