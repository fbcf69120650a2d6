"""K1 (the flow and its Jacobian, csrc/flow_jac.cu): its least time at the
cell's shapes (the larger of its operations at 67 TFLOP/s and its bytes at
3.35 TB/s, work.k1_bound) over its mean device time a launch, in %."""

import statistics

import work


def read(run):
    if run.profile is None:
        return None
    times = run.profile.kernel_times("cg_flow_jac_kernel")
    if not times:
        return None
    c, m = run.cell.cfg, run.cell.mix
    bound_ms = max(work.k1_bound(m["batch"] // run.world, c["n"], c["dim"], c["depth"],
                                 c["spsize"], c["tpsize"]))
    return 100 * bound_ms / 1e3 / statistics.fmean(times)
