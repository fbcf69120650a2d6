"""K2 (the Slater and Jacobian Gram log-dets, csrc/fused_logp.cu): its least
time at the cell's shapes (work.fused_bound) over its mean device time a
launch, in %."""

import statistics

import work


def read(run):
    if run.profile is None:
        return None
    times = run.profile.kernel_times("cg_fused_logp_kernel")
    if not times:
        return None
    c, m = run.cell.cfg, run.cell.mix
    bound_ms = max(work.fused_bound(m["batch"] // run.world, c["n"], c["dim"]))
    return 100 * bound_ms / 1e3 / statistics.fmean(times)
