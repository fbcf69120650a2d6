"""The whole epoch's share of the chips' float32 peak, in %: the operations
one epoch needs (work.epoch_flops, counted from the cell's shapes, never
from the kernels that do them) over the mean epoch time of the window's
spans, 67 TFLOP/s and the chips."""

import work


def read(run):
    t = run.epoch_s()
    if not t:
        return None
    c, m = run.cell.cfg, dict(run.cell.mix)
    m["sr"] = "--sr" in m.get("flags", [])
    m["hutchinson"] = "--hutchinson" in m.get("flags", [])
    flops = work.epoch_flops(c, m)["total"]
    return 100 * flops / (t * work.PEAK_F32_FLOPS * run.world)
