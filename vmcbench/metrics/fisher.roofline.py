"""The float64 Fisher Gram of the SR accumulate (the classical and quantum
blocks formed from the scores and summed in float64): its least time a
round over the mean device time a round of the float64 GEMM kernels
started inside the accumulate phase, in %.

The least time counts the work whatever implements it: the lower triangles
of both blocks, B P_van (P_van + 1) + 2 B P_flow (P_flow + 1) operations at
67 TFLOP/s (FP64 on the tensor cores), or the bytes (the float32 scores
read once, the float64 triangles read and written) at 3.35 TB/s, the
larger.  A cell with no float64 GEMM in its accumulate reads nothing."""

import statistics

import work

PEAK_F64_FLOPS = 67e12
# float64 GEMM kernels of cuBLAS / CUTLASS, by the fragments of their names
F64_GEMM = ("gemm_f64", "d884gemm", "dgemm", "dmma_gemm")


def gram_bound_s(batch, p_van, p_flow):
    """Least seconds of one round's Gram of both blocks."""
    flops = batch * p_van * (p_van + 1) + 2 * batch * p_flow * (p_flow + 1)
    triangles = p_van * (p_van + 1) // 2 + p_flow * (p_flow + 1) // 2
    nbytes = 4 * batch * (p_van + 2 * p_flow) + 2 * 8 * triangles
    return max(flops / PEAK_F64_FLOPS, nbytes / work.PEAK_BYTES_PER_S)


def is_f64_gemm(name: str) -> bool:
    low = name.lower()
    return any(f in low for f in F64_GEMM)


def read(run):
    p = run.profile
    rounds = p.phases.get("accumulate", []) if p is not None else []
    if not rounds:
        return None
    times = [(e - s) / 1e9 for name, s, e in p.kernels
             if is_f64_gemm(name) and any(a <= s <= b for a, b in rounds)]
    if not times:
        return None
    c, m = run.cell.cfg, run.cell.mix
    p_van = work.van_params(c["num_states"], c["dim"], c["nlayers"], c["modelsize"],
                            c["nhidden"])
    p_flow = work.flow_params(c["dim"], c["depth"], c["spsize"], c["tpsize"])
    per_round = sum(times) / len(rounds)
    return 100 * gram_bound_s(m["batch"] // run.world, p_van, p_flow) / per_round
