"""Work counts of the benchmark: kernels and whole epochs, from shapes alone.

The kernel counts are copies of ``chip_smoke.py``'s (``flow_flops``,
``d2_flops``, ``large_flops``, ``fused_bound``, ``k3_bound``), kept here so
that the yardstick does not move when that script does.  They count the work
a kernel's function needs, never what one implementation does: K2 forms its
Gram matrices in float64 since it was redesigned, but its count stays at the
float32 peak, so that the share reads the same whatever implements it.

Peaks: one H100 SXM, NVIDIA's data sheet, at its full power limit of 700 W:
67 TFLOP/s float32 outside the tensor cores and 3.35 TB/s of HBM3.  A share
is stated against these, with the card's power limit printed beside it.

``epoch_flops`` is the work one training epoch needs, term by term (see its
docstring); ``step.mfu`` divides it by the epoch's time and the peak.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


# ---- kernels (copies of chip_smoke.py) ----------------------------------------

def flow_flops(B, n, dim, depth, S, T):
    """K1 (flow + analytic Jacobian): float32 operations for B walkers."""
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


def flow_params(dim, depth, S, T):
    """Number of parameters of the flow (weights and biases)."""
    count, S_in, Cin = 0, dim, 2 * dim + 1
    for k in range(depth):
        count += (2 * S_in + Cin) * S + S
        if k < depth - 1:
            count += Cin * T + T
            Cin = T
        S_in = S
    return count + S * dim + dim


def flow_bytes(B, n, dim, depth, S, T):
    """K1's bytes: x read, u and J written, the parameters read once."""
    nd = n * dim
    return 4 * (2 * B * nd + B * nd * nd + flow_params(dim, depth, S, T))


def d2_flops(B, n, dim, S, T, lap: bool):
    """K5/K6 (depth-2 closure): (operations, transcendental calls)."""
    C0 = 2 * dim + 1
    pair = n * n
    fl = pair * (2 * C0 * T + dim * (6 * T + T))
    fl += pair * (C0 + 3 * dim + T + dim * T)
    fl += n * (2 * C0 * S + dim * 7 * S)
    fl += n * 2 * (2 * S + T) * S + 2 * n * S * dim
    fl += n * dim * 2 * S * (2 * S + T + C0) + n * dim * dim * 2 * (S + T)
    fl += pair * dim * S * 8
    fl += pair * dim * dim * 2 * (3 + T + S)
    trans = pair * (2 * dim + 1 + 3 * T)
    trans += n * 5 * S
    if lap:
        fl += pair * (dim * S * 8 + T * (2 * C0 + 6))
        fl += pair * dim * S * (6 + 2 * T + 4)
        fl += n * dim * 2 * S * (2 * S + T) + n * 2 * (2 * S + T) * S + 2 * n * S * dim
        trans += pair * dim
    return B * fl, B * trans


def large_flops(B, n, dim, S, T):
    """K4 (row-chunked depth-2 flow): (operations, transcendental calls)."""
    C0 = 2 * dim + 1
    pair = n * n
    fl = pair * (C0 + dim * S * 9) + n * 2 * C0 * S
    fl += pair * dim * S
    fl += pair * (2 * C0 * T + dim * T * 8 + T)
    fl += n * dim * 2 * T * S + n * 2 * (2 * S + T) * S + n * dim * 2 * S * S
    fl += pair * dim * S * (2 * S + 2 * T + 4)
    fl += pair * dim * dim * 2 * S + 2 * n * S * dim
    trans = pair * (2 * dim + 1) + pair * 3 * T + n * 6 * S
    return B * fl, B * trans


def fused_counts(B, n, dim):
    """K2 (Gram + Cholesky log-dets): (bytes, operations).  Lower triangles
    only; a complex multiply-add is 8 operations, a Cholesky m^3 / 3."""
    nd = n * dim
    nbytes = 4 * B * (nd * nd + 2 * n * dim + 1)
    flops = B * (nd**3 + 4 * n**3 + nd**3 / 3 + 4 * n**3 / 3 + 2 * n * n * dim)
    return nbytes, flops


def fused_bound(B, n, dim):
    """K2's least time in ms, (by bytes, by operations)."""
    nbytes, flops = fused_counts(B, n, dim)
    return nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3


def k3_bound(B, m):
    """K3's least time in ms, (by bytes, by operations), for B m x m matrices."""
    nbytes = 4 * B * (m * (m + 1) // 2 + 1)
    return nbytes / PEAK_BYTES_PER_S * 1e3, B * m**3 / 3 / PEAK_F32_FLOPS * 1e3


def k1_bound(B, n, dim, depth, S, T):
    """K1's least time in ms, (by bytes, by operations)."""
    return (flow_bytes(B, n, dim, depth, S, T) / PEAK_BYTES_PER_S * 1e3,
            flow_flops(B, n, dim, depth, S, T) / PEAK_F32_FLOPS * 1e3)


# ---- whole epochs ----------------------------------------------------------------

def van_params(M, dim, layers, D, H):
    """Number of parameters of the VAN."""
    per_layer = 4 * (D * D + D) + (D * H + H) + (H * D + D)
    return (dim * D + D) + layers * per_layer + (D * M + M) + M


def van_forward_flops(n, M, dim, layers, D, H):
    """One full causal pass over n tokens (log p of one state)."""
    fl = 2 * n * dim * D
    fl += layers * (n * (4 * 2 * D * D + 2 * 2 * D * H) + 2 * 2 * n * (n + 1) // 2 * D)
    return fl + 2 * n * D * M


def van_decode_flops(n, M, dim, layers, D, H):
    """The n - 1 cached decode steps that draw one state: token t attends to
    t + 1 cached positions."""
    fl = 0
    for t in range(n - 1):
        fl += 2 * dim * D + 2 * D * M
        fl += layers * (4 * 2 * D * D + 2 * 2 * D * H + 2 * 2 * (t + 1) * D)
    return fl


def slater_forward_flops(n, dim):
    """D = exp(i k . u) and its complex log-det by LU (8 real operations per
    complex multiply-add, 2/3 m^3 multiply-adds)."""
    return 2 * n * n * dim + 8 * (2 * n**3 / 3)


def ewald_flops(n, dim, NG):
    """The structure-factor Ewald sum of one walker."""
    return n * NG * (2 * dim + 4) + n * n * (3 * dim + 10)


def kgrid_size(dim, Gmax):
    """Number of reciprocal vectors with 0 < |G| <= Gmax."""
    r = range(-Gmax, Gmax + 1)
    if dim == 2:
        return sum(1 for a in r for b in r if 0 < a * a + b * b <= Gmax * Gmax)
    return sum(1 for a in r for b in r for c in r if 0 < a * a + b * b + c * c <= Gmax * Gmax)


def epoch_flops(cfg: dict, mix: dict) -> dict:
    """Operations one epoch needs, by term, for the whole global batch.

    Per walker and round (B walkers a round, ``acc_steps`` rounds):

    * ``mcmc``: ``mc_steps + 1`` Metropolis log-densities, each the flow and
      its Jacobian (K1's count) and the Slater and Jacobian Gram log-dets
      (K2's count);
    * ``van_decode``: the n - 1 cached decode steps that draw the state;
    * ``accumulate``: log p of the state (one VAN pass), the flow with its
      Jacobian and coordinate Laplacian (K1's count twice), the Slater
      gradient and Laplacian in closed form (one complex LU inverse and the
      ``dim`` products E = (D K) D^-1, 8 n^3 each, and the Hessian
      contraction with J J^T, 2 nd^3), the Ewald sum, and the log|det J|
      term: its gradient by one reverse pass (three times the forward: the
      Jacobian and an LU of J, 2/3 nd^3) and its Laplacian, exact (nd
      reverse passes of that gradient, each three times the gradient) or
      by Hutchinson (one Hessian-vector product, three times the gradient);
    * ``loss_grads`` (Adam): the reverse passes of log Psi and log p in the
      parameters, three times each forward;
    * ``scores`` (SR): the per-walker scores of log p and of log Psi's two
      components (three times each forward, twice for log Psi), their Gram
      matrices (2 B P^2 each; the quantum block twice, real and imaginary
      parts) and the contractions S^T w;
    * ``solve`` (SR, once an epoch): the damped solves of both Fisher blocks,
      P^3 / 3 by Cholesky, and their centring.

    Recomputation is left out: a term is counted once however often an
    implementation recomputes it.  Returns {term: operations, "total": sum}.
    """
    n, dim = cfg["n"], cfg["dim"]
    nd = n * dim
    depth, S, T = cfg["depth"], cfg["spsize"], cfg["tpsize"]
    M = cfg["num_states"]
    layers, D, H = cfg["nlayers"], cfg["modelsize"], cfg["nhidden"]
    B, rounds = mix["batch"], mix["acc_steps"]
    walkers = B * rounds
    flow1 = flow_flops(1, n, dim, depth, S, T)
    _, k2 = fused_counts(1, n, dim)
    ljd = 2 * nd**3 / 3
    logpsi = flow1 + slater_forward_flops(n, dim) + ljd
    out = {
        "mcmc": walkers * (cfg["mc_steps"] + 1) * (flow1 + k2),
        "van_decode": walkers * van_decode_flops(n, M, dim, layers, D, H),
    }
    van1 = van_forward_flops(n, M, dim, layers, D, H)
    slater_lap = 8 * (2 * n**3) + dim * 8 * n**3 + 2 * nd**3 + 8 * n * n * dim * dim
    ljd_grad = 3 * (flow1 + ljd)
    ljd_lap = (nd if not mix.get("hutchinson") else 1) * 3 * ljd_grad
    out["accumulate"] = walkers * (van1 + 2 * flow1 + slater_lap + ljd_grad + ljd_lap
                                   + ewald_flops(n, dim, kgrid_size(dim, cfg["Gmax"])))
    if mix.get("sr"):
        P_van = van_params(M, dim, layers, D, H)
        P_flow = flow_params(dim, depth, S, T)
        out["scores"] = walkers * (3 * van1 + 2 * 3 * logpsi
                                   + 2 * P_van**2 + 2 * 2 * P_flow**2
                                   + 2 * P_van + 2 * 2 * P_flow)
        out["solve"] = P_van**3 / 3 + P_flow**3 / 3 + 2 * P_flow**2
    else:
        out["loss_grads"] = walkers * 3 * (van1 + logpsi)
    out["total"] = sum(out.values())
    return out
