// Depth-2 FermiNet flow in closed structured form: forward, coordinate
// Jacobian and (as a compile-time switch) coordinate Laplacian for a walker
// batch, with no carried Jacobian state.
//
//   x (B, n, dim)  ->  u (B, n, dim),  J (B, nd, nd)   rows (i, b), cols (l, a)
//                      lap (B, nd)     lap[(i,b)] = sum_{l,a} d^2 u[i][b] / d x[l][a]^2
//
// Replaces: coulombgas_tpu/ops/pallas_flow_jac.py, flow_u_jac_pallas_d2
// (K5: kernel bodies _d2_tp_kernel, _d2_G_kernel, _d2_J_kernel) and
// flow_u_jac_lap_pallas_d2 (K6: _d2_kernel with emit_lap).  Same mathematics
// as the plain versions models/ferminet_jac.py:ferminet_apply_and_jac_d2 and
// ferminet_apply_jac_lap_d2:
//
//   J[i][l] = delta_il (I + D_i M_i - SumA1_i N_i) + A0[i][l] K_i + A1[i][l] N_i
//             + G_l R_i
//
// with per-row matrices M, K, N, R (a few hundred floats a row), the row
// quantities D, SumA1 and the mean accumulator G_l = D_l - (1/n) sum_k sig0_k *
// (A0[k][l] W3_0).  The Laplacian adds the squared-first-derivative sums of the
// softplus chain rule, split as JfW1[i][l] = delta_il T_i + U[i][l] + V_l, with
// U[i][l] = -(A0[i][l] Pq_i + A1[i][l] W3) / n, Pq_i = diag(sig0_i) W3_0 W1, and
// V_l = G_l W2 / n.  The features do not move when every particle moves alike,
// so sum_l JfW1[i][l] = 0 and T_i = -sum_l U[i][l].
//
// Bound on this card: operations.  What must move is x in and u, J (nd*nd
// floats a walker) and lap out, 28.5 MB at n = 29 and batch 2048; the closure
// needs about 1.0 Mflop a walker for J (2.7 Mflop with the Laplacian) and
// some 55 transcendental calls per pair, which takes longer at the f32 rate
// than those bytes at the memory rate.  With the Laplacian the work per pair
// doubles: U is a (dim x S) product per pair (A1[i][l] W3 alone is
// dim * T * S multiply-adds), summed over the row's pairs as its squares and
// its cross terms with V_l.
//
// One kernel, cg_flow_d2_rows_kernel, for both: K5 (u, J) and K6 (u, J, lap)
// are its instantiations LAP = false and true.  A block of 8 warps per walker,
// a warp per particle row, the pair state in registers and no pair table:
// shared memory holds O(n S) floats.  The design is set out above the kernel.
#include <cuda_runtime.h>
#include <math.h>

#include "flow_pair.cuh"  // pair features (cg_fp_pair) and shuffle trees (cg_fp_tree)

#define CG_D2_MAXDIM 3

__host__ __device__ inline int cg_d2_up4(int v) { return (v + 3) & ~3; }

// Packed weights of a depth-2 flow, in the order ops/cuda_flow_jac.py packs
// them: sp_w[0] ((2 dim + C0) x S), sp_b[0], sp_w[1] ((2 S + T) x S), sp_b[1],
// tp_w[0] (C0 x T), tp_b[0], final_w (S x dim), final_b.
__host__ __device__ inline int cg_d2_params(int dim, int S, int T) {
  const int C0 = 2 * dim + 1;
  return (2 * dim + C0) * S + S + (2 * S + T) * S + S + C0 * T + T + S * dim + dim;
}

__device__ inline float cg_d2_sigmoid(float x) { return 1.f / (1.f + expf(-x)); }
// log(1 + e^x) = max(x, 0) + log1p(e^-|x|): logaddexp(x, 0), no threshold.
__device__ inline float cg_d2_softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__host__ __device__ inline int cg_d2_take(int* o, int k) {
  const int r = *o;
  *o += k;
  return r;
}

// ---- The kernel: a warp per particle row ----------------------------------
//
// One block of CG_D2R_WARPS warps per walker; warp w takes the rows w, w + 8,
// ...  Lane L of a row's warp owns the pairs (i, L) and (i, L + 32) (n <= 64)
// and makes their features in registers from one sincos of the folded half
// angle t = pi r / L per coordinate:
//   sin(2t) = 2 sin t cos t,  cos(2t) = 1 - 2 sin^2 t,  d = |(sin t_a)_a|,
//   d d / d r_a = k1 sin t_a cos t_a / d,
//   sum_a d^2 d / d r_a^2 = k1^2 (sum_a cos 2t_a / d - sum_a (sin t_a cos t_a)^2 / d^3),
// all of period L in r, so r is folded into [-L/2, L/2] first.  No pair table
// exists: shared memory holds O(n S) floats (the rows' sig0, sp1, D, G, with
// the Laplacian Lsp1 and V, the weights and a scratch line per warp).  Three
// phases, two block barriers:
//   1. a warp per row: sums over j of the features -> sig0, sp1, D of row i;
//      K6 also sums the pair Laplacians of tp0 and, per coordinate, the 3 x 3
//      outer products of A0[i][j]'s entries, from which
//      sum_j |A0[i][j] W3_0|^2 is a quadratic form in W3_0 -> Lsp1 of row i;
//   2. a warp per column l: G_l = D_l - (1/n) sum_k sig0_k (A0[k][l] W3_0),
//      A0[k][l] from the pair (l, k) the warp holds (cos and |sin| are even in
//      r, sin and the gradient of |sin| odd); warp 0 also forms mean_i sp1 and
//      the final sp layer's row-independent part b1 + mean_i(sp1) W2; K6 also
//      V_l = G_l W2 / n, and mean_i(Lsp1) W2 beside mean_i(sp1) W2;
//   3. a warp per row: the tp layer once per pair (one exp, one division, one
//      log: sigmoid and softplus), its row sum, sig1, u, the row's matrices
//      M, R, N, K, and the row's J blocks (i, l), lane l writing block (i, l)
//      of the contiguous rows (i, b) of J.  The diagonal block takes minus
//      the lanes' sum of A1[i][l] N_i for SumA1_i N_i.  K6 sums the pairs'
//      Laplacians of tp1 beside their softplus, and after the J blocks forms
//      each pair's U[i][l] from the tp sigmoids still in registers, summing
//      (U[i][l] + V_l)^2 and U[i][l] over the row (U[i][i] = 0 brings V_i^2);
//      then sq1_i = sum_l |U + V_l|^2 + T_i (T_i + 2 V_i), and lap of row i.
// Sums over the lanes are fixed-order shuffle trees (cg_fp_tree), sums over
// i ascend in one thread: a walker's result does not depend on its batch.
// tests/test_torch_flow_d2_rows.py holds a numpy model of this order.  Rows
// of four features are read 16 bytes at a time (the zero-padded sig0, G, R,
// V, W3_0, W3, Pq, tp_w with tp_b, and Q = tp_w * N, which turns A1[i][l] N_i
// into 16 rows of multiply-adds).  The production widths 16/16 have
// instantiations of their own, so that every loop over a width has a
// compile-time count; without the Laplacian a lane owning one pair (n <= 32)
// takes 80 registers and three blocks an SM, two pairs 128 registers and two
// blocks; with it two blocks an SM.
#define CG_D2R_WARPS 8
#define CG_D2R_MAXN 64
#define CG_D2R_MAXW 32

// Offsets (in floats) of the kernel's shared arrays; those of the Laplacian
// are 0 without it.
struct cg_d2r_layout {
  int Pm, W1T, W2T, W3T, W30p, WTB, xs, sig0, sp1, D, G, B1W, scr;
  int Lsp1, V, LB, W3p;
  int S4, SS, GS, QW, RS, scr_stride, total;
};

__host__ __device__ inline cg_d2r_layout cg_d2r_make_layout(int n, int dim, int S, int T,
                                                           bool lap) {
  const int C0 = 2 * dim + 1;
  cg_d2r_layout l;
  int o = 0;
  // Every array starts on a 16-byte boundary; rows read 4 features at a time
  // (sig0, G, V, W3_0, W3, R, Q, Pq) are padded with zeros to S4 = S rounded
  // up to 4.
  l.S4 = cg_d2_up4(S);
  l.SS = cg_fp_stride4(S);        // lanes read rows k of sig0 and G
  l.GS = cg_fp_stride4(dim * l.S4);
  l.QW = cg_d2_up4(C0 * dim);
  l.RS = lap ? 64 : 32;            // a warp's row sums
  l.Pm = cg_d2_take(&o, cg_d2_up4(cg_d2_params(dim, S, T)));
  l.W1T = cg_d2_take(&o, cg_d2_up4(S * S));  // W1^T, W2^T, W3^T: lanes run along their rows
  l.W2T = cg_d2_take(&o, cg_d2_up4(S * S));
  l.W3T = cg_d2_take(&o, cg_d2_up4(S * T));
  l.W30p = cg_d2_take(&o, C0 * l.S4);
  l.WTB = cg_d2_take(&o, 8 * T);  // WTB[c] = (tp_w[0..C0)[c], tp_b[c], 0...)
  l.xs = cg_d2_take(&o, cg_d2_up4(n * dim));
  l.sig0 = cg_d2_take(&o, n * l.SS);
  l.sp1 = cg_d2_take(&o, cg_d2_up4(n * S));
  l.D = cg_d2_take(&o, cg_d2_up4(n * dim * S));
  l.G = cg_d2_take(&o, n * l.GS);
  l.B1W = cg_d2_take(&o, cg_d2_up4(S));  // sp_b[1] + mean_i(sp1) W2
  l.Lsp1 = l.V = l.LB = l.W3p = 0;
  if (lap) {
    l.Lsp1 = cg_d2_take(&o, cg_d2_up4(n * S));
    l.V = cg_d2_take(&o, n * l.GS);       // V_l = G_l W2 / n, laid out as G
    l.LB = cg_d2_take(&o, cg_d2_up4(S));  // mean_i(Lsp1) W2
    l.W3p = cg_d2_take(&o, T * l.S4);     // W3 (T x S) with zero pads
  }
  // per warp: row sums (RS), sig1 (S), M (S x dim), R (S4 x dim), N (T x dim),
  // K (C0 x dim), D_i M_i (dim x dim), Q[c][q dim + b] = tp_w[q][c] N[c][b],
  // with the Laplacian Pq_i (C0 x S4)
  l.scr_stride = l.RS + cg_d2_up4(S * dim) + cg_d2_up4(S * dim) + l.S4 * dim +
                 cg_d2_up4(T * dim) + cg_d2_up4(C0 * dim) + cg_d2_up4(dim * dim) + T * l.QW +
                 (lap ? C0 * l.S4 : 0);
  l.scr = cg_d2_take(&o, CG_D2R_WARPS * l.scr_stride);
  l.total = o;
  return l;
}

// SM, TM: compile-time caps of the widths S, T (16 or 32); EX: the widths
// are the caps (then every loop over a width has a compile-time count); NP:
// the pairs a lane owns in a row (1 for n <= 32, else 2); LAP: K6, with the
// Laplacian.
template <int DIM, int SM, int TM, int NP, bool EX, bool LAP>
__global__ void __launch_bounds__(32 * CG_D2R_WARPS, (NP == 1 && !LAP) ? 3 : 2)
cg_flow_d2_rows_kernel(const float* __restrict__ x, const float* __restrict__ params,
                       float* __restrict__ u, float* __restrict__ J, float* __restrict__ lap,
                       int n, int S_, int T_, float L) {
  const int S = EX ? SM : S_, T = EX ? TM : T_;
  extern __shared__ __align__(16) float cg_smem[];
  constexpr int dim = DIM, C0 = 2 * DIM + 1, V1 = cg_fp_pow2(C0 + 3 * DIM);
  constexpr int V1L = cg_fp_pow2(C0 + 6 * DIM);  // K6's second row sum of phase 1
  const int nd = n * dim, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const cg_d2r_layout o = cg_d2r_make_layout(n, dim, S, T, LAP);
  const int SS = o.SS, GS = o.GS, S4 = o.S4, QW = o.QW;
  float* Pm = cg_smem + o.Pm;
  float* W1T = cg_smem + o.W1T;
  float* W2T = cg_smem + o.W2T;
  float* W3T = cg_smem + o.W3T;
  float* W30p = cg_smem + o.W30p;
  float* WTB = cg_smem + o.WTB;
  float* B1W = cg_smem + o.B1W;
  float* xs = cg_smem + o.xs;
  float* sig0 = cg_smem + o.sig0;
  float* sp1 = cg_smem + o.sp1;
  float* Dm = cg_smem + o.D;
  float* G = cg_smem + o.G;
  float* Lsp1 = cg_smem + o.Lsp1;  // the Laplacian's arrays (LAP only)
  float* Vm = cg_smem + o.V;
  float* LB = cg_smem + o.LB;
  float* W3p = cg_smem + o.W3p;
  float* rs = cg_smem + o.scr + warp * o.scr_stride;  // this warp's scratch line
  float* rsL = rs + 32;                               // K6's second row sums
  float* sig1 = rs + o.RS;
  float* Mm = sig1 + cg_d2_up4(S * dim);  // sig1 holds sig1[t] wf[t][b]
  float* Rm = Mm + cg_d2_up4(S * dim);
  float* Nm = Rm + S4 * dim;
  float* Km = Nm + cg_d2_up4(T * dim);
  float* dg = Km + cg_d2_up4(C0 * dim);
  float* Qm = dg + cg_d2_up4(dim * dim);
  float* Pq = Qm + T * QW;  // LAP: Pq_i = diag(sig0_i) W3_0 W1 (C0 x S4)

  const float* w30 = Pm + 2 * dim * S;  // rows of sp_w[0] that meet mean_j tp0
  const float* b0 = Pm + (2 * dim + C0) * S;
  const float* W1 = b0 + S;
  const float* W2 = W1 + S * S;
  const float* W3 = W2 + S * S;
  const float* b1 = W3 + T * S;
  const float* wt = b1 + S;  // tp_w[0] (C0 x T)
  const float* bt = wt + C0 * T;
  const float* wf = bt + T;  // final_w (S x dim)
  const float* bf = wf + S * dim;

  const size_t w = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float k1 = 3.14159265358979323846f / L, k2 = 2.f * k1, invL = 1.f / L;
  const float inv_n = 1.f / (float)n;
  const int P = cg_d2_params(dim, S, T);
  // the weights and x: every thread issues its loads before it stores any,
  // so that the block waits for one trip to memory, not one per element
  for (int base = 0; base < P + nd; base += 8 * nt) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int idx = base + k * nt + tid;
      v[k] = idx < P ? __ldg(params + idx) : idx < P + nd ? __ldg(x + w * nd + idx - P) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int idx = base + k * nt + tid;
      if (idx < P) Pm[idx] = v[k];
      else if (idx < P + nd) xs[idx - P] = v[k];
    }
  }
  // the zero pads of the 4-wide rows
  for (int idx = tid; idx < n * SS; idx += nt) sig0[idx] = 0.f;
  for (int idx = tid; idx < n * GS; idx += nt) G[idx] = 0.f;
  if (LAP)
    for (int idx = tid; idx < n * GS; idx += nt) Vm[idx] = 0.f;
  for (int idx = tid; idx < CG_D2R_WARPS * o.scr_stride; idx += nt) cg_smem[o.scr + idx] = 0.f;
  __syncthreads();
  for (int idx = tid; idx < C0 * S4; idx += nt)
    W30p[idx] = idx % S4 < S ? w30[(idx / S4) * S + idx % S4] : 0.f;
  for (int idx = tid; idx < 8 * T; idx += nt) {
    const int c = idx / 8, q = idx % 8;
    WTB[idx] = q < C0 ? wt[q * T + c] : q == C0 ? bt[c] : 0.f;
  }
  for (int idx = tid; idx < S * S; idx += nt) {
    const int a = idx / S, b = idx % S;
    W1T[b * S + a] = W1[idx];
    W2T[b * S + a] = W2[idx];
  }
  for (int idx = tid; idx < T * S; idx += nt) W3T[(idx % S) * T + idx / S] = W3[idx];
  if (LAP)
    for (int idx = tid; idx < T * S4; idx += nt)
      W3p[idx] = idx % S4 < S ? W3[(idx / S4) * S + idx % S4] : 0.f;

  // ---- phase 1: a warp per row i, the sums over j of the pair features ------------
  for (int i = warp; i < n; i += CG_D2R_WARPS) {
    float part[V1], partL[LAP ? V1L : 1];
#pragma unroll
    for (int v = 0; v < V1; ++v) part[v] = 0.f;
#pragma unroll
    for (int v = 0; v < (LAP ? V1L : 1); ++v) partL[v] = 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int j = lane + 32 * p;
      if (j < n) {
        float e[C0], al[DIM], be[DIM], ga[DIM], hd;
        cg_fp_pair<DIM, LAP>(xs, i, j, L, invL, k1, k2, e, al, be, ga, &hd);
#pragma unroll
        for (int c = 0; c < C0; ++c) part[c] += e[c];
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          part[C0 + d] += al[d];
          part[C0 + DIM + d] += be[d];
          part[C0 + 2 * DIM + d] += ga[d];
        }
        if constexpr (LAP) {
          // the pair's Laplacian of tp0 (zero at j == i), and per coordinate
          // the outer products of (al, be, ga)
          const float m2k = j == i ? 0.f : -2.f * k2 * k2;
#pragma unroll
          for (int c = 0; c < 2 * DIM; ++c) partL[c] += m2k * e[c];
          partL[2 * DIM] += 2.f * hd;
#pragma unroll
          for (int d = 0; d < DIM; ++d) {
            partL[C0 + 6 * d] += al[d] * al[d];
            partL[C0 + 6 * d + 1] += be[d] * be[d];
            partL[C0 + 6 * d + 2] += ga[d] * ga[d];
            partL[C0 + 6 * d + 3] += al[d] * be[d];
            partL[C0 + 6 * d + 4] += al[d] * ga[d];
            partL[C0 + 6 * d + 5] += be[d] * ga[d];
          }
        }
      }
    }
    cg_fp_tree_to<V1>(part, lane, rs);
    if constexpr (LAP) cg_fp_tree_to<V1L>(partL, lane, rsL);
    __syncwarp();
    for (int s = lane; s < S; s += 32) {
      float pre = b0[s];
      for (int c = 0; c < C0; ++c) pre += rs[c] * inv_n * w30[c * S + s];
      const float sg = cg_d2_sigmoid(pre);
      sig0[i * SS + s] = sg;
      sp1[i * S + s] = cg_d2_softplus(pre);
      float lt = 0.f, sq = 0.f;
      if (LAP)
        for (int c = 0; c < C0; ++c) lt += rsL[c] * inv_n * w30[c * S + s];
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        const float wa = w30[d * S + s], wb = w30[(dim + d) * S + s], wg = w30[2 * dim * S + s];
        const float saw = rs[C0 + d] * wa + rs[C0 + DIM + d] * wb + rs[C0 + 2 * DIM + d] * wg;
        Dm[(i * dim + d) * S + s] = sg * saw * inv_n;
        if (LAP) {  // |sum_j A0 W3_0|^2 + sum_j |A0 W3_0|^2, the latter from the outer products
          const float* m = rsL + C0 + 6 * d;
          sq += saw * saw + m[0] * wa * wa + m[1] * wb * wb + m[2] * wg * wg +
                2.f * (m[3] * wa * wb + m[4] * wa * wg + m[5] * wb * wg);
        }
      }
      if (LAP) Lsp1[i * S + s] = sg * lt + sg * (1.f - sg) * sq * inv_n * inv_n;
    }
    __syncwarp();
  }
  __syncthreads();

  // ---- phase 2: a warp per column l, G_l from the mirrored pairs (l, k) --------------
  if (warp == 0) {  // mean_i sp1, and with it the row-independent part of pre1
    float* spmean = rs;
    float* Lmean = rsL;
    for (int s = lane; s < S; s += 32) {
      float m = 0.f, ml = 0.f;
      for (int i = 0; i < n; ++i) {
        m += sp1[i * S + s];
        if (LAP) ml += Lsp1[i * S + s];
      }
      spmean[s] = m * inv_n;
      if (LAP) Lmean[s] = ml * inv_n;
    }
    __syncwarp();
    for (int s2 = lane; s2 < S; s2 += 32) {
      float b = b1[s2], bl = 0.f;
      for (int s = 0; s < S; ++s) {
        b += spmean[s] * W2[s * S + s2];
        if (LAP) bl += Lmean[s] * W2[s * S + s2];
      }
      B1W[s2] = b;
      if (LAP) LB[s2] = bl;
    }
    __syncwarp();
  }
  for (int l = warp; l < n; l += CG_D2R_WARPS) {
    float acc[DIM][SM];
#pragma unroll
    for (int d = 0; d < DIM; ++d)
#pragma unroll
      for (int s = 0; s < SM; ++s) acc[d][s] = 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int k = lane + 32 * p;
      if (k < n && k != l) {
        float e[C0], al[DIM], be[DIM], ga[DIM];
        cg_fp_pair<DIM>(xs, l, k, L, invL, k1, k2, e, al, be, ga);
#pragma unroll
        for (int s0 = 0; s0 < SM; s0 += 4)
          if (s0 < S) {  // four features at a time; the pads are zero
            const float4 sg = *reinterpret_cast<const float4*>(sig0 + k * SS + s0);
#pragma unroll
            for (int d = 0; d < DIM; ++d) {  // A0[k][l] = (-al, be, -ga) of (l, k)
              const float4 wa = *reinterpret_cast<const float4*>(W30p + d * S4 + s0);
              const float4 wb = *reinterpret_cast<const float4*>(W30p + (DIM + d) * S4 + s0);
              const float4 wg = *reinterpret_cast<const float4*>(W30p + 2 * DIM * S4 + s0);
              acc[d][s0] += sg.x * (-al[d] * wa.x + be[d] * wb.x - ga[d] * wg.x);
              acc[d][s0 + 1] += sg.y * (-al[d] * wa.y + be[d] * wb.y - ga[d] * wg.y);
              acc[d][s0 + 2] += sg.z * (-al[d] * wa.z + be[d] * wb.z - ga[d] * wg.z);
              acc[d][s0 + 3] += sg.w * (-al[d] * wa.w + be[d] * wb.w - ga[d] * wg.w);
            }
          }
      }
    }
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      const float g = cg_fp_tree<SM>(acc[d], lane);
      const int s = lane / (32 / SM);
      if ((lane & (32 / SM - 1)) == 0 && s < S)
        G[l * GS + d * S4 + s] = Dm[(l * dim + d) * S + s] - g * inv_n;
    }
    if constexpr (LAP) {  // V_l = G_l W2 / n
      __syncwarp();
      for (int idx = lane; idx < DIM * S; idx += 32) {
        const int d = idx / S, s2 = idx % S;
        float v = 0.f;
        for (int s = 0; s < S; ++s) v += G[l * GS + d * S4 + s] * W2[s * S + s2];
        Vm[l * GS + d * S4 + s2] = v * inv_n;
      }
    }
  }
  __syncthreads();

  // ---- phase 3: a warp per row i, the tp layer and the J blocks of the row ------------
  float* Jw = J + w * nd * nd;
  for (int i = warp; i < n; i += CG_D2R_WARPS) {
    float sigt[NP][TM], al[NP][DIM], be[NP][DIM], ga[NP][DIM], part[TM], partL[LAP ? TM : 1];
#pragma unroll
    for (int c = 0; c < TM; ++c) part[c] = 0.f;
#pragma unroll
    for (int c = 0; c < (LAP ? TM : 1); ++c) partL[c] = 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int l = lane + 32 * p;
#pragma unroll
      for (int c = 0; c < TM; ++c) sigt[p][c] = 0.f;
      if (l < n) {
        float e[C0], hd, ltp[C0];
        cg_fp_pair<DIM, LAP>(xs, i, l, L, invL, k1, k2, e, al[p], be[p], ga[p], &hd);
        if constexpr (LAP) {  // the pair's Laplacian of tp0, zero at l == i
          const float m2k = l == i ? 0.f : -2.f * k2 * k2;
#pragma unroll
          for (int c = 0; c < 2 * DIM; ++c) ltp[c] = m2k * e[c];
          ltp[2 * DIM] = 2.f * hd;
        }
#pragma unroll
        for (int c = 0; c < TM; ++c)
          if (c < T) {
            const float4 wa = *reinterpret_cast<const float4*>(WTB + 8 * c);
            const float4 wb = *reinterpret_cast<const float4*>(WTB + 8 * c + 4);
            const float wq[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
            float pre = wq[C0];
#pragma unroll
            for (int q = 0; q < C0; ++q) pre = fmaf(e[q], wq[q], pre);
            // sigmoid and softplus from one exponential
            const float ez = __expf(-fabsf(pre)), r = __fdividef(1.f, 1.f + ez);
            const float sg = pre >= 0.f ? r : ez * r;
            sigt[p][c] = sg;
            part[c] += fmaxf(pre, 0.f) + __logf(1.f + ez);
            if constexpr (LAP) {  // Ltp1 = sg (Ltp0 wt) + sg (1 - sg) 2 |A0 wt|^2
              float ltw = 0.f, sq = 0.f;
#pragma unroll
              for (int q = 0; q < C0; ++q) ltw = fmaf(ltp[q], wq[q], ltw);
#pragma unroll
              for (int d = 0; d < DIM; ++d) {
                const float awt = al[p][d] * wq[d] + be[p][d] * wq[DIM + d] + ga[p][d] * wq[2 * DIM];
                sq = fmaf(awt, awt, sq);
              }
              partL[c] += sg * ltw + sg * (1.f - sg) * 2.f * sq;
            }
          }
      } else {
#pragma unroll
        for (int d = 0; d < DIM; ++d) al[p][d] = be[p][d] = ga[p][d] = 0.f;
      }
    }
    cg_fp_tree_to<TM>(part, lane, rs);  // sum_j tp1[i][j]
    if constexpr (LAP) cg_fp_tree_to<TM>(partL, lane, rsL);  // sum_j Ltp1[i][j]
    __syncwarp();
    // the final sp layer of row i, and u; with the Laplacian lane s2 keeps
    // Lsp1 + sig1 (Lf W1f) and sig1 (1 - sig1) of feature s2 (S <= 32)
    float ub[DIM], keepL = 0.f, keepG = 0.f;
#pragma unroll
    for (int b = 0; b < DIM; ++b) ub[b] = 0.f;
    for (int s2 = lane; s2 < S; s2 += 32) {
      float pre = B1W[s2];
      for (int s = 0; s < S; ++s) pre += sp1[i * S + s] * W1[s * S + s2];
      for (int c = 0; c < T; ++c) pre += rs[c] * inv_n * W3[c * S + s2];
      const float sg1 = cg_d2_sigmoid(pre);
#pragma unroll
      for (int b = 0; b < DIM; ++b) sig1[s2 * dim + b] = sg1 * wf[s2 * dim + b];
      const float fin = sp1[i * S + s2] + cg_d2_softplus(pre);
#pragma unroll
      for (int b = 0; b < DIM; ++b) ub[b] += fin * wf[s2 * dim + b];
      if (LAP) {
        float lf = LB[s2];
        for (int s = 0; s < S; ++s) lf += Lsp1[i * S + s] * W1[s * S + s2];
        for (int c = 0; c < T; ++c) lf += rsL[c] * inv_n * W3[c * S + s2];
        keepL = Lsp1[i * S + s2] + sg1 * lf;
        keepG = sg1 * (1.f - sg1);
      }
    }
#pragma unroll
    for (int b = 0; b < DIM; ++b) {
      const float tot = cg_fp_allsum(ub[b]);
      if (lane == 0) u[w * nd + i * dim + b] = xs[i * dim + b] + bf[b] + tot;
    }
    __syncwarp();
    // the row's matrices: M = (I + W1 diag(sig1)) wf, R = W2 diag(sig1) wf / n,
    // N = -W3 diag(sig1) wf / n
    for (int idx = lane; idx < (S + T) * dim; idx += 32) {
      const int b = idx % dim, r = idx / dim;
      float acc = 0.f;
      if (r < S) {
        float acc2 = 0.f;
        for (int t = 0; t < S; ++t) {
          const float sw = sig1[t * dim + b];
          acc += W1T[t * S + r] * sw;
          acc2 += W2T[t * S + r] * sw;
        }
        Mm[r * dim + b] = wf[r * dim + b] + acc;
        Rm[r * dim + b] = acc2 * inv_n;
      } else {
        const int c = r - S;
        for (int t = 0; t < S; ++t) acc += W3T[t * T + c] * sig1[t * dim + b];
        Nm[c * dim + b] = -acc * inv_n;
      }
    }
    __syncwarp();
    // K = -W3_0 diag(sig0_i) M / n and D_i M_i
    for (int idx = lane; idx < (C0 + dim) * dim; idx += 32) {
      const int b = idx % dim, r = idx / dim;
      float acc = 0.f;
      if (r < C0) {
        for (int s = 0; s < S; ++s) acc += w30[r * S + s] * sig0[i * SS + s] * Mm[s * dim + b];
        Km[r * dim + b] = -acc * inv_n;
      } else {
        for (int s = 0; s < S; ++s) acc += Dm[(i * dim + r - C0) * S + s] * Mm[s * dim + b];
        dg[(r - C0) * dim + b] = acc;
      }
    }
    for (int idx = lane; idx < T * C0 * dim; idx += 32) {
      const int c = idx / (C0 * dim), r = idx % (C0 * dim);
      Qm[c * QW + r] = wt[(r / dim) * T + c] * Nm[c * dim + r % dim];
    }
    if (LAP)  // Pq_i = diag(sig0_i) W3_0 W1, so that (sig0_i * A0 W3_0) W1 = A0 Pq_i
      for (int idx = lane; idx < C0 * S; idx += 32) {
        const int q = idx / S, s2 = idx % S;
        float acc = 0.f;
        for (int s = 0; s < S; ++s) acc += sig0[i * SS + s] * w30[q * S + s] * W1[s * S + s2];
        Pq[q * S4 + s2] = acc;
      }
    __syncwarp();
    // the blocks (i, l): A0[i][l] K_i + A1[i][l] N_i + G_l R_i
    float blk[NP][DIM][DIM], a1s[DIM][DIM];
#pragma unroll
    for (int a = 0; a < DIM; ++a)
#pragma unroll
      for (int b = 0; b < DIM; ++b) a1s[a][b] = 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int l = lane + 32 * p;
      if (l >= n) continue;
      // accN[q dim + b] = sum_c tp_w[q][c] sig_t[c] N[c][b], from Q four at a time
      constexpr int QWC = (C0 * DIM + 3) & ~3;
      float accN[QWC];
#pragma unroll
      for (int q = 0; q < QWC; ++q) accN[q] = 0.f;
#pragma unroll
      for (int c = 0; c < TM; ++c)
        if (c < T) {
          const float sg = sigt[p][c];
#pragma unroll
          for (int q = 0; q < QWC; q += 4) {
            const float4 v = *reinterpret_cast<const float4*>(Qm + c * QWC + q);
            accN[q] = fmaf(sg, v.x, accN[q]);
            accN[q + 1] = fmaf(sg, v.y, accN[q + 1]);
            accN[q + 2] = fmaf(sg, v.z, accN[q + 2]);
            accN[q + 3] = fmaf(sg, v.w, accN[q + 3]);
          }
        }
#pragma unroll
      for (int a = 0; a < DIM; ++a)
#pragma unroll
        for (int b = 0; b < DIM; ++b) {
          const float a1n = al[p][a] * accN[a * DIM + b] + be[p][a] * accN[(DIM + a) * DIM + b] +
                            ga[p][a] * accN[2 * DIM * DIM + b];
          a1s[a][b] += a1n;
          blk[p][a][b] = al[p][a] * Km[a * dim + b] + be[p][a] * Km[(dim + a) * dim + b] +
                         ga[p][a] * Km[2 * dim * dim + b] + a1n;
        }
#pragma unroll
      for (int s0 = 0; s0 < SM; s0 += 4)
        if (s0 < S) {  // four features at a time; the pads of G and R are zero
          float rr[4 * DIM];
#pragma unroll
          for (int v = 0; v < DIM; ++v) {
            const float4 r4 = *reinterpret_cast<const float4*>(Rm + s0 * DIM + 4 * v);
            rr[4 * v] = r4.x;
            rr[4 * v + 1] = r4.y;
            rr[4 * v + 2] = r4.z;
            rr[4 * v + 3] = r4.w;
          }
#pragma unroll
          for (int a = 0; a < DIM; ++a) {
            const float4 g = *reinterpret_cast<const float4*>(G + l * GS + a * S4 + s0);
#pragma unroll
            for (int b = 0; b < DIM; ++b)
              blk[p][a][b] += g.x * rr[b] + g.y * rr[DIM + b] + g.z * rr[2 * DIM + b] +
                              g.w * rr[3 * DIM + b];
          }
        }
    }
#pragma unroll
    for (int a = 0; a < DIM; ++a)
#pragma unroll
      for (int b = 0; b < DIM; ++b) a1s[a][b] = cg_fp_allsum(a1s[a][b]);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int l = lane + 32 * p;
      if (l >= n) continue;
#pragma unroll
      for (int a = 0; a < DIM; ++a)
#pragma unroll
        for (int b = 0; b < DIM; ++b) {
          float v = blk[p][a][b];
          if (l == i) v += (a == b ? 1.f : 0.f) + dg[a * dim + b] - a1s[a][b];
          Jw[(size_t)(i * dim + b) * nd + l * dim + a] = v;  // row (i, b): a line of nd floats
        }
    }
    if constexpr (LAP) {
      // ---- the Laplacian of row i: U[i][l] from the tp sigmoids in registers
      float q[SM], us[DIM][SM];
#pragma unroll
      for (int s = 0; s < SM; ++s) {
        q[s] = 0.f;
#pragma unroll
        for (int d = 0; d < DIM; ++d) us[d][s] = 0.f;
      }
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int l = lane + 32 * p;
        if (l >= n) continue;
        // X = A0[i][l] Pq_i + A1[i][l] W3, four features at a time (pads zero)
        float X[DIM][SM];
#pragma unroll
        for (int s0 = 0; s0 < SM; s0 += 4)
#pragma unroll
          for (int d = 0; d < DIM; ++d) {
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (s0 < S) {
              const float4 pa = *reinterpret_cast<const float4*>(Pq + d * S4 + s0);
              const float4 pb = *reinterpret_cast<const float4*>(Pq + (DIM + d) * S4 + s0);
              const float4 pg = *reinterpret_cast<const float4*>(Pq + 2 * DIM * S4 + s0);
              v.x = al[p][d] * pa.x + be[p][d] * pb.x + ga[p][d] * pg.x;
              v.y = al[p][d] * pa.y + be[p][d] * pb.y + ga[p][d] * pg.y;
              v.z = al[p][d] * pa.z + be[p][d] * pb.z + ga[p][d] * pg.z;
              v.w = al[p][d] * pa.w + be[p][d] * pb.w + ga[p][d] * pg.w;
            }
            X[d][s0] = v.x;
            X[d][s0 + 1] = v.y;
            X[d][s0 + 2] = v.z;
            X[d][s0 + 3] = v.w;
          }
#pragma unroll
        for (int c = 0; c < TM; ++c)
          if (c < T) {
            const float4 wa = *reinterpret_cast<const float4*>(WTB + 8 * c);
            const float4 wb = *reinterpret_cast<const float4*>(WTB + 8 * c + 4);
            const float wq[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
            float a1[DIM];  // A1[i][l][d][c]
#pragma unroll
            for (int d = 0; d < DIM; ++d)
              a1[d] = sigt[p][c] * (al[p][d] * wq[d] + be[p][d] * wq[DIM + d] + ga[p][d] * wq[2 * DIM]);
#pragma unroll
            for (int s0 = 0; s0 < SM; s0 += 4)
              if (s0 < S) {
                const float4 w3 = *reinterpret_cast<const float4*>(W3p + c * S4 + s0);
#pragma unroll
                for (int d = 0; d < DIM; ++d) {
                  X[d][s0] = fmaf(a1[d], w3.x, X[d][s0]);
                  X[d][s0 + 1] = fmaf(a1[d], w3.y, X[d][s0 + 1]);
                  X[d][s0 + 2] = fmaf(a1[d], w3.z, X[d][s0 + 2]);
                  X[d][s0 + 3] = fmaf(a1[d], w3.w, X[d][s0 + 3]);
                }
              }
          }
        // U = -X / n; the row sums of |U + V_l|^2 and of U
#pragma unroll
        for (int s0 = 0; s0 < SM; s0 += 4)
          if (s0 < S)
#pragma unroll
            for (int d = 0; d < DIM; ++d) {
              const float4 v = *reinterpret_cast<const float4*>(Vm + l * GS + d * S4 + s0);
              const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const float U = -X[d][s0 + k] * inv_n, t = U + vv[k];
                q[s0 + k] = fmaf(t, t, q[s0 + k]);
                us[d][s0 + k] += U;
              }
            }
      }
      // lane s2 takes feature s2 of each sum over the lanes; T_i = -sum_l U[i][l]
      const int from = (lane & (SM - 1)) * (32 / SM);
      float sq1 = __shfl_sync(0xffffffffu, cg_fp_tree<SM>(q, lane), from);
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        const float Td = -__shfl_sync(0xffffffffu, cg_fp_tree<SM>(us[d], lane), from);
        const float vi = lane < S ? Vm[i * GS + d * S4 + lane] : 0.f;
        sq1 += Td * (Td + 2.f * vi);
      }
      const float fin = keepL + keepG * sq1;  // 0 on lanes >= S
#pragma unroll
      for (int b = 0; b < DIM; ++b) {
        const float tot = cg_fp_allsum(lane < S ? fin * wf[lane * dim + b] : 0.f);
        if (lane == 0) lap[w * nd + i * dim + b] = tot;
      }
    }
    __syncwarp();
  }
}

#ifndef CG_CPU_SHIM
template <int DIM, int SM, int TM, int NP, bool EX, bool LAP>
static cudaError_t cg_launch_flow_d2_rows_w(const float* x, const float* params, float* u,
                                            float* J, float* lap, int B, int n, int S, int T,
                                            float L, cudaStream_t st) {
  const int smem = (int)sizeof(float) * cg_d2r_make_layout(n, DIM, S, T, LAP).total;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(cg_flow_d2_rows_kernel<DIM, SM, TM, NP, EX, LAP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  cg_flow_d2_rows_kernel<DIM, SM, TM, NP, EX, LAP><<<B, 32 * CG_D2R_WARPS, smem, st>>>(
      x, params, u, J, lap, n, S, T, L);
  return cudaGetLastError();
}

template <int DIM, bool LAP>
static cudaError_t cg_launch_flow_d2_rows(const float* x, const float* params, float* u,
                                          float* J, float* lap, int B, int n, int S, int T,
                                          float L, cudaStream_t st) {
  // the production widths 16/16 at their own instantiations, any other
  // widths up to 32 at one with run-time widths
  if (S != 16 || T != 16)
    return cg_launch_flow_d2_rows_w<DIM, 32, 32, 2, false, LAP>(x, params, u, J, lap, B, n, S, T,
                                                                L, st);
  if (n <= 32)
    return cg_launch_flow_d2_rows_w<DIM, 16, 16, 1, true, LAP>(x, params, u, J, lap, B, n, S, T,
                                                               L, st);
  return cg_launch_flow_d2_rows_w<DIM, 16, 16, 2, true, LAP>(x, params, u, J, lap, B, n, S, T, L,
                                                             st);
}

template <bool LAP>
static int cg_launch_flow_d2(const float* x, const float* params, float* u, float* J, float* lap,
                             int B, int n, int dim, int S, int T, float L, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dim) {
    case 1: return (int)cg_launch_flow_d2_rows<1, LAP>(x, params, u, J, lap, B, n, S, T, L, st);
    case 2: return (int)cg_launch_flow_d2_rows<2, LAP>(x, params, u, J, lap, B, n, S, T, L, st);
    case 3: return (int)cg_launch_flow_d2_rows<3, LAP>(x, params, u, J, lap, B, n, S, T, L, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" {

int cg_flow_d2_param_count(int dim, int S, int T) { return cg_d2_params(dim, S, T); }

// Shared memory of one block in bytes of K5 (lap = 0) or K6 (lap = 1); -1
// where n, dim or a width is beyond what the kernel takes (n <= 64, dim <= 3,
// widths <= 32: a lane owns at most two pairs of a row, and the row sums and
// feature loops hold at most 32 values a lane).
int cg_flow_d2_smem(int n, int dim, int S, int T, int lap) {
  if (dim < 1 || dim > CG_D2_MAXDIM || n < 1 || S < 1 || T < 1) return -1;
  if (n > CG_D2R_MAXN || S > CG_D2R_MAXW || T > CG_D2R_MAXW) return -1;
  return (int)sizeof(float) * cg_d2r_make_layout(n, dim, S, T, lap != 0).total;
}

// x (B, n, dim), params packed as above, u (B, n, dim), J (B, nd, nd); all
// contiguous f32, on the given stream.  Returns the CUDA error, else 0.
int cg_flow_d2_u_jac(const float* x, const float* params, float* u, float* J, int B, int n,
                     int dim, int S, int T, float L, void* stream) {
  if (B <= 0) return 0;
  if (cg_flow_d2_smem(n, dim, S, T, 0) < 0) return (int)cudaErrorInvalidValue;
  return cg_launch_flow_d2<false>(x, params, u, J, nullptr, B, n, dim, S, T, L, stream);
}

// The same plus lap (B, nd).
int cg_flow_d2_u_jac_lap(const float* x, const float* params, float* u, float* J, float* lap,
                         int B, int n, int dim, int S, int T, float L, void* stream) {
  if (B <= 0) return 0;
  if (cg_flow_d2_smem(n, dim, S, T, 1) < 0) return (int)cudaErrorInvalidValue;
  return cg_launch_flow_d2<true>(x, params, u, J, lap, B, n, dim, S, T, L, stream);
}

}  // extern "C"
#endif
