// Depth-2 FermiNet flow forward + coordinate Jacobian in its carried form:
// layer 0's Jacobian per pair, then layer 1's recurrence on it.  The rows of
// a walker couple only through two means over rows.
//
//   x (B, n, dim)  ->  u (B, n, dim),  J (B, nd, nd)   rows (i, b), cols (l, a)
//
// Replaces: coulombgas_tpu/ops/pallas_flow_jac.py, flow_u_jac_pallas_large
// (:367), whose two kernels _layer0_kernel (:280, pallas_call at :403) and
// _final_layer_kernel (:325, pallas_call at :445) meet through two XLA means
// over rows.  Plain version: ops/cuda_flow_large.py:flow_u_jac_large_ref.
// The mathematics:
//
//   layer 0   tp0[i][j] = [cos k2 r, sin k2 r, |sin k1 r|],  A0[i][j] = d tp0 / d x_i
//             (the conjugate block is -A0; A0[i][i] = 0);  sp and mean sp are
//             zero, so only the rows [2 dim, 2 dim + C0) of sp_w[0] (W30) act:
//             pre = mean_j tp0[i][j] W30 + b0,  sp1 = softplus(pre),
//             Jsp1[i][l] = sigmoid(pre) (delta_il sum_j AW_ij - AW_il) / n,
//             AW = A0 W30
//   means     spmean = mean_i sp1,  jmean = mean_i Jsp1
//   layer 1   tp1 = softplus(tp0 Wt + bt),  A1 = sigmoid(tp0 Wt + bt) (A0 Wt),
//             pre = sp1 W1a + spmean W1b + mean_j tp1 W1c + b1  (W1 = sp_w[1] cut
//             at rows S and 2 S),  sp = sp1 + softplus(pre),
//             Jsp = Jsp1 + sigmoid(pre) (Jsp1 W1a + jmean W1b
//                                        + (delta_il sum_j AW1_ij - AW1_il) / n),
//             AW1 = A1 W1c
//   head      u = x + sp Wf + bf,  J = I + Jsp Wf
//
// Bound on this card: operations.  What must move is x in and u, J out (27 MB
// at n = 57, batch 512); the function needs about 10 Mflop a walker there
// (5.20 Gflop at batch 512, chip_smoke.py:large_flops; Jsp1 W1a and A1 W1c
// are 2 dim S^2 and 2 dim T S flops a pair), 0.0777 ms at the f32 rate of
// 67 TFLOP/s, against 0.008 ms for the bytes at 3.35 TB/s.
//
// Design: one launch, one block of CG_LG_WARPS warps per walker, three
// phases with a block barrier between each two (the one between phases 1
// and 2 takes the place of the boundary between the TPU's two kernels) and
// one after the weights are loaded.  A lane
// owns the pairs (i, lane) and (i, lane + 32) of its warp's row or column
// (so n <= 64) and makes their features in registers from one sincos a
// coordinate (flow_pair.cuh); no pair table and no Jacobian state exist
// outside registers: shared memory holds O(n S) floats a walker (the rows'
// sig0, sp1 and diagonal Jsp1 blocks, jmean W1b, the weights), and device
// memory sees x and the weights read and u and J written, nothing else.
//   1. a warp per row i: the sums over j of tp0 and of A0's entries (a
//      shuffle tree) -> sig0_i, sp1_i and the diagonal block
//      D_i = Jsp1[i][i] = sig0_i (sum_j A0_ij) W30 / n;
//   2. a warp per column l: jmean[l] = (1/n) sum_k Jsp1[k][l], lane k
//      rebuilding Jsp1[k][l] = -sig0_k (A0[k][l] W30) / n from the pair
//      (k, l) (D_l where k = l), summed over lanes by a shuffle tree, then
//      jW[l] = jmean[l] W1b into shared memory; one warp also forms
//      mean_i sp1 (ascending i) and the row-independent b1 + spmean W1b;
//   3. a warp per row i: the tp layer once per pair, its sigmoids kept in
//      registers, the row sums of tp1 and A1 (shuffle trees) -> sig1_i, u_i
//      and sum_l AW1[i][l]; then per pair (i, l), in registers, the
//      carried recurrence Jsp[i][l] = Jsp1 + sig1 (Jsp1 W1a + jW[l] +
//      (delta sum AW1 - AW1_il) / n), Jsp1[i][l] rebuilt from the pair's
//      A0 entries, and J's block (i, l) = delta + Jsp[i][l] Wf, which lane
//      l stores into the rows (i, b) of J: a warp writes each row of J as
//      one run of contiguous floats, from registers.
// Every sum has a fixed order (lanes: cg_fp_tree; rows: ascending in one
// thread); no atomics, so a walker's result does not depend on its batch.
// tests/test_torch_flow_large_rows.py holds a numpy model of this order.
// The production widths 16/16 have instantiations of their own (every loop
// over a width has a compile-time count), held to 128 registers a thread
// for two blocks an SM (three spilled at n <= 32 and ran 18 % slower on an
// H100); other widths up to 32 run one with run-time widths.
#include <cuda_runtime.h>
#include <math.h>

#include "flow_pair.cuh"

#define CG_LG_MAXDIM 3
#define CG_LG_WARPS 8
#define CG_LG_MAXN 64
#define CG_LG_MAXW 32

__host__ __device__ inline int cg_lg_up4(int v) { return (v + 3) & ~3; }

// The weights of a depth-2 flow, each a contiguous f32 array in the layout of
// models/ferminet.py (w: in x out, row-major), in the order the kernel packs
// them into shared memory: sp_w[0] ((2 dim + C0) x S), sp_b[0], sp_w[1]
// ((2 S + T) x S), sp_b[1], tp_w[0] (C0 x T), tp_b[0], final_w (S x dim),
// final_b.
struct cg_lg_weights {
  const float* p[8];
};

__host__ __device__ inline void cg_lg_lengths(int dim, int S, int T, int (&len)[8]) {
  const int C0 = 2 * dim + 1;
  len[0] = (2 * dim + C0) * S;
  len[1] = S;
  len[2] = (2 * S + T) * S;
  len[3] = S;
  len[4] = C0 * T;
  len[5] = T;
  len[6] = S * dim;
  len[7] = dim;
}

__host__ __device__ inline int cg_lg_params(int dim, int S, int T) {
  int len[8], P = 0;
  cg_lg_lengths(dim, S, T, len);
  for (int k = 0; k < 8; ++k) P += len[k];
  return P;
}

__device__ inline float cg_lg_sigmoid(float x) { return 1.f / (1.f + expf(-x)); }
// log(1 + e^x) = max(x, 0) + log1p(e^-|x|): logaddexp(x, 0), no threshold.
__device__ inline float cg_lg_softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__host__ __device__ inline int cg_lg_take(int* o, int k) {
  const int r = *o;
  *o += k;
  return r;
}

// Offsets (in floats) of the kernel's shared arrays.  Rows read 4 features
// at a time are zero-padded to S4 = S rounded up to 4; rows that the lanes of
// a warp read at different row indices (sig0 in phase 2, jW in phase 3) have
// an odd number of 16-byte groups as their stride.
struct cg_lg_layout {
  int Pm, W30p, W1ap, W1cp, WTB, WFp, xs, sig0, D, sp1, jW, B1, scr;
  int S4, SS, GS, scr_stride, total;
};

__host__ __device__ inline cg_lg_layout cg_lg_make_layout(int n, int dim, int S, int T) {
  const int C0 = 2 * dim + 1;
  cg_lg_layout l;
  int o = 0;
  l.S4 = cg_lg_up4(S);
  l.SS = cg_fp_stride4(S);
  l.GS = cg_fp_stride4(dim * l.S4);
  l.Pm = cg_lg_take(&o, cg_lg_up4(cg_lg_params(dim, S, T)));
  l.W30p = cg_lg_take(&o, C0 * l.S4);  // W30 (C0 x S4)
  l.W1ap = cg_lg_take(&o, S * l.S4);   // W1a (S x S4)
  l.W1cp = cg_lg_take(&o, T * l.S4);   // W1c (T x S4)
  l.WTB = cg_lg_take(&o, 8 * T);       // WTB[c] = (tp_w[0..C0)[c], tp_b[c], 0...)
  l.WFp = cg_lg_take(&o, 4 * S);       // WFp[s] = (final_w[s][0..dim), 0...)
  l.xs = cg_lg_take(&o, cg_lg_up4(n * dim));
  l.sig0 = cg_lg_take(&o, n * l.SS);
  l.D = cg_lg_take(&o, n * dim * l.S4);  // D_i = Jsp1[i][i] (dim x S4)
  l.sp1 = cg_lg_take(&o, cg_lg_up4(n * S));
  l.jW = cg_lg_take(&o, n * l.GS);       // jmean[l] W1b (dim x S4)
  l.B1 = cg_lg_take(&o, l.S4);           // sp_b[1] + spmean W1b
  // per warp: row sums (32), the lanes' sums of jmean (phase 2) or of A1
  // (phase 3) (dim x 32), sig1 (S4), sum_l AW1[i][l] (dim x S4)
  l.scr_stride = 32 + dim * 32 + l.S4 + dim * l.S4;
  l.scr = cg_lg_take(&o, CG_LG_WARPS * l.scr_stride);
  l.total = o;
  return l;
}

// Weight g of the packed order, read from the array that holds it.
__device__ inline float cg_lg_weight(const cg_lg_weights& wts, const int (&len)[8], int g) {
  const float* src = wts.p[7];
  bool found = false;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (!found && g < len[k]) {
      src = wts.p[k];
      found = true;
    } else if (!found) {
      g -= len[k];
    }
  }
  return __ldg(src + g);
}

// Jsp1[k][l] for four features s0..s0+3 of a pair (k, l) whose A0[k][l]
// entries a lane holds: D_k where k = l, else -sig0_k (A0[k][l] W30) / n.
// sg: sig0_k, Dk: D_k (dim x S4); the pads of W30p, sig0 and D are zero.
template <int DIM>
__device__ __forceinline__ void cg_lg_jsp1(const float* W30p, int S4, int s0, const float* sg,
                                           const float* Dk, const float (&al)[DIM],
                                           const float (&be)[DIM], const float (&ga)[DIM],
                                           bool diag, float inv_n, float (&j1)[DIM][4]) {
  const float4 g = *reinterpret_cast<const float4*>(sg + s0);
  const float sgv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    const float4 wa = *reinterpret_cast<const float4*>(W30p + d * S4 + s0);
    const float4 wb = *reinterpret_cast<const float4*>(W30p + (DIM + d) * S4 + s0);
    const float4 wg = *reinterpret_cast<const float4*>(W30p + 2 * DIM * S4 + s0);
    const float4 dd = *reinterpret_cast<const float4*>(Dk + d * S4 + s0);
    const float wav[4] = {wa.x, wa.y, wa.z, wa.w}, wbv[4] = {wb.x, wb.y, wb.z, wb.w};
    const float wgv[4] = {wg.x, wg.y, wg.z, wg.w}, ddv[4] = {dd.x, dd.y, dd.z, dd.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float aw = al[d] * wav[q] + be[d] * wbv[q] + ga[d] * wgv[q];
      j1[d][q] = diag ? ddv[q] : -sgv[q] * aw * inv_n;
    }
  }
}

// SM, TM: compile-time caps of the widths S, T (16 or 32); EX: the widths
// are the caps; NP: the pairs a lane owns in a row or column (1 for n <= 32,
// else 2).
template <int DIM, int SM, int TM, int NP, bool EX>
__global__ void __launch_bounds__(32 * CG_LG_WARPS, EX ? 2 : 1)
cg_flow_large_kernel(const float* __restrict__ x, const cg_lg_weights wts,
                     float* __restrict__ u, float* __restrict__ J, int n, int S_, int T_,
                     float L) {
  const int S = EX ? SM : S_, T = EX ? TM : T_;
  extern __shared__ __align__(16) float cg_smem[];
  constexpr int dim = DIM, C0 = 2 * DIM + 1, V1 = cg_fp_pow2(C0 + 3 * DIM);
  const int nd = n * dim, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const cg_lg_layout o = cg_lg_make_layout(n, dim, S, T);
  const int S4 = o.S4, SS = o.SS, GS = o.GS;
  float* Pm = cg_smem + o.Pm;
  float* W30p = cg_smem + o.W30p;
  float* W1ap = cg_smem + o.W1ap;
  float* W1cp = cg_smem + o.W1cp;
  float* WTB = cg_smem + o.WTB;
  float* WFp = cg_smem + o.WFp;
  float* xs = cg_smem + o.xs;
  float* sig0 = cg_smem + o.sig0;
  float* Dm = cg_smem + o.D;
  float* sp1 = cg_smem + o.sp1;
  float* jW = cg_smem + o.jW;
  float* B1 = cg_smem + o.B1;
  float* rs = cg_smem + o.scr + warp * o.scr_stride;  // this warp's scratch line
  float* lsum = rs + 32;                              // dim rows of 32
  float* sig1 = lsum + dim * 32;
  float* sAW1 = sig1 + S4;

  const float* w30 = Pm + 2 * dim * S;  // rows of sp_w[0] that meet mean_j tp0
  const float* b0 = Pm + (2 * dim + C0) * S;
  const float* W1a = b0 + S;  // sp_w[1]: rows for sp, mean sp, mean tp
  const float* W1b = W1a + S * S;
  const float* W1c = W1b + S * S;
  const float* b1 = W1c + T * S;
  const float* wt = b1 + S;  // tp_w[0] (C0 x T)
  const float* bt = wt + C0 * T;
  const float* wf = bt + T;  // final_w (S x dim)
  const float* bf = wf + S * dim;

  const size_t w = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float k1 = 3.14159265358979323846f / L, k2 = 2.f * k1, invL = 1.f / L;
  const float inv_n = 1.f / (float)n;
  int len[8];
  cg_lg_lengths(dim, S, T, len);
  const int P = cg_lg_params(dim, S, T);

  // the weights and x: every thread issues its loads before it stores any,
  // and the padded arrays start as zeros
  for (int base = 0; base < P + nd; base += 8 * nt) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int g = base + k * nt + tid;
      v[k] = g < P ? cg_lg_weight(wts, len, g) : g < P + nd ? __ldg(x + w * nd + g - P) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int g = base + k * nt + tid;
      if (g < P) Pm[g] = v[k];
      else if (g < P + nd) xs[g - P] = v[k];
    }
  }
  for (int idx = o.W30p + tid; idx < o.xs; idx += nt) cg_smem[idx] = 0.f;
  for (int idx = o.sig0 + tid; idx < o.total; idx += nt) cg_smem[idx] = 0.f;
  __syncthreads();
  for (int idx = tid; idx < C0 * S; idx += nt) W30p[(idx / S) * S4 + idx % S] = w30[idx];
  for (int idx = tid; idx < S * S; idx += nt) W1ap[(idx / S) * S4 + idx % S] = W1a[idx];
  for (int idx = tid; idx < T * S; idx += nt) W1cp[(idx / S) * S4 + idx % S] = W1c[idx];
  for (int idx = tid; idx < T * (C0 + 1); idx += nt) {
    const int c = idx / (C0 + 1), q = idx % (C0 + 1);
    WTB[8 * c + q] = q < C0 ? wt[q * T + c] : bt[c];
  }
  for (int idx = tid; idx < S * dim; idx += nt) WFp[(idx / dim) * 4 + idx % dim] = wf[idx];

  // ---- phase 1: a warp per row i, the sums over j of the pair features ------------
  for (int i = warp; i < n; i += CG_LG_WARPS) {
    float part[V1];
#pragma unroll
    for (int v = 0; v < V1; ++v) part[v] = 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int j = lane + 32 * p;
      if (j < n) {
        float e[C0], al[DIM], be[DIM], ga[DIM];
        cg_fp_pair<DIM>(xs, i, j, L, invL, k1, k2, e, al, be, ga);
#pragma unroll
        for (int c = 0; c < C0; ++c) part[c] += e[c];
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          part[C0 + d] += al[d];
          part[C0 + DIM + d] += be[d];
          part[C0 + 2 * DIM + d] += ga[d];
        }
      }
    }
    cg_fp_tree_to<V1>(part, lane, rs);
    __syncwarp();
    for (int s = lane; s < S; s += 32) {
      float pre = b0[s];
      for (int c = 0; c < C0; ++c) pre += rs[c] * inv_n * w30[c * S + s];
      const float sg = cg_lg_sigmoid(pre);
      sig0[i * SS + s] = sg;
      sp1[i * S + s] = cg_lg_softplus(pre);
#pragma unroll
      for (int d = 0; d < DIM; ++d) {  // (sum_j A0[i][j]) W30
        const float saw = rs[C0 + d] * w30[d * S + s] + rs[C0 + DIM + d] * w30[(dim + d) * S + s] +
                          rs[C0 + 2 * DIM + d] * w30[2 * dim * S + s];
        Dm[(i * dim + d) * S4 + s] = sg * saw * inv_n;
      }
    }
    __syncwarp();
  }
  __syncthreads();

  // ---- phase 2: a warp per column l, jmean[l] = mean_k Jsp1[k][l] ------------------
  if (warp == CG_LG_WARPS - 1) {  // mean_i sp1 (ascending i) and b1 + spmean W1b
    for (int s = lane; s < S; s += 32) {
      float m = 0.f;
      for (int i = 0; i < n; ++i) m += sp1[i * S + s];
      rs[s] = m * inv_n;
    }
    __syncwarp();
    for (int s2 = lane; s2 < S; s2 += 32) {
      float b = b1[s2];
      for (int s = 0; s < S; ++s) b += rs[s] * W1b[s * S + s2];
      B1[s2] = b;
    }
    __syncwarp();
  }
  for (int l = warp; l < n; l += CG_LG_WARPS) {
    float acc[DIM][SM];
#pragma unroll
    for (int d = 0; d < DIM; ++d)
#pragma unroll
      for (int s = 0; s < SM; ++s) acc[d][s] = 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int k = lane + 32 * p;
      if (k < n) {
        float e[C0], al[DIM], be[DIM], ga[DIM];  // A0[k][l] from the pair (k, l)
        cg_fp_pair<DIM>(xs, k, l, L, invL, k1, k2, e, al, be, ga);
        const bool diag = k == l;
#pragma unroll
        for (int s0 = 0; s0 < SM; s0 += 4)
          if (s0 < S) {  // four features at a time
            float j1[DIM][4];
            cg_lg_jsp1<DIM>(W30p, S4, s0, sig0 + k * SS, Dm + l * DIM * S4, al, be, ga, diag,
                            inv_n, j1);
#pragma unroll
            for (int d = 0; d < DIM; ++d)
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[d][s0 + q] += j1[d][q];
          }
      }
    }
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      const float g = cg_fp_tree<SM>(acc[d], lane);
      const int s = lane / (32 / SM);
      if ((lane & (32 / SM - 1)) == 0 && s < S) lsum[d * 32 + s] = g * inv_n;
    }
    __syncwarp();
    for (int idx = lane; idx < DIM * S; idx += 32) {  // jW[l] = jmean[l] W1b
      const int d = idx / S, s2 = idx % S;
      float v = 0.f;
      for (int s = 0; s < S; ++s) v += lsum[d * 32 + s] * W1b[s * S + s2];
      jW[l * GS + d * S4 + s2] = v;
    }
    __syncwarp();
  }
  __syncthreads();

  // ---- phase 3: a warp per row i, layer 1 and the row's J blocks ------------------
  float* Jw = J + w * nd * nd;
  for (int i = warp; i < n; i += CG_LG_WARPS) {
    float sigt[NP][TM], al[NP][DIM], be[NP][DIM], ga[NP][DIM];
    {
      float part[TM], pa[DIM][TM];  // the lanes' sums of tp1[i][l] and A1[i][l]
#pragma unroll
      for (int c = 0; c < TM; ++c) {
        part[c] = 0.f;
#pragma unroll
        for (int d = 0; d < DIM; ++d) pa[d][c] = 0.f;
      }
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int l = lane + 32 * p;
#pragma unroll
        for (int c = 0; c < TM; ++c) sigt[p][c] = 0.f;
        if (l < n) {
          float e[C0];
          cg_fp_pair<DIM>(xs, i, l, L, invL, k1, k2, e, al[p], be[p], ga[p]);
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
#pragma unroll
              for (int d = 0; d < DIM; ++d)
                pa[d][c] += sg * (al[p][d] * wq[d] + be[p][d] * wq[DIM + d] + ga[p][d] * wq[2 * DIM]);
            }
        } else {
#pragma unroll
          for (int d = 0; d < DIM; ++d) al[p][d] = be[p][d] = ga[p][d] = 0.f;
        }
      }
      cg_fp_tree_to<TM>(part, lane, rs);  // sum_l tp1[i][l]
#pragma unroll
      for (int d = 0; d < DIM; ++d) cg_fp_tree_to<TM>(pa[d], lane, lsum + d * 32);  // sum_l A1[i][l]
    }
    __syncwarp();
    // sum_l AW1[i][l] = (sum_l A1[i][l]) W1c, then the final sp layer of row i and u
    for (int idx = lane; idx < DIM * S; idx += 32) {
      const int d = idx / S, s2 = idx % S;
      float a = 0.f;
      for (int c = 0; c < T; ++c) a += lsum[d * 32 + c] * W1c[c * S + s2];
      sAW1[d * S4 + s2] = a;
    }
    float ub[DIM];
#pragma unroll
    for (int b = 0; b < DIM; ++b) ub[b] = 0.f;
    for (int s2 = lane; s2 < S; s2 += 32) {
      float pre = B1[s2];
      for (int s = 0; s < S; ++s) pre += sp1[i * S + s] * W1a[s * S + s2];
      for (int c = 0; c < T; ++c) pre += rs[c] * inv_n * W1c[c * S + s2];
      sig1[s2] = cg_lg_sigmoid(pre);
      const float fin = sp1[i * S + s2] + cg_lg_softplus(pre);
#pragma unroll
      for (int b = 0; b < DIM; ++b) ub[b] += fin * wf[s2 * dim + b];
    }
#pragma unroll
    for (int b = 0; b < DIM; ++b) {
      const float tot = cg_fp_allsum(ub[b]);
      if (lane == 0) u[w * nd + i * dim + b] = xs[i * dim + b] + bf[b] + tot;
    }
    __syncwarp();
    // the pairs (i, l): Jsp[i][l] in registers, then J's block (i, l)
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int l = lane + 32 * p;
      if (l >= n) continue;
      const bool diag = l == i;
      // acc = jmean[l] W1b + delta_il sum AW1 / n, then + Jsp1 W1a - A1 W1c / n
      float acc[DIM][SM];
#pragma unroll
      for (int s0 = 0; s0 < SM; s0 += 4)
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (s0 < S) {
            const float4 jw = *reinterpret_cast<const float4*>(jW + l * GS + d * S4 + s0);
            const float4 sa = *reinterpret_cast<const float4*>(sAW1 + d * S4 + s0);
            const float dn = diag ? inv_n : 0.f;
            v = make_float4(fmaf(sa.x, dn, jw.x), fmaf(sa.y, dn, jw.y), fmaf(sa.z, dn, jw.z),
                            fmaf(sa.w, dn, jw.w));
          }
          acc[d][s0] = v.x;
          acc[d][s0 + 1] = v.y;
          acc[d][s0 + 2] = v.z;
          acc[d][s0 + 3] = v.w;
        }
      // Jsp1[i][l] = D_i where l = i, else -sig0_i (A0[i][l] W30) / n, four
      // features at a time; each feature s adds Jsp1[.][s] W1a[s][.]
#pragma unroll
      for (int s0 = 0; s0 < SM; s0 += 4)
        if (s0 < S) {
          float j1[DIM][4];
          cg_lg_jsp1<DIM>(W30p, S4, s0, sig0 + i * SS, Dm + i * DIM * S4, al[p], be[p], ga[p],
                          diag, inv_n, j1);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (EX || s0 + q < S) {
              const float* wrow = W1ap + (s0 + q) * S4;
#pragma unroll
              for (int t0 = 0; t0 < SM; t0 += 4)
                if (t0 < S) {
                  const float4 wv = *reinterpret_cast<const float4*>(wrow + t0);
#pragma unroll
                  for (int d = 0; d < DIM; ++d) {
                    acc[d][t0] = fmaf(j1[d][q], wv.x, acc[d][t0]);
                    acc[d][t0 + 1] = fmaf(j1[d][q], wv.y, acc[d][t0 + 1]);
                    acc[d][t0 + 2] = fmaf(j1[d][q], wv.z, acc[d][t0 + 2]);
                    acc[d][t0 + 3] = fmaf(j1[d][q], wv.w, acc[d][t0 + 3]);
                  }
                }
            }
        }
      // - A1[i][l] W1c / n, A1[i][l][d][c] = sigt[c] (A0[i][l] Wt)[d][c]
#pragma unroll
      for (int c = 0; c < TM; ++c)
        if (c < T) {
          const float4 wa = *reinterpret_cast<const float4*>(WTB + 8 * c);
          const float4 wb = *reinterpret_cast<const float4*>(WTB + 8 * c + 4);
          const float wq[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
          float a1[DIM];
#pragma unroll
          for (int d = 0; d < DIM; ++d)
            a1[d] = -sigt[p][c] * (al[p][d] * wq[d] + be[p][d] * wq[DIM + d] + ga[p][d] * wq[2 * DIM]) *
                    inv_n;
          const float* wrow = W1cp + c * S4;
#pragma unroll
          for (int t0 = 0; t0 < SM; t0 += 4)
            if (t0 < S) {
              const float4 wv = *reinterpret_cast<const float4*>(wrow + t0);
#pragma unroll
              for (int d = 0; d < DIM; ++d) {
                acc[d][t0] = fmaf(a1[d], wv.x, acc[d][t0]);
                acc[d][t0 + 1] = fmaf(a1[d], wv.y, acc[d][t0 + 1]);
                acc[d][t0 + 2] = fmaf(a1[d], wv.z, acc[d][t0 + 2]);
                acc[d][t0 + 3] = fmaf(a1[d], wv.w, acc[d][t0 + 3]);
              }
            }
        }
      // Jsp = Jsp1 + sig1 acc (Jsp1 rebuilt), blk[a][b] = sum_s Jsp[a][s] wf[s][b]
      float blk[DIM][DIM];
#pragma unroll
      for (int a = 0; a < DIM; ++a)
#pragma unroll
        for (int b = 0; b < DIM; ++b) blk[a][b] = 0.f;
#pragma unroll
      for (int s0 = 0; s0 < SM; s0 += 4)
        if (s0 < S) {
          float j1[DIM][4];
          cg_lg_jsp1<DIM>(W30p, S4, s0, sig0 + i * SS, Dm + i * DIM * S4, al[p], be[p], ga[p],
                          diag, inv_n, j1);
          const float4 s1 = *reinterpret_cast<const float4*>(sig1 + s0);
          const float s1v[4] = {s1.x, s1.y, s1.z, s1.w};
#pragma unroll
          for (int d = 0; d < DIM; ++d) {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (EX || s0 + q < S) {
                const float jsp = fmaf(s1v[q], acc[d][s0 + q], j1[d][q]);
                const float4 f = *reinterpret_cast<const float4*>(WFp + 4 * (s0 + q));
                const float fv[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
                for (int b = 0; b < DIM; ++b) blk[d][b] = fmaf(jsp, fv[b], blk[d][b]);
              }
          }
        }
      // J[(i, b), (l, a)] = delta + blk[a][b]: lane l's dim floats of each row (i, b)
#pragma unroll
      for (int b = 0; b < DIM; ++b) {
        float* row = Jw + (size_t)(i * dim + b) * nd + l * dim;
        if constexpr (DIM == 2) {
          *reinterpret_cast<float2*>(row) =
              make_float2(blk[0][b] + (diag && b == 0 ? 1.f : 0.f),
                          blk[1][b] + (diag && b == 1 ? 1.f : 0.f));
        } else {
#pragma unroll
          for (int a = 0; a < DIM; ++a) row[a] = blk[a][b] + (diag && a == b ? 1.f : 0.f);
        }
      }
    }
    __syncwarp();  // the warp's scratch line is rewritten for its next row
  }
}

#ifndef CG_CPU_SHIM
template <int DIM, int SM, int TM, int NP, bool EX>
static cudaError_t cg_launch_large_w(const float* x, const cg_lg_weights& wts, float* u, float* J,
                                     int B, int n, int S, int T, float L, cudaStream_t st) {
  const int smem = (int)sizeof(float) * cg_lg_make_layout(n, DIM, S, T).total;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(cg_flow_large_kernel<DIM, SM, TM, NP, EX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  cg_flow_large_kernel<DIM, SM, TM, NP, EX><<<B, 32 * CG_LG_WARPS, smem, st>>>(x, wts, u, J, n, S,
                                                                              T, L);
  return cudaGetLastError();
}

template <int DIM>
static cudaError_t cg_launch_large(const float* x, const cg_lg_weights& wts, float* u, float* J,
                                   int B, int n, int S, int T, float L, cudaStream_t st) {
  // the production widths 16/16 at their own instantiations, any other
  // widths up to 32 at one with run-time widths
  if (S != 16 || T != 16)
    return cg_launch_large_w<DIM, 32, 32, 2, false>(x, wts, u, J, B, n, S, T, L, st);
  if (n <= 32) return cg_launch_large_w<DIM, 16, 16, 1, true>(x, wts, u, J, B, n, S, T, L, st);
  return cg_launch_large_w<DIM, 16, 16, 2, true>(x, wts, u, J, B, n, S, T, L, st);
}

extern "C" {

// Shared memory of one block in bytes; -1 where n, dim or a width is beyond
// what the kernel takes (n <= 64, dim <= 3, widths <= 32: a lane owns at
// most two pairs of a row, and its feature loops hold at most 32 values).
int cg_flow_large_smem(int n, int dim, int S, int T) {
  if (dim < 1 || dim > CG_LG_MAXDIM || n < 1 || S < 1 || T < 1) return -1;
  if (n > CG_LG_MAXN || S > CG_LG_MAXW || T > CG_LG_MAXW) return -1;
  return (int)sizeof(float) * cg_lg_make_layout(n, dim, S, T).total;
}

// x (B, n, dim); the eight weight arrays in the order of cg_lg_weights;
// u (B, n, dim), J (B, nd, nd); all contiguous f32, on the given stream.
// One launch.  Returns the CUDA error, else 0.
int cg_flow_large(const float* x, const float* sp_w0, const float* sp_b0, const float* sp_w1,
                  const float* sp_b1, const float* tp_w0, const float* tp_b0,
                  const float* final_w, const float* final_b, float* u, float* J, int B, int n,
                  int dim, int S, int T, float L, void* stream) {
  if (B <= 0) return 0;
  if (cg_flow_large_smem(n, dim, S, T) < 0) return (int)cudaErrorInvalidValue;
  const cg_lg_weights wts = {{sp_w0, sp_b0, sp_w1, sp_b1, tp_w0, tp_b0, final_w, final_b}};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dim) {
    case 1: return (int)cg_launch_large<1>(x, wts, u, J, B, n, S, T, L, st);
    case 2: return (int)cg_launch_large<2>(x, wts, u, J, B, n, S, T, L, st);
    case 3: return (int)cg_launch_large<3>(x, wts, u, J, B, n, S, T, L, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
#endif
