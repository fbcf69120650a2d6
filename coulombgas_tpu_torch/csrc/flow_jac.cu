// FermiNet flow forward + analytic coordinate Jacobian for a walker batch.
//
//   x (B, n, dim)  ->  u (B, n, dim),  J (B, nd, nd)   rows (i, b), cols (l, a)
//   J[(i,b),(l,a)] = d u[i][b] / d x[l][a]
//
// Replaces: coulombgas_tpu/ops/pallas_flow_jac.py, _flow_jac_kernel (entry
// point flow_u_jac_pallas).  Same mathematics as the plain version
// models/ferminet_jac.py:ferminet_apply_and_jac, any depth.
//
// Bound on this card: operations.  What must move is x in, u and J (nd*nd
// floats per walker) out; the arithmetic (about n^2 dim S (S + C)
// multiply-adds per walker and layer, 2.7 Mflop a walker at n = 29, depth 2,
// widths 16) takes about ten times as long at the f32 rate as those bytes at
// the memory rate.  Beside the multiply-adds, each (row, column) pair costs
// two sincos of the pair features and one sigmoid per pair channel and layer.
//
// Design: one kernel, one block of 8 warps per walker.  In the layer recurrence
//
//   JfW[i][l] = Jsp[i][l] W1 + (mean_i' Jsp[i'][l]) W2
//               + (delta_il sum_j A[l][j] - A[i][l]) W3 / n
//   Jsp'[i][l] = sigmoid(pre[i]) * JfW[i][l]
//
// column l couples to nothing but itself, the pair blocks A[i][l] (all i),
// the row sum sum_j A[l][j], and the per-row activations sigmoid(pre[i]);
// the last two do not depend on the column at all.  So:
//
//   forward   the block's first phase: the weights and x are loaded into
//             shared memory once per walker.  A warp per row i walks the n
//             pairs (i, j) (lanes over j) and forms, per layer, the mean of
//             tp_k[i][j] over j (warp shuffles) and sum_j A_k[i][j] (the
//             warp's slice of shared memory), kept as a table: three
//             non-zero entries per coordinate at layer 0, times W3_k / n
//             past it.  The single-particle stream then runs layer by layer
//             over the block and leaves u and the per-row sigmoid(pre_k[i])
//             in shared memory.  2 depth + 3 block barriers in all.
//   columns   a warp per column particle l (warp w takes l = w, w + 8, ...);
//             lane L owns rows i = L and L + 32, so n <= 64.  The lane keeps
//             its rows' carried column Jsp[i][l] (dim x S floats a row) in
//             registers and rebuilds the pair block A_k[i][l] from the pair's
//             layer-0 features (one sincos per coordinate), channel by
//             channel, so no pair stream is stored.  mean_i Jsp[i][l] is a
//             sum over the warp's lanes: each lane adds its rows, then one
//             lane per entry adds the 32 partials in a fixed order in the
//             warp's slice of shared memory, so results are deterministic and
//             do not depend on the batch.  The recurrence has no block
//             barrier: only __syncwarp between a warp's own writes and reads
//             of its slice.
//   J         each warp stages its columns in the walker's nd x nd tile of
//             shared memory; after one block barrier the whole tile leaves as
//             consecutive 16-byte stores (the walker's nd*nd floats are
//             contiguous in J; 4-byte ones where nd is odd).
//
// The per-channel sigmoids of the Jacobian phase and the softplus of the n^2
// pair streams use the fast exponential, logarithm and reciprocal (errors of
// 1e-7, against the tolerances of 1e-5 on J and 2e-5 on u); the pair
// features keep the accurate sincosf.  __launch_bounds__ asks for two blocks
// an SM (128 registers): the latency of the per-channel chains is hidden by
// the other block's warps rather than by a longer unrolled body.
//
// The production widths (S = T = 16, dim 2, depth 2) are an instantiation of
// their own (one row a lane for n <= 32, two for n <= 64): every loop bound
// is a constant, Jsp and the accumulators live in registers, weights are
// read as float4.  Any other depth, dim <= 3 or width <= 32 takes the
// instantiation with run-time widths, whose per-lane arrays lie in local
// memory (deeper layers rebuild the pair stream of layer k through k tp
// layers).  One source, so the two cannot drift apart.
//
// Nothing but x, the weights, u and J touches device memory.  The n ceiling
// is 64 (two rows per lane); shared memory is 107 KB a block at
// n = 57 and 62 KB at n = 29 (cg_flow_smem), so two blocks are resident per
// SM.
#include <cuda_runtime.h>
#include <math.h>

#define CG_MAXF 32
#define CG_MAXDIM 3
#define CG_MAXN 64
#define CG_FLOW_WARPS 8

extern "C" {

// ---- packed parameter buffer ------------------------------------------------
// For k < depth: sp_w[k] (Fin_k x S) then sp_b[k] (S); for k < depth-1:
// tp_w[k] (Cin_k x T) then tp_b[k] (T); final_w (S x dim), final_b (dim).
// Fin_0 = 2 dim + C0, Fin_k = 2 S + T; Cin_0 = C0 = 2 dim + 1, Cin_k = T.
__host__ __device__ inline int cg_sp_w_off(int k, int dim, int S, int T) {
  const int C0 = 2 * dim + 1;
  if (k == 0) return 0;
  return (2 * dim + C0) * S + S + (k - 1) * ((2 * S + T) * S + S);
}
__host__ __device__ inline int cg_tp_w_off(int k, int depth, int dim, int S, int T) {
  const int C0 = 2 * dim + 1;
  const int base = cg_sp_w_off(depth, dim, S, T);
  if (k == 0) return base;
  return base + C0 * T + T + (k - 1) * (T * T + T);
}
__host__ __device__ inline int cg_final_w_off(int depth, int dim, int S, int T) {
  return cg_tp_w_off(depth - 1, depth, dim, S, T);
}
__host__ __device__ inline int cg_param_count(int depth, int dim, int S, int T) {
  return cg_final_w_off(depth, dim, S, T) + S * dim + dim;
}
__host__ __device__ inline int cg_imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int cg_odd(int v) { return v | 1; }
__host__ __device__ inline int cg_up4(int v) { return (v + 3) & ~3; }

__device__ inline float cg_sigmoid(float x) { return 1.f / (1.f + expf(-x)); }
// The same from the fast exponential and reciprocal (about 2 ulp): the
// Jacobian phase takes 2 T of them per (row, column) pair and layer.
__device__ inline float cg_sigmoid_fast(float x) { return __frcp_rn(1.f + __expf(-x)); }
// log(1 + e^x) = max(x, 0) + log1p(e^-|x|): logaddexp(x, 0), no threshold.
__device__ inline float cg_softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}
// The same from the fast exponential and logarithm: absolute error about
// 1e-7, for the n^2 pair streams of the forward pass.
__device__ inline float cg_softplus_fast(float x) {
  return fmaxf(x, 0.f) + __logf(1.f + __expf(-fabsf(x)));
}

// Floats of shared memory of one block (one walker): weights, x,
// sigmoid(pre) of every sp layer (rows padded to an odd stride), the rows'
// sum_j A_k[l][j] (3 dim entries at layer 0, times W3_k / n as dim x S past
// it), the J tile (which holds the forward pass's scratch before), and per
// warp 32 x VP partial sums and three vectors.
__host__ __device__ inline int cg_flow_jac_floats(int n, int dim, int depth, int S, int T) {
  const int CW = cg_imax(2 * dim + 1, T), SW = cg_imax(S, dim), VW = dim * cg_imax(S, CW);
  const int fwd = depth * n * CW + 2 * n * SW + SW;
  return cg_up4(cg_param_count(depth, dim, S, T)) + cg_up4(n * dim) +
         cg_up4(depth * n * cg_odd(S)) + cg_up4(n * 3 * dim + (depth - 1) * n * dim * S) +
         cg_up4(cg_imax(n * dim * n * dim, fwd)) + CG_FLOW_WARPS * (32 * cg_odd(VW) + 3 * VW);
}

}  // extern "C"

// Layer-0 pair features of the pair (i, j), r = x_i - x_j:
// t = [cos k2 r (dim), sin k2 r (dim), |sin k1 r|] and the non-zero entries
// of A = d t / d x_i: a0[d] = d t[d] / d x_i[d], a1[d] = d t[dim + d] /
// d x_i[d], a2[d] = d t[2 dim] / d x_i[d].  The diagonal pair i == j is the
// constant [1.., 0.., 0] with A = 0.
template <int DM>
struct CgPair0 {
  float c2[DM], s2[DM], a0[DM], a1[DM], a2[DM], dist;
};

template <int DM>
__device__ inline void cg_pair0(const float* xs, int i, int j, int dim, float k1, float k2,
                                CgPair0<DM>& p) {
  float s1v[DM], c1v[DM];
  float sumsq = 0.f;
#pragma unroll
  for (int d = 0; d < DM; ++d)
    if (d < dim) {
      const float r = xs[i * dim + d] - xs[j * dim + d];
      sincosf(k2 * r, &p.s2[d], &p.c2[d]);
      sincosf(k1 * r, &s1v[d], &c1v[d]);
      sumsq += s1v[d] * s1v[d];
    }
  p.dist = (i == j) ? 0.f : sqrtf(sumsq);
  const float safe = p.dist > 0.f ? p.dist : 1.f;
  const float on = (i == j) ? 0.f : 1.f;
#pragma unroll
  for (int d = 0; d < DM; ++d)
    if (d < dim) {
      p.a0[d] = -on * k2 * p.s2[d];
      p.a1[d] = on * k2 * p.c2[d];
      p.a2[d] = on * k1 * s1v[d] * c1v[d] / safe;
    }
}

// Entry c of the layer-0 feature vector of the pair.
template <int DM>
__device__ inline float cg_t0(const CgPair0<DM>& p, int c, int dim) {
  if (c < dim) return p.c2[c];
  if (c < 2 * dim) return p.s2[c - dim];
  return p.dist;
}

// Run-time-width instantiation only: the pair's stream after layers 0..kk-1
// of the tp network (kk >= 1), dense: t[c], A[d * CG_MAXF + c], c < T.
template <int DM>
__device__ void cg_pair_dense(const CgPair0<DM>& p, int kk, const float* Pm,
                              int depth, int dim, int S, int T, float* t, float* A) {
  const int C0 = 2 * dim + 1;
  for (int c = 0; c < C0; ++c) {
    t[c] = cg_t0(p, c, dim);
    for (int d = 0; d < dim; ++d) A[d * CG_MAXF + c] = 0.f;
  }
  for (int d = 0; d < dim; ++d) {
    A[d * CG_MAXF + d] = p.a0[d];
    A[d * CG_MAXF + dim + d] = p.a1[d];
    A[d * CG_MAXF + 2 * dim] = p.a2[d];
  }
  int Cin = C0;
  for (int m = 0; m < kk; ++m) {
    const float* Wt = Pm + cg_tp_w_off(m, depth, dim, S, T);
    const float* bt = Wt + Cin * T;
    float tn[CG_MAXF], An[CG_MAXDIM * CG_MAXF];
    for (int c2 = 0; c2 < T; ++c2) {
      float pre = bt[c2];
      for (int c = 0; c < Cin; ++c) pre += t[c] * Wt[c * T + c2];
      const float s = cg_sigmoid(pre);
      tn[c2] = cg_softplus(pre);
      for (int d = 0; d < dim; ++d) {
        float a = 0.f;
        for (int c = 0; c < Cin; ++c) a += A[d * CG_MAXF + c] * Wt[c * T + c2];
        An[d * CG_MAXF + c2] = s * a;
      }
    }
    for (int c2 = 0; c2 < T; ++c2) {  // the first layer replaces, later ones add
      t[c2] = (m == 0) ? tn[c2] : t[c2] + tn[c2];
      for (int d = 0; d < dim; ++d)
        A[d * CG_MAXF + c2] = (m == 0) ? An[d * CG_MAXF + c2] : A[d * CG_MAXF + c2] + An[d * CG_MAXF + c2];
    }
    Cin = T;
  }
}

// Channel c of the pair block A_k (k >= 1) of the pair (i, j):
// a[d] = d tp_k[c] / d x_i[d], and, if tv is given, *tv = tp_k[c].
// Layer k = 1 is built from the layer-0 features; deeper layers (run-time
// instantiation only) from the dense state tq, Aq of layer k - 1 made by
// cg_pair_dense.
template <int DM, bool GEN>
__device__ inline void cg_stream_col(const CgPair0<DM>& p, const float* tq,
                                     const float* Aq, int k, int c, const float* Wt,
                                     const float* bt, int dim, int T, float* a, float* tv) {
  float pre = bt[c];
  if (!GEN || k == 1) {
#pragma unroll
    for (int cc = 0; cc < 2 * DM + 1; ++cc)
      if (cc < 2 * dim + 1) pre += cg_t0(p, cc, dim) * Wt[cc * T + c];
    const float s = cg_sigmoid_fast(pre);
    if (tv) *tv = cg_softplus_fast(pre);  // the first tp layer replaces the stream
#pragma unroll
    for (int d = 0; d < DM; ++d)
      if (d < dim)
        a[d] = s * (p.a0[d] * Wt[d * T + c] + p.a1[d] * Wt[(dim + d) * T + c] +
                    p.a2[d] * Wt[2 * dim * T + c]);
  } else {
    for (int cc = 0; cc < T; ++cc) pre += tq[cc] * Wt[cc * T + c];
    const float s = cg_sigmoid_fast(pre);
    if (tv) *tv = tq[c] + cg_softplus_fast(pre);  // later ones add
    for (int d = 0; d < dim; ++d) {
      float v = 0.f;
      for (int cc = 0; cc < T; ++cc) v += Aq[d * CG_MAXF + cc] * Wt[cc * T + c];
      a[d] = Aq[d * CG_MAXF + c] + s * v;
    }
  }
}

// v[0..W) = p[0..W).  W > 0: a constant width, read as float4 when W % 4 == 0
// (p is then 16-byte aligned); W == 0: the run-time width w, zeros beyond.
template <int W>
__device__ inline void cg_row(const float* p, float* v, int w) {
  if constexpr (W > 0 && W % 4 == 0) {
#pragma unroll
    for (int j = 0; j < W; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + j);
      v[j] = q.x; v[j + 1] = q.y; v[j + 2] = q.z; v[j + 3] = q.w;
    }
  } else if constexpr (W > 0) {
#pragma unroll
    for (int j = 0; j < W; ++j) v[j] = p[j];
  } else {
#pragma unroll
    for (int j = 0; j < CG_MAXF; ++j) v[j] = j < w ? p[j] : 0.f;
  }
}

// The sum of v over the warp's lanes by shuffles; lane 0's value is the one
// used, and its order of additions is fixed.
__device__ inline float cg_warp_allsum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out[v] = sum over the warp's 32 lanes of scr[lane * VP + v], v < nv, times
// `scale`: four partial sums over lanes q = 0, 4, 8, ... / 1, 5, ... added
// in a fixed order (no dependent chain of 32 adds).  The caller has written
// scr and synced the warp.
__device__ inline void cg_warp_colsum(const float* scr, int VP, int nv, float scale, float* out,
                                      int lane) {
  for (int v = lane; v < nv; v += 32) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < 32; ++q) s[q & 3] += scr[q * VP + v];
    out[v] = ((s[0] + s[1]) + (s[2] + s[3])) * scale;
  }
}

// ---- the kernel: one block per walker ----------------------------------------
// R = rows per lane (1 for n <= 32, 2 for n <= 64).  Template widths of zero
// are taken at run time (the general instantiation, R = 2).
template <int S_, int T_, int DIM_, int DEPTH_, int R>
__global__ void __launch_bounds__(32 * CG_FLOW_WARPS, 2)
cg_flow_jac_kernel(const float* __restrict__ x, const float* __restrict__ params,
                   float* __restrict__ u, float* __restrict__ J, int n, int dim_rt,
                   int depth_rt, int S_rt, int T_rt, float L) {
  extern __shared__ __align__(16) float cg_smem[];
  constexpr bool GEN = (DEPTH_ == 0);
  constexpr int DM = DIM_ ? DIM_ : CG_MAXDIM;  // coordinates a lane's arrays hold
  constexpr int SM = S_ ? S_ : CG_MAXF;        // sp features a lane's arrays hold
  constexpr int TQ = GEN ? CG_MAXF : 1;        // dense pair state (layers k >= 2)
  const int S = S_ ? S_ : S_rt, T = T_ ? T_ : T_rt, dim = DIM_ ? DIM_ : dim_rt;
  const int depth = DEPTH_ ? DEPTH_ : depth_rt;
  const int C0 = 2 * dim + 1, CW = cg_imax(C0, T), SW = cg_imax(S, dim), nd = n * dim;
  const int SP = cg_odd(S), VW = dim * cg_imax(S, CW), VP = cg_odd(VW);
  const int P = cg_param_count(depth, dim, S, T);
  float* Pm = cg_smem;                        // packed weights, 16-byte aligned
  float* xs = Pm + cg_up4(P);                 // n x dim
  float* sig = xs + cg_up4(n * dim);          // depth x n x SP   sigmoid(pre_k[i][s])
  float* sA0 = sig + cg_up4(depth * n * SP);  // n x 3 dim        sum_j A_0[l][j], non-zeros
  float* sAW = sA0 + n * 3 * dim;             // (depth-1) x n x dim x S  sum_j A_k[l][j] W3_k / n
  float* big = sA0 + cg_up4(n * 3 * dim + (depth - 1) * n * dim * S);  // nd x nd J tile;
                                              // the forward's scratch before
  float* scr = big + cg_up4(cg_imax(nd * nd, depth * n * CW + 2 * n * SW + SW));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  scr += warp * (32 * VP + 3 * VW);           // this warp's slice: 32 x VP partial sums
  float* vM = scr + 32 * VP;                  // mean_i Jsp[i][l]; sum_j A_k[i][j] in the forward
  float* vAW = vM + VW;                       // sum_j A_k[l][j] W3 / n
  float* vMW = vAW + VW;                      // mean_i Jsp[i][l] W2
  const size_t w = blockIdx.x;
  const float k1 = 3.14159265358979323846f / L, k2 = 2.f * k1;
  const float inv_n = 1.f / (float)n;

  // ---- forward pass ----------------------------------------------------------
  float* tpm = big;                   // depth x n x CW   mean_j tp_k[i][j]
  float* spA = tpm + depth * n * CW;  // n x SW
  float* spB = spA + n * SW;          // n x SW
  float* spmean = spB + n * SW;       // SW
  for (int idx = threadIdx.x; idx < P; idx += blockDim.x) Pm[idx] = params[idx];
  for (int idx = threadIdx.x; idx < n * dim; idx += blockDim.x) xs[idx] = x[w * n * dim + idx];
  for (int idx = threadIdx.x; idx < n * SW; idx += blockDim.x) spA[idx] = 0.f;
  __syncthreads();

  // Pair streams: a warp per row i, lane L takes the pairs (i, j), j = L and
  // L + 32, and rebuilds layer k of each from its layer-0 features (through
  // one tp layer at the production depth), channel by channel.  Per layer the
  // lanes' sums of tp_k[i][j] are added over the warp by shuffles (the mean
  // over j feeds the single-particle stream), and their sums of A_k[i][j] in
  // the warp's slice: the columns' sum_j A_k[l][j] of row l = i, kept as its
  // three non-zero entries per coordinate at layer 0 and times W3_k / n past.
  for (int i = warp; i < n; i += nw) {
    CgPair0<DM> pp[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (lane + 32 * r < n) cg_pair0<DM>(xs, i, lane + 32 * r, dim, k1, k2, pp[r]);
    for (int k = 0; k < depth; ++k) {
      const float* Wt = Pm + cg_tp_w_off(k > 0 ? k - 1 : 0, depth, dim, S, T);
      const float* bt = Wt + (k <= 1 ? C0 : T) * T;
      float tq[R][TQ], Aq[R][DM * TQ];
      (void)tq; (void)Aq;
      int nv;
      if (k == 0) {
        nv = 3 * dim;
#pragma unroll
        for (int c = 0; c < 2 * DM + 1; ++c)
          if (c < C0) {
            float st = 0.f;
#pragma unroll
            for (int r = 0; r < R; ++r)
              if (lane + 32 * r < n) st += cg_t0(pp[r], c, dim);
            st = cg_warp_allsum(st);
            if (lane == 0) tpm[i * CW + c] = st * inv_n;
          }
#pragma unroll
        for (int d = 0; d < DM; ++d)
          if (d < dim) {
            float p0 = 0.f, p1 = 0.f, p2 = 0.f;
#pragma unroll
            for (int r = 0; r < R; ++r)
              if (lane + 32 * r < n) {
                p0 += pp[r].a0[d];
                p1 += pp[r].a1[d];
                p2 += pp[r].a2[d];
              }
            scr[lane * VP + 3 * d] = p0;
            scr[lane * VP + 3 * d + 1] = p1;
            scr[lane * VP + 3 * d + 2] = p2;
          }
      } else {
        nv = dim * T;
        if constexpr (GEN) {
          if (k >= 2)
            for (int r = 0; r < R; ++r)
              if (lane + 32 * r < n)
                cg_pair_dense<DM>(pp[r], k - 1, Pm, depth, dim, S, T, tq[r], Aq[r]);
        }
#pragma unroll 2
        for (int c = 0; c < T; ++c) {
          float st = 0.f, pa[DM];
#pragma unroll
          for (int d = 0; d < DM; ++d) pa[d] = 0.f;
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (lane + 32 * r < n) {
              float a[DM], tv;
              cg_stream_col<DM, GEN>(pp[r], tq[r], Aq[r], k, c, Wt, bt, dim, T, a, &tv);
              st += tv;
#pragma unroll
              for (int d = 0; d < DM; ++d)
                if (d < dim) pa[d] += a[d];
            }
          st = cg_warp_allsum(st);
          if (lane == 0) tpm[(k * n + i) * CW + c] = st * inv_n;
#pragma unroll
          for (int d = 0; d < DM; ++d)
            if (d < dim) scr[lane * VP + d * T + c] = pa[d];
        }
      }
      __syncwarp();
      cg_warp_colsum(scr, VP, nv, 1.f, vM, lane);
      __syncwarp();
      if (k == 0) {
        for (int v = lane; v < nv; v += 32) sA0[i * nv + v] = vM[v];
      } else {
        const float* W3 = Pm + cg_sp_w_off(k, dim, S, T) + 2 * S * S;
        for (int v = lane; v < dim * S; v += 32) {
          const int d = v / S, s2 = v - d * S;
          float a[2] = {0.f, 0.f};  // two partial sums
          for (int c = 0; c < T; ++c) a[c & 1] += vM[d * T + c] * W3[c * S + s2];
          sAW[((k - 1) * n + i) * dim * S + v] = (a[0] + a[1]) * inv_n;
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // Single-particle stream, layer by layer over the block.
  float* cur = spA;
  float* nxt = spB;
  int S_in = dim;
  for (int k = 0; k < depth; ++k) {
    const int Cin = (k == 0) ? C0 : T;
    for (int s = threadIdx.x; s < S_in; s += blockDim.x) {
      float m = 0.f;
      for (int i = 0; i < n; ++i) m += cur[i * SW + s];
      spmean[s] = m / (float)n;
    }
    __syncthreads();
    const float* W = Pm + cg_sp_w_off(k, dim, S, T);
    const float* b = W + (2 * S_in + Cin) * S;
    for (int idx = threadIdx.x; idx < n * S; idx += blockDim.x) {
      const int i = idx / S, s2 = idx % S;
      float pre = b[s2];
      for (int s = 0; s < S_in; ++s)
        pre += cur[i * SW + s] * W[s * S + s2] + spmean[s] * W[(S_in + s) * S + s2];
      for (int c = 0; c < Cin; ++c) pre += tpm[(k * n + i) * CW + c] * W[(2 * S_in + c) * S + s2];
      sig[(k * n + i) * SP + s2] = cg_sigmoid(pre);
      const float act = cg_softplus(pre);
      // the first layer replaces the stream (it was zero), later ones add
      nxt[i * SW + s2] = (k == 0) ? act : cur[i * SW + s2] + act;
    }
    __syncthreads();
    float* tmp = cur; cur = nxt; nxt = tmp;
    S_in = S;
  }
  const float* Wf = Pm + cg_final_w_off(depth, dim, S, T);
  const float* bf = Wf + S * dim;
  for (int idx = threadIdx.x; idx < n * dim; idx += blockDim.x) {
    const int i = idx / dim, b = idx % dim;
    float acc = bf[b];
    for (int s = 0; s < S; ++s) acc += cur[i * SW + s] * Wf[s * dim + b];
    u[w * n * dim + idx] = xs[idx] + acc;
  }
  __syncthreads();  // the forward's scratch in `big` is dead from here

  // ---- Jacobian columns: a warp per column particle l, no block barrier -------
  for (int l = warp; l < n; l += nw) {
    CgPair0<DM> pr[R];     // layer-0 features of the pair (i, l), i = lane + 32 r
    float jsp[R][DM][SM];  // Jsp[i][l][d][s]
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (lane + 32 * r < n) cg_pair0<DM>(xs, lane + 32 * r, l, dim, k1, k2, pr[r]);
    S_in = dim;
    for (int k = 0; k < depth; ++k) {
      const float* W1 = Pm + cg_sp_w_off(k, dim, S, T);
      const float* W2 = W1 + S_in * S;
      const float* W3 = W2 + S_in * S;
      // the tp layer k - 1 -> k
      const float* Wt = Pm + cg_tp_w_off(k > 0 ? k - 1 : 0, depth, dim, S, T);
      const float* bt = Wt + (k <= 1 ? C0 : T) * T;
      float tq[R][TQ], Aq[R][DM * TQ];
      (void)tq; (void)Aq;

      // (a') mean_i Jsp[i][l]   (Jsp is zero before layer 0)
      if (k > 0) {
#pragma unroll
        for (int d = 0; d < DM; ++d)
          if (d < dim)
#pragma unroll
            for (int s = 0; s < SM; ++s)
              if (S_ || s < S) {
                float m = 0.f;
#pragma unroll
                for (int r = 0; r < R; ++r)
                  if (lane + 32 * r < n) m += jsp[r][d][s];
                scr[lane * VP + d * S + s] = m;
              }
        __syncwarp();
        cg_warp_colsum(scr, VP, dim * S, inv_n, vM, lane);
        __syncwarp();
      }
      // (a'') sum_j A_k[l][j] W3 / n from the forward pass's table, and
      //       mean_i Jsp[i][l] W2, an entry (d, s2) per lane
      for (int v = lane; v < dim * S; v += 32) {
        const int d = v / S, s2 = v - d * S;
        const float* a0 = sA0 + l * 3 * dim + 3 * d;
        float m[2] = {0.f, 0.f};  // two partial sums
        if (k > 0)
          for (int s = 0; s < S; ++s) m[s & 1] += vM[d * S + s] * W2[s * S + s2];
        vAW[v] = (k == 0) ? (a0[0] * W3[d * S + s2] + a0[1] * W3[(dim + d) * S + s2] +
                             a0[2] * W3[2 * dim * S + s2]) * inv_n
                          : sAW[((k - 1) * n + l) * dim * S + v];
        vMW[v] = m[0] + m[1];
      }
      __syncwarp();
      // (b) Jsp'[i][l] = sigmoid(pre[i]) * JfW[i][l] for the lane's rows i
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = lane + 32 * r;
        if (i >= n) continue;
        if constexpr (GEN) {
          if (k >= 2) cg_pair_dense<DM>(pr[r], k - 1, Pm, depth, dim, S, T, tq[r], Aq[r]);
        }
        float acc[DM][SM], wrow[SM];
#pragma unroll
        for (int d = 0; d < DM; ++d)
          if (d < dim) {
            cg_row<S_>(vMW + d * S, wrow, S);
#pragma unroll
            for (int j = 0; j < SM; ++j) acc[d][j] = wrow[j];
            if (i == l) {
              cg_row<S_>(vAW + d * S, wrow, S);
#pragma unroll
              for (int j = 0; j < SM; ++j) acc[d][j] += wrow[j];
            }
          }
        if (k > 0)
#pragma unroll
          for (int s = 0; s < SM; ++s)
            if (S_ || s < S) {
              cg_row<S_>(W1 + s * S, wrow, S);
#pragma unroll
              for (int d = 0; d < DM; ++d)
                if (d < dim) {
                  const float a = jsp[r][d][s];
#pragma unroll
                  for (int j = 0; j < SM; ++j) acc[d][j] += a * wrow[j];
                }
            }
        if (k == 0) {
#pragma unroll
          for (int d = 0; d < DM; ++d)
            if (d < dim) {
              const float e[3] = {pr[r].a0[d], pr[r].a1[d], pr[r].a2[d]};
              const int row[3] = {d, dim + d, 2 * dim};
#pragma unroll
              for (int q = 0; q < 3; ++q) {
                cg_row<S_>(W3 + row[q] * S, wrow, S);
                const float a = -inv_n * e[q];  // pair (i, l)
#pragma unroll
                for (int j = 0; j < SM; ++j) acc[d][j] += a * wrow[j];
              }
            }
        } else {
#pragma unroll 2
          for (int c = 0; c < T; ++c) {
            float a[DM];
            cg_stream_col<DM, GEN>(pr[r], tq[r], Aq[r], k, c, Wt, bt, dim, T, a, nullptr);
            cg_row<S_>(W3 + c * S, wrow, S);
#pragma unroll
            for (int d = 0; d < DM; ++d)
              if (d < dim) {
                const float q = -inv_n * a[d];
#pragma unroll
                for (int j = 0; j < SM; ++j) acc[d][j] += q * wrow[j];
              }
          }
        }
        const float* sg = sig + (k * n + i) * SP;
#pragma unroll
        for (int d = 0; d < DM; ++d)
          if (d < dim)
#pragma unroll
            for (int s = 0; s < SM; ++s)
              if (S_ || s < S) {
                const float jn = sg[s] * acc[d][s];
                // the first layer replaces the carried state, later ones add
                jsp[r][d][s] = (k == 0) ? jn : jsp[r][d][s] + jn;
              }
      }
      __syncwarp();  // the next layer rewrites scr and the vectors
      S_in = S;
    }

    // J[(i,b),(l,a)] = delta_il delta_ab + sum_s Jsp[i][l][a][s] Wf[s][b], into the tile
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + 32 * r;
      if (i >= n) continue;
#pragma unroll
      for (int b = 0; b < DM; ++b)
        if (b < dim)
#pragma unroll
          for (int a = 0; a < DM; ++a)
            if (a < dim) {
              float v = (i == l && a == b) ? 1.f : 0.f;
#pragma unroll
              for (int s = 0; s < SM; ++s)
                if (S_ || s < S) v += jsp[r][a][s] * Wf[s * dim + b];
              big[(i * dim + b) * nd + l * dim + a] = v;
            }
    }
  }
  __syncthreads();

  // The tile leaves in consecutive 16-byte stores (J + w nd^2 is 16-byte
  // aligned where nd is even), in 4-byte ones where nd is odd.
  float* Jw = J + w * nd * nd;
  if ((nd & 1) == 0) {
    const float4* src = reinterpret_cast<const float4*>(big);
    float4* dst = reinterpret_cast<float4*>(Jw);
    for (int idx = threadIdx.x; idx < nd * nd / 4; idx += blockDim.x) dst[idx] = src[idx];
  } else {
    for (int idx = threadIdx.x; idx < nd * nd; idx += blockDim.x) Jw[idx] = big[idx];
  }
}

// The production widths get their own instantiation, anything else the one
// with run-time widths.
inline bool cg_flow_tiled(int dim, int depth, int S, int T) {
  return dim == 2 && depth == 2 && S == 16 && T == 16;
}

extern "C" {

int cg_flow_param_count(int depth, int dim, int S, int T) {
  return cg_param_count(depth, dim, S, T);
}
// Shared memory of one block in bytes; -1 where n, dim or a feature width
// is beyond what the kernel takes.
int cg_flow_smem(int n, int dim, int depth, int S, int T) {
  if (n > CG_MAXN || dim > CG_MAXDIM || S > CG_MAXF || T > CG_MAXF || 2 * dim + 1 > CG_MAXF)
    return -1;
  return (int)sizeof(float) * cg_flow_jac_floats(n, dim, depth, S, T);
}

}  // extern "C"

template <int S_, int T_, int DIM_, int DEPTH_, int R>
static cudaError_t cg_launch_flow(const float* x, const float* params, float* u, float* J,
                                  int B, int n, int dim, int depth, int S, int T, float L,
                                  cudaStream_t st) {
  const int smem = (int)sizeof(float) * cg_flow_jac_floats(n, dim, depth, S, T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(cg_flow_jac_kernel<S_, T_, DIM_, DEPTH_, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  cg_flow_jac_kernel<S_, T_, DIM_, DEPTH_, R><<<B, 32 * CG_FLOW_WARPS, smem, st>>>(
      x, params, u, J, n, dim, depth, S, T, L);
  return cudaGetLastError();
}

extern "C" {

// x (B, n, dim), params packed as above, u (B, n, dim), J (B, nd, nd); all
// contiguous f32.  One launch on the given stream.  Returns the CUDA error
// of the launch, 0 on success.
int cg_flow_u_jac(const float* x, const float* params, float* u, float* J, int B, int n,
                  int dim, int depth, int S, int T, float L, void* stream) {
  if (B <= 0) return 0;
  if (cg_flow_smem(n, dim, depth, S, T) < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (cg_flow_tiled(dim, depth, S, T))
    e = n <= 32 ? cg_launch_flow<16, 16, 2, 2, 1>(x, params, u, J, B, n, dim, depth, S, T, L, st)
                : cg_launch_flow<16, 16, 2, 2, 2>(x, params, u, J, B, n, dim, depth, S, T, L, st);
  else
    e = cg_launch_flow<0, 0, 0, 0, 2>(x, params, u, J, B, n, dim, depth, S, T, L, st);
  return (int)e;
}

}  // extern "C"
