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
// the memory rate.  The difficulty is not the bound but the state: the carried
// Jacobian Jsp[i][l][d][s] and the pair-derivative block A[i][j][d][c] are
// about 107 KB each per walker at n = 29, S = C = 16, and do not fit one
// block's shared memory together.
//
// Design: decompose over the column particle l.  In the layer recurrence
//
//   JfW[i][l] = Jsp[i][l] W1 + (mean_i' Jsp[i'][l]) W2
//               + (delta_il sum_j A[i][j] - A[i][l]) W3 / n
//   Jsp'[i][l] = sigmoid(pre[i]) * JfW[i][l]
//
// column l couples to nothing but itself, the pair blocks A[i][l] (all i) and
// A[l][j] (all j), and the per-row activations sigmoid(pre[i]), which do not
// depend on l at all.  And the pair stream is pair-local through every layer,
// so A[i][l] and A[l][j] can be rebuilt from x for just those 2n pairs.  Hence
// two kernels, launched back to back by one wrapper call:
//
//   cg_flow_fwd_kernel   one block per walker: the forward pass.  Writes u and
//                        sigmoid(pre[k][i][s]) for every sp layer k (a scratch
//                        of depth*n*S floats per walker, allocated by the
//                        wrapper).  A few threads share a row i and walk its
//                        pair streams; their partial sums are added in a
//                        fixed order, so results are deterministic.
//   cg_flow_jac_kernel   one block per (walker, l): carries Jsp[:, l] —
//                        n*dim*S floats, 3.7 KB at n = 29 — through the
//                        layers in shared memory and writes column block l
//                        of J.  About 27 KB of shared memory per block.  At
//                        the production widths each thread owns a register
//                        tile (dim rows x 8 features) and reads weights as
//                        float4, so a shared-memory load feeds several
//                        multiply-adds and no index needs a division.
//
// Nothing but x, the weights, the scratch, u and J touches device memory.
// The n ceiling is the shared-memory budget of cg_flow_jac_kernel (see
// cg_flow_smem); feature widths are capped at CG_MAXF by the per-thread
// arrays of the forward kernel, dim at 3.
#include <cuda_runtime.h>
#include <math.h>

#define CG_MAXF 32
#define CG_MAXDIM 3

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

__device__ inline float cg_sigmoid(float x) { return 1.f / (1.f + expf(-x)); }
// log(1 + e^x) = max(x, 0) + log1p(e^-|x|): logaddexp(x, 0), no threshold.
__device__ inline float cg_softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

}  // extern "C"

// Pair features of the pair (i, j): t[c], c < 2 dim + 1, =
// [cos k2 r (dim), sin k2 r (dim), |sin k1 r|], r = x_i - x_j; and, if A is
// given, A[d * lda + c] = d t[c] / d r[d].  The diagonal pair i == j is the
// constant [1.., 0.., 0] with zero derivative.  With DIM_ given every index
// into t is a constant, so a caller's t can live in registers.
template <int DIM_>
__device__ inline void cg_pair_feat(const float* xs, int i, int j, int dim_rt,
                                    float k1, float k2, float* t, float* A,
                                    int lda) {
  const int dim = DIM_ ? DIM_ : dim_rt;
  constexpr int DM = DIM_ ? DIM_ : CG_MAXDIM;
  const int C0 = 2 * dim + 1;
  float s2v[DM], c2v[DM], s1v[DM], c1v[DM];
  float sumsq = 0.f;
#pragma unroll
  for (int d = 0; d < DM; ++d)
    if (d < dim) {
      const float r = xs[i * dim + d] - xs[j * dim + d];
      sincosf(k2 * r, &s2v[d], &c2v[d]);
      sincosf(k1 * r, &s1v[d], &c1v[d]);
      sumsq += s1v[d] * s1v[d];
      t[d] = c2v[d];
      t[dim + d] = s2v[d];
    }
  const float dij = (i == j) ? 0.f : sqrtf(sumsq);
  t[2 * dim] = dij;
  if (A) {
    for (int d = 0; d < dim; ++d)
      for (int c = 0; c < C0; ++c) A[d * lda + c] = 0.f;
    if (i != j) {
      const float safe = dij > 0.f ? dij : 1.f;
#pragma unroll
      for (int d = 0; d < DM; ++d)
        if (d < dim) {
          A[d * lda + d] = -k2 * s2v[d];
          A[d * lda + dim + d] = k2 * c2v[d];
          A[d * lda + 2 * dim] = k1 * s1v[d] * c1v[d] / safe;
        }
    }
  }
}

// ---- forward pass: one block per walker -------------------------------------
// Row i's n pair streams are shared by CG_FWD_SLICES threads (pairs j = slice,
// slice + CG_FWD_SLICES, ...); each keeps its partial sums apart, and they are
// added in slice order afterwards, so the means do not depend on timing.
#define CG_FWD_SLICES 4

__host__ __device__ inline int cg_flow_fwd_floats(int n, int dim, int depth, int S, int T) {
  const int CW = cg_imax(2 * dim + 1, T), SW = cg_imax(S, dim);
  return cg_param_count(depth, dim, S, T) + n * dim +
         (CG_FWD_SLICES + 1) * depth * n * CW + 2 * n * SW + SW;
}

// A template over (S, T, dim) like the Jacobian kernel below: with the widths
// given, a thread's pair stream t[] is indexed by constants only and stays in
// registers; with zeros the widths are taken at run time and it lives in
// local memory.
template <int S_, int T_, int DIM_>
__global__ void cg_flow_fwd_kernel(const float* __restrict__ x,
                                   const float* __restrict__ params,
                                   float* __restrict__ u, float* __restrict__ sig,
                                   int n, int dim_rt, int depth, int S_rt, int T_rt,
                                   float L) {
  extern __shared__ __align__(16) float cg_smem[];
  const int S = S_ ? S_ : S_rt, T = T_ ? T_ : T_rt, dim = DIM_ ? DIM_ : dim_rt;
  // entries of one stream, and the bound of the loops over them: a constant
  // (the loop bodies test c < Cin) or the run-time width itself
  constexpr int TM = T_ ? (T_ > 2 * DIM_ + 1 ? T_ : 2 * DIM_ + 1) : CG_MAXF;
  const int C0 = 2 * dim + 1, CW = cg_imax(C0, T), SW = cg_imax(S, dim);
  const int P = cg_param_count(depth, dim, S, T);
  float* Pm = cg_smem;              // packed weights
  float* xs = Pm + P;               // n x dim
  float* tpm = xs + n * dim;        // depth x n x CW   mean_j tp_k[i][j][:]
  float* part = tpm + depth * n * CW;  // slices x depth x n x CW partial sums
  float* spA = part + CG_FWD_SLICES * depth * n * CW;  // n x SW
  float* spB = spA + n * SW;        // n x SW
  float* spmean = spB + n * SW;     // SW
  const size_t w = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float k1 = 3.14159265358979323846f / L, k2 = 2.f * k1;

  for (int idx = tid; idx < P; idx += nt) Pm[idx] = params[idx];
  for (int idx = tid; idx < n * dim; idx += nt) xs[idx] = x[w * n * dim + idx];
  for (int idx = tid; idx < n * SW; idx += nt) spA[idx] = 0.f;
  for (int idx = tid; idx < CG_FWD_SLICES * depth * n * CW; idx += nt) part[idx] = 0.f;
  __syncthreads();

  // Pair streams.  tp_k[i][j] depends on the pair (i, j) alone, through every
  // layer, so a thread walks its pairs one after the other and keeps the
  // stream in its own registers/local memory.
  for (int slot = tid; slot < n * CG_FWD_SLICES; slot += nt) {
    const int i = slot / CG_FWD_SLICES, sl = slot % CG_FWD_SLICES;
    float* mine = part + sl * depth * n * CW;
    for (int j = sl; j < n; j += CG_FWD_SLICES) {
      float t[TM], tn[TM];
      cg_pair_feat<DIM_>(xs, i, j, dim, k1, k2, t, nullptr, 0);
      int Cin = C0;
      for (int k = 0; k < depth; ++k) {
#pragma unroll
        for (int c = 0; c < (T_ ? TM : Cin); ++c)
          if (c < Cin) mine[(k * n + i) * CW + c] += t[c];
        if (k < depth - 1) {
          const float* Wt = Pm + cg_tp_w_off(k, depth, dim, S, T);
          const float* bt = Wt + Cin * T;
#pragma unroll
          for (int c2 = 0; c2 < (T_ ? TM : T); ++c2)
            if (c2 < T) {
              float pre = bt[c2];
#pragma unroll
              for (int c = 0; c < (T_ ? TM : Cin); ++c)
                if (c < Cin) pre += t[c] * Wt[c * T + c2];
              tn[c2] = cg_softplus(pre);
            }
#pragma unroll
          for (int c2 = 0; c2 < (T_ ? TM : T); ++c2)
            if (c2 < T) t[c2] = (k == 0) ? tn[c2] : t[c2] + tn[c2];
          Cin = T;
        }
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < depth * n * CW; idx += nt) {
    float m = 0.f;
    for (int sl = 0; sl < CG_FWD_SLICES; ++sl) m += part[sl * depth * n * CW + idx];
    tpm[idx] = m / (float)n;
  }
  __syncthreads();

  // Single-particle stream.
  float* cur = spA;
  float* nxt = spB;
  int S_in = dim;
  for (int k = 0; k < depth; ++k) {
    const int Cin = (k == 0) ? C0 : T;
    for (int s = tid; s < S_in; s += nt) {
      float m = 0.f;
      for (int i = 0; i < n; ++i) m += cur[i * SW + s];
      spmean[s] = m / (float)n;
    }
    __syncthreads();
    const float* W = Pm + cg_sp_w_off(k, dim, S, T);
    const float* b = W + (2 * S_in + Cin) * S;
    for (int idx = tid; idx < n * S; idx += nt) {
      const int i = idx / S, s2 = idx % S;
      float pre = b[s2];
      for (int s = 0; s < S_in; ++s)
        pre += cur[i * SW + s] * W[s * S + s2] + spmean[s] * W[(S_in + s) * S + s2];
      for (int c = 0; c < Cin; ++c)
        pre += tpm[(k * n + i) * CW + c] * W[(2 * S_in + c) * S + s2];
      sig[((w * depth + k) * n + i) * S + s2] = cg_sigmoid(pre);
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
  for (int idx = tid; idx < n * dim; idx += nt) {
    const int i = idx / dim, b = idx % dim;
    float acc = bf[b];
    for (int s = 0; s < S; ++s) acc += cur[i * SW + s] * Wf[s * dim + b];
    u[w * n * dim + idx] = xs[idx] + acc;
  }
}

// ---- Jacobian column: one block per (walker, l) -----------------------------
//
// The kernel is a template over (S, T, dim): with all three given (the
// production widths 16, 16, 2) a thread owns a register tile of dim rows x 8
// features, reads the weights as float4 and every loop bound is a constant;
// with zeros it takes the widths at run time, one feature per thread and
// tile.  One source, so the two cannot drift apart.
//
// Rows of A, tp, Jc and Jn are padded to an odd stride: threads of a warp
// read one element each of different rows at the same feature index.
__host__ __device__ inline int cg_odd(int v) { return v | 1; }
__host__ __device__ inline int cg_up4(int v) { return (v + 3) & ~3; }

__host__ __device__ inline int cg_flow_jac_floats(int n, int dim, int depth, int S, int T) {
  const int CWP = cg_odd(cg_imax(2 * dim + 1, T)), SP = cg_odd(S);
  return cg_up4(cg_param_count(depth, dim, S, T))  // weights
         + 2 * (2 * n * CWP)                       // tp, tpn
         + 2 * (2 * n * dim * CWP)                 // A, An
         + 2 * (n * dim * SP)                      // Jc, Jn
         + n * dim + dim * CWP + 3 * dim * S;      // x, sumA, meanJ, sumAW, mJW
}

// w[0..W) = p[0..W); as float4 when the width allows (p is then 16-byte aligned)
template <int W>
__device__ inline void cg_load_row(const float* p, float* w) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int j = 0; j < W; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + j);
      w[j] = v.x; w[j + 1] = v.y; w[j + 2] = v.z; w[j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) w[j] = p[j];
  }
}

template <int S_, int T_, int DIM_>
__global__ void cg_flow_jac_kernel(const float* __restrict__ x,
                                   const float* __restrict__ params,
                                   const float* __restrict__ sig,
                                   float* __restrict__ J, int n, int dim_rt,
                                   int depth, int S_rt, int T_rt, float L) {
  extern __shared__ __align__(16) float cg_smem[];
  const int S = S_ ? S_ : S_rt, T = T_ ? T_ : T_rt, dim = DIM_ ? DIM_ : dim_rt;
  constexpr int SC = S_ ? 8 : 1;               // features of one sp tile
  constexpr int TC = T_ ? 8 : 1;               // features of one tp tile
  constexpr int DM = DIM_ ? DIM_ : CG_MAXDIM;  // rows of a tile
  const int C0 = 2 * dim + 1, CWP = cg_odd(cg_imax(C0, T)), SP = cg_odd(S), nd = n * dim;
  const int P = cg_param_count(depth, dim, S, T);
  float* Pm = cg_smem;                  // packed weights, 16-byte aligned
  // pair p < n is (i = p, j = l); pair p >= n is (i = l, j = p - n)
  float* tp = Pm + cg_up4(P);           // 2n x CWP
  float* tpn = tp + 2 * n * CWP;        // 2n x CWP
  float* A = tpn + 2 * n * CWP;         // 2n x dim x CWP   d tp / d x_i
  float* An = A + 2 * n * dim * CWP;    // 2n x dim x CWP
  float* Jc = An + 2 * n * dim * CWP;   // n x dim x SP     Jsp[i][l][d][s]
  float* Jn = Jc + n * dim * SP;        // n x dim x SP
  float* xs = Jn + n * dim * SP;        // n x dim
  float* sumA = xs + n * dim;           // dim x CWP        sum_j A[l][j]
  float* meanJ = sumA + dim * CWP;      // dim x S          mean_i Jsp[i][l]
  float* sumAW = meanJ + dim * S;       // dim x S
  float* mJW = sumAW + dim * S;         // dim x S
  const size_t w = blockIdx.x / n;
  const int l = blockIdx.x % n;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float k1 = 3.14159265358979323846f / L, k2 = 2.f * k1;
  const float inv_n = 1.f / (float)n;

  for (int idx = tid; idx < P; idx += nt) Pm[idx] = params[idx];
  for (int idx = tid; idx < n * dim; idx += nt) xs[idx] = x[w * n * dim + idx];
  __syncthreads();
  for (int p = tid; p < 2 * n; p += nt) {
    const int i = (p < n) ? p : l, j = (p < n) ? l : p - n;
    cg_pair_feat<DIM_>(xs, i, j, dim, k1, k2, tp + p * CWP, A + p * dim * CWP, CWP);
  }
  __syncthreads();

  int Cin = C0, S_in = dim;
  for (int k = 0; k < depth; ++k) {
    const float* W1 = Pm + cg_sp_w_off(k, dim, S, T);
    const float* W2 = W1 + S_in * S;
    const float* W3 = W2 + S_in * S;
    // (a) sum_j A[l][j] and mean_i Jsp[i][l]   (Jsp is zero before layer 0)
    for (int idx = tid; idx < dim * Cin; idx += nt) {
      const int d = idx / Cin, c = idx % Cin;
      float s = 0.f;
      for (int j = 0; j < n; ++j) s += A[((n + j) * dim + d) * CWP + c];
      sumA[d * CWP + c] = s;
    }
    if (k > 0)
      for (int idx = tid; idx < dim * S; idx += nt) {
        const int d = idx / S, s = idx % S;
        float m = 0.f;
        for (int i = 0; i < n; ++i) m += Jc[(i * dim + d) * SP + s];
        meanJ[idx] = m * inv_n;
      }
    __syncthreads();
    // (b) their products with W3 and W2
    for (int idx = tid; idx < dim * S; idx += nt) {
      const int d = idx / S, s2 = idx % S;
      float a = 0.f, m = 0.f;
      for (int c = 0; c < Cin; ++c) a += sumA[d * CWP + c] * W3[c * S + s2];
      if (k > 0)
        for (int s = 0; s < S; ++s) m += meanJ[d * S + s] * W2[s * S + s2];
      sumAW[idx] = a * inv_n;
      mJW[idx] = m;
    }
    __syncthreads();
    // (c) Jn[i][d][s2] = sigmoid(pre[i][s2]) * JfW[i][l][d][s2], where
    //     JfW = Jsp W1 + mean(Jsp) W2 + (delta_il sum_j A[l][j] - A[i][l]) W3 / n.
    //     A tile is particle i's dim rows x SC features.
    const int nchunk = S / SC;
    for (int item = tid; item < n * nchunk; item += nt) {
      const int i = item / nchunk, c0 = (item % nchunk) * SC;
      float acc[DM][SC], wrow[SC];
#pragma unroll
      for (int d = 0; d < DM; ++d)
        if (d < dim)
#pragma unroll
          for (int j = 0; j < SC; ++j)
            acc[d][j] = mJW[d * S + c0 + j] + (i == l ? sumAW[d * S + c0 + j] : 0.f);
      if (k > 0)
        for (int s = 0; s < S; ++s) {
          cg_load_row<SC>(W1 + s * S + c0, wrow);
#pragma unroll
          for (int d = 0; d < DM; ++d)
            if (d < dim) {
              const float a = Jc[(i * dim + d) * SP + s];
#pragma unroll
              for (int j = 0; j < SC; ++j) acc[d][j] += a * wrow[j];
            }
        }
      for (int c = 0; c < Cin; ++c) {
        cg_load_row<SC>(W3 + c * S + c0, wrow);
#pragma unroll
        for (int d = 0; d < DM; ++d)
          if (d < dim) {
            const float a = -inv_n * A[(i * dim + d) * CWP + c];  // pair (i, l)
#pragma unroll
            for (int j = 0; j < SC; ++j) acc[d][j] += a * wrow[j];
          }
      }
      const float* sg = sig + ((w * depth + k) * n + i) * S + c0;
#pragma unroll
      for (int d = 0; d < DM; ++d)
        if (d < dim)
#pragma unroll
          for (int j = 0; j < SC; ++j) Jn[(i * dim + d) * SP + c0 + j] = sg[j] * acc[d][j];
    }
    __syncthreads();
    // (d) the first layer replaces the carried state, later ones add
    for (int idx = tid; idx < nd * S; idx += nt) {
      const int q = (idx / S) * SP + idx % S;
      Jc[q] = (k == 0) ? Jn[q] : Jc[q] + Jn[q];
    }
    // (e) pair-local layer on the 2n pairs of this column; a tile is one
    //     pair's (1 + dim) rows — tp and A[d] — x TC features
    if (k < depth - 1) {
      const float* Wt = Pm + cg_tp_w_off(k, depth, dim, S, T);
      const float* bt = Wt + Cin * T;
      const int tchunk = T / TC;
      for (int item = tid; item < 2 * n * tchunk; item += nt) {
        const int p = item / tchunk, c0 = (item % tchunk) * TC;
        float pre[TC], a[DM][TC], wrow[TC];
#pragma unroll
        for (int j = 0; j < TC; ++j) pre[j] = bt[c0 + j];
#pragma unroll
        for (int d = 0; d < DM; ++d)
#pragma unroll
          for (int j = 0; j < TC; ++j) a[d][j] = 0.f;
        for (int c = 0; c < Cin; ++c) {
          cg_load_row<TC>(Wt + c * T + c0, wrow);
          const float t = tp[p * CWP + c];
#pragma unroll
          for (int j = 0; j < TC; ++j) pre[j] += t * wrow[j];
#pragma unroll
          for (int d = 0; d < DM; ++d)
            if (d < dim) {
              const float ad = A[(p * dim + d) * CWP + c];
#pragma unroll
              for (int j = 0; j < TC; ++j) a[d][j] += ad * wrow[j];
            }
        }
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          const float sgm = cg_sigmoid(pre[j]);
          tpn[p * CWP + c0 + j] = cg_softplus(pre[j]);
#pragma unroll
          for (int d = 0; d < DM; ++d)
            if (d < dim) An[(p * dim + d) * CWP + c0 + j] = sgm * a[d][j];
        }
      }
      __syncthreads();
      for (int idx = tid; idx < 2 * n * T; idx += nt) {
        const int p = idx / T, c2 = idx % T;
        tp[p * CWP + c2] = (k == 0) ? tpn[p * CWP + c2] : tp[p * CWP + c2] + tpn[p * CWP + c2];
        for (int d = 0; d < dim; ++d) {
          const int q = (p * dim + d) * CWP + c2;
          A[q] = (k == 0) ? An[q] : A[q] + An[q];
        }
      }
      Cin = T;
    }
    __syncthreads();
    S_in = S;
  }

  // J[(i,b),(l,a)] = delta_il delta_ab + sum_s Jsp[i][l][a][s] Wf[s][b]
  const float* Wf = Pm + cg_final_w_off(depth, dim, S, T);
  float* Jw = J + w * nd * nd;
  for (int idx = tid; idx < n * dim * dim; idx += nt) {
    const int i = idx / (dim * dim), b = (idx / dim) % dim, a = idx % dim;
    float v = (i == l && a == b) ? 1.f : 0.f;
    for (int s = 0; s < S; ++s) v += Jc[(i * dim + a) * SP + s] * Wf[s * dim + b];
    Jw[(i * dim + b) * nd + l * dim + a] = v;
  }
}

// The production widths get the tiled instantiation, anything else the one
// with run-time widths.
inline bool cg_flow_jac_tiled(int dim, int S, int T) { return dim == 2 && S == 16 && T == 16; }

#ifndef CG_CPU_SHIM
template <int S_, int T_, int DIM_>
static cudaError_t cg_launch_flow_fwd(const float* x, const float* params, float* sig,
                                      float* u, int B, int n, int dim, int depth, int S,
                                      int T, float L, cudaStream_t st) {
  const int smem = (int)sizeof(float) * cg_flow_fwd_floats(n, dim, depth, S, T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(cg_flow_fwd_kernel<S_, T_, DIM_>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const int threads = ((n * CG_FWD_SLICES + 31) / 32) * 32;
  cg_flow_fwd_kernel<S_, T_, DIM_><<<B, threads > 256 ? 256 : threads, smem, st>>>(
      x, params, u, sig, n, dim, depth, S, T, L);
  return cudaGetLastError();
}

template <int S_, int T_, int DIM_>
static cudaError_t cg_launch_flow_jac(const float* x, const float* params, const float* sig,
                                      float* J, int B, int n, int dim, int depth, int S,
                                      int T, float L, cudaStream_t st) {
  const int smem = (int)sizeof(float) * cg_flow_jac_floats(n, dim, depth, S, T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(cg_flow_jac_kernel<S_, T_, DIM_>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  cg_flow_jac_kernel<S_, T_, DIM_><<<B * n, 128, smem, st>>>(x, params, sig, J, n, dim,
                                                           depth, S, T, L);
  return cudaGetLastError();
}

extern "C" {

int cg_flow_param_count(int depth, int dim, int S, int T) {
  return cg_param_count(depth, dim, S, T);
}
// Shared memory of one block in bytes, the larger of the two kernels' needs;
// -1 where dim or a feature width is beyond what the kernels take.
int cg_flow_smem(int n, int dim, int depth, int S, int T) {
  if (dim > CG_MAXDIM || S > CG_MAXF || T > CG_MAXF || 2 * dim + 1 > CG_MAXF) return -1;
  return (int)sizeof(float) * cg_imax(cg_flow_fwd_floats(n, dim, depth, S, T),
                                      cg_flow_jac_floats(n, dim, depth, S, T));
}

// x (B, n, dim), params packed as above, sig scratch (B, depth, n, S),
// u (B, n, dim), J (B, nd, nd); all contiguous f32.  Launches both kernels on
// the given stream.  Returns the first non-zero CUDA error, else 0.
int cg_flow_u_jac(const float* x, const float* params, float* sig, float* u,
                  float* J, int B, int n, int dim, int depth, int S, int T,
                  float L, void* stream) {
  if (B <= 0) return 0;
  if (cg_flow_smem(n, dim, depth, S, T) < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool tiled = cg_flow_jac_tiled(dim, S, T);
  cudaError_t e =
      tiled ? cg_launch_flow_fwd<16, 16, 2>(x, params, sig, u, B, n, dim, depth, S, T, L, st)
            : cg_launch_flow_fwd<0, 0, 0>(x, params, sig, u, B, n, dim, depth, S, T, L, st);
  if (e != cudaSuccess) return (int)e;
  if (tiled)
    e = cg_launch_flow_jac<16, 16, 2>(x, params, sig, J, B, n, dim, depth, S, T, L, st);
  else
    e = cg_launch_flow_jac<0, 0, 0>(x, params, sig, J, B, n, dim, depth, S, T, L, st);
  return (int)e;
}

}  // extern "C"
#endif
