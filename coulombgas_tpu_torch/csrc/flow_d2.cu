// Depth-2 FermiNet flow in closed structured form: forward, coordinate
// Jacobian and (as a compile-time switch) coordinate Laplacian for a walker
// batch, with no carried Jacobian state.
//
//   x (B, n, dim)  ->  u (B, n, dim),  J (B, nd, nd)   rows (i, b), cols (l, a)
//                      lap (B, nd)     lap[(i,b)] = sum_{l,a} d^2 u[i][b] / d x[l][a]^2
//
// Replaces: coulombgas_tpu/ops/pallas_flow_jac.py, flow_u_jac_pallas_d2
// (kernel bodies _d2_tp_kernel, _d2_G_kernel, _d2_J_kernel) and
// flow_u_jac_lap_pallas_d2 (_d2_kernel with emit_lap).  Same mathematics as the
// plain versions models/ferminet_jac.py:ferminet_apply_and_jac_d2 and
// ferminet_apply_jac_lap_d2:
//
//   J[i][l] = delta_il (I + D_i M_i - SumA1_i N_i) + A0[i][l] K_i + A1[i][l] N_i
//             + G_l R_i
//
// with per-row matrices M, K, N, R (a few hundred floats a row), the row
// quantities D, SumA1 and the mean accumulator G_l = D_l - (1/n) sum_k sig0_k *
// (A0[k][l] W3_0).  The Laplacian adds the squared-first-derivative sums of the
// softplus chain rule, split as JfW1[i][l] = delta_il T_i + U[i][l] + V_l.
//
// Bound on this card: operations.  What must move is x in and u, J (nd*nd
// floats a walker) and lap out, 28.5 MB at n = 29 and batch 2048; the closure
// needs about 1.0 Mflop a walker for J (2.7 Mflop with the Laplacian) and
// some 55 transcendental calls per pair, which takes longer at the f32 rate
// than those bytes at the memory rate.
//
// Two kernels.  K5, u and J alone (cg_flow_d2_rows_kernel), gives a warp to
// each particle row and keeps no pair table; its design is set out above it.
// K6, with the Laplacian (cg_flow_d2_kernel<true, dim>):
//
// Design: one block per walker, everything but x, the weights and the outputs
// stays in shared memory.  The pair derivative blocks A0[i][j] have 3 non-zero
// entries per coordinate, all functions of (cos, sin)(2 pi r / L), |sin(pi r /
// L)| and its gradient; a table of those 3 dim + 1 numbers per pair (24 KB at
// n = 29, 91 KB at n = 57) is built once and every later phase rebuilds A0,
// A1, A0 W on the spot from it, so no (n, n, dim, width) tensor ever exists.
// Each phase gives one thread one output element and lets it loop over the
// reduction index (j, k or l) in ascending order: no partial sums cross
// threads, no atomics, and a walker's result does not depend on the batch it
// is in.  Barriers order the two cross-row reductions (G needs every sig0,
// the Laplacian's cross term needs every V).
#include <cuda_runtime.h>
#include <math.h>

#define CG_D2_MAXDIM 3
#define CG_D2_THREADS 256

__host__ __device__ inline int cg_d2_odd(int v) { return v | 1; }
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

// Offsets (in floats) of the arrays one block keeps in shared memory.
struct cg_d2_layout {
  int Pm, xs, tab, tp0m, sA, tp1m, sumA1, sig0, sp1, sig1, spfin, spmean;
  int D, G, M, K, N, R, dg;
  int hd, Ltp0m, Ltp1m, sq0p, Lsp1, Lsp1mean, V, VV, Lfin;  // Laplacian only
  int total;
};

__host__ __device__ inline int cg_d2_take(int* o, int k) {
  const int r = *o;
  *o += k;
  return r;
}

__host__ __device__ inline cg_d2_layout cg_d2_make_layout(int n, int dim, int S, int T,
                                                          bool lap) {
  const int C0 = 2 * dim + 1, PF = cg_d2_odd(3 * dim + 1), SP = cg_d2_odd(S);
  cg_d2_layout l;
  int o = 0;
  l.Pm = cg_d2_take(&o, cg_d2_up4(cg_d2_params(dim, S, T)));
  l.xs = cg_d2_take(&o, n * dim);
  l.tab = cg_d2_take(&o, n * n * PF);       // pair table, see cg_d2_kernel
  l.tp0m = cg_d2_take(&o, n * C0);          // mean_j tp0[i][j]
  l.sA = cg_d2_take(&o, n * dim * 3);       // sum_j of A0[i][j]'s 3 entries per d
  l.tp1m = cg_d2_take(&o, n * T);           // mean_j tp1[i][j]
  l.sumA1 = cg_d2_take(&o, n * dim * T);    // sum_j A1[i][j]
  l.sig0 = cg_d2_take(&o, n * S);
  l.sp1 = cg_d2_take(&o, n * S);
  l.sig1 = cg_d2_take(&o, n * S);
  l.spfin = cg_d2_take(&o, n * S);
  l.spmean = cg_d2_take(&o, S);
  l.D = cg_d2_take(&o, n * dim * S);
  l.G = cg_d2_take(&o, n * dim * SP);       // odd row stride: read across l
  l.M = cg_d2_take(&o, n * S * dim);
  l.K = cg_d2_take(&o, n * C0 * dim);
  l.N = cg_d2_take(&o, n * T * dim);
  l.R = cg_d2_take(&o, n * S * dim);
  l.dg = cg_d2_take(&o, n * dim * dim);     // D_i M_i - SumA1_i N_i
  l.hd = l.Ltp0m = l.Ltp1m = l.sq0p = l.Lsp1 = l.Lsp1mean = l.V = l.VV = l.Lfin = 0;
  if (lap) {
    l.hd = cg_d2_take(&o, n * n);           // sum_a d^2 dij / d r_a^2
    l.Ltp0m = cg_d2_take(&o, n * C0);
    l.Ltp1m = cg_d2_take(&o, n * T);
    l.sq0p = cg_d2_take(&o, n * S);         // sum_{j,d} (A0[i][j] W3_0)^2
    l.Lsp1 = cg_d2_take(&o, n * S);
    l.Lsp1mean = cg_d2_take(&o, S);
    l.V = cg_d2_take(&o, n * dim * S);
    l.VV = cg_d2_take(&o, S);
    l.Lfin = cg_d2_take(&o, n * S);
  }
  l.total = o;
  return l;
}

// A template over the Laplacian switch and dim: with dim a constant every
// loop over coordinates unrolls and the small per-thread arrays stay in
// registers.  The feature widths S and T are taken at run time.
template <bool LAP, int DIM_>
__global__ void cg_flow_d2_kernel(const float* __restrict__ x,
                                  const float* __restrict__ params,
                                  float* __restrict__ u, float* __restrict__ J,
                                  float* __restrict__ lap, int n, int S, int T,
                                  float L) {
  extern __shared__ __align__(16) float cg_smem[];
  constexpr int dim = DIM_, DM = DIM_, C0 = 2 * DIM_ + 1, PF = (3 * DIM_ + 1) | 1;
  const int nd = n * dim, SP = cg_d2_odd(S);
  const cg_d2_layout o = cg_d2_make_layout(n, dim, S, T, LAP);
  float* Pm = cg_smem + o.Pm;
  float* xs = cg_smem + o.xs;
  // Pair (i, j), r = x_i - x_j:  e[d] = cos(k2 r_d), e[dim + d] = sin(k2 r_d),
  // e[2 dim] = dij = |sin(k1 r)| (these C0 numbers are tp0[i][j]), and
  // e[2 dim + 1 + d] = d dij / d r_d.  The non-zero entries of
  // A0[i][j][d][:] = d tp0[i][j] / d x_i[d] are then
  //   [d] = -k2 e[dim + d],  [dim + d] = k2 e[d],  [2 dim] = e[2 dim + 1 + d],
  // and A0[i][i] = 0.
  float* tab = cg_smem + o.tab;
  float* tp0m = cg_smem + o.tp0m;
  float* sA = cg_smem + o.sA;
  float* tp1m = cg_smem + o.tp1m;
  float* sumA1 = cg_smem + o.sumA1;
  float* sig0 = cg_smem + o.sig0;
  float* sp1 = cg_smem + o.sp1;
  float* sig1 = cg_smem + o.sig1;
  float* spfin = cg_smem + o.spfin;
  float* spmean = cg_smem + o.spmean;
  float* Dm = cg_smem + o.D;
  float* G = cg_smem + o.G;
  float* Mm = cg_smem + o.M;
  float* Km = cg_smem + o.K;
  float* Nm = cg_smem + o.N;
  float* Rm = cg_smem + o.R;
  float* dg = cg_smem + o.dg;
  float* hd = cg_smem + o.hd;
  float* Ltp0m = cg_smem + o.Ltp0m;
  float* Ltp1m = cg_smem + o.Ltp1m;
  float* sq0p = cg_smem + o.sq0p;
  float* Lsp1 = cg_smem + o.Lsp1;
  float* Lsp1mean = cg_smem + o.Lsp1mean;
  float* V = cg_smem + o.V;
  float* VV = cg_smem + o.VV;
  float* Lfin = cg_smem + o.Lfin;

  const float* w30 = Pm + 2 * dim * S;         // rows of sp_w[0] that meet mean_j tp0
  const float* b0 = Pm + (2 * dim + C0) * S;
  const float* W1 = b0 + S;                    // sp_w[1]: rows for sp, mean sp, mean tp
  const float* W2 = W1 + S * S;
  const float* W3 = W2 + S * S;
  const float* b1 = W3 + T * S;
  const float* wt = b1 + S;                    // tp_w[0] (C0 x T)
  const float* bt = wt + C0 * T;
  const float* wf = bt + T;                    // final_w (S x dim)
  const float* bf = wf + S * dim;

  const size_t w = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float k1 = 3.14159265358979323846f / L, k2 = 2.f * k1;
  const float inv_n = 1.f / (float)n;
  const int P = cg_d2_params(dim, S, T);

  for (int idx = tid; idx < P; idx += nt) Pm[idx] = params[idx];
  for (int idx = tid; idx < nd; idx += nt) xs[idx] = x[w * nd + idx];
  __syncthreads();

  // ---- pair table -------------------------------------------------------------
  for (int p = tid; p < n * n; p += nt) {
    const int i = p / n, j = p % n;
    float* e = tab + p * PF;
    float s1v[DM], c1v[DM];
    float sumsq = 0.f;
#pragma unroll
    for (int d = 0; d < DM; ++d)
      if (d < dim) {
        const float r = xs[i * dim + d] - xs[j * dim + d];
        float s2, c2;
        sincosf(k2 * r, &s2, &c2);
        sincosf(k1 * r, &s1v[d], &c1v[d]);
        sumsq += s1v[d] * s1v[d];
        e[d] = c2;
        e[dim + d] = s2;
      }
    const float dij = (i == j) ? 0.f : sqrtf(sumsq);
    const float safe = dij > 0.f ? dij : 1.f;
    e[2 * dim] = dij;
    float h = 0.f;
#pragma unroll
    for (int d = 0; d < DM; ++d)
      if (d < dim) {
        e[2 * dim + 1 + d] = (i == j) ? 0.f : k1 * s1v[d] * c1v[d] / safe;
        if (LAP) {
          // d = |s|: d''_a = (s'_a^2 + s_a s''_a) / d - (s_a s'_a)^2 / d^3
          const float sp_ = k1 * c1v[d], spp = -(k1 * k1) * s1v[d];
          const float ssp = s1v[d] * sp_;
          h += (sp_ * sp_ + s1v[d] * spp) / safe - ssp * ssp / (safe * safe * safe);
        }
      }
    if (LAP) hd[p] = (i == j) ? 0.f : h;
  }
  __syncthreads();

  // ---- sums over j of the pair quantities of row i -----------------------------
  for (int idx = tid; idx < n * C0; idx += nt) {
    const int i = idx / C0, c = idx % C0;
    float s = 0.f, sl = 0.f;
    for (int j = 0; j < n; ++j) {
      const float v = tab[(i * n + j) * PF + c];
      s += v;
      if (LAP && j != i)  // Laplacian of tp0: -2 k2^2 (cos, sin), 2 hd
        sl += (c < 2 * dim) ? -2.f * k2 * k2 * v : 2.f * hd[i * n + j];
    }
    tp0m[idx] = s * inv_n;
    if (LAP) Ltp0m[idx] = sl * inv_n;
  }
  for (int idx = tid; idx < nd * 3; idx += nt) {
    const int i = idx / (dim * 3), d = (idx / 3) % dim, q = idx % 3;
    float s = 0.f;
    for (int j = 0; j < n; ++j)
      if (j != i) {
        const float* e = tab + (i * n + j) * PF;
        s += (q == 0) ? -k2 * e[dim + d] : (q == 1) ? k2 * e[d] : e[2 * dim + 1 + d];
      }
    sA[idx] = s;
  }
  // pair-local tp layer: tp1 = softplus(tp0 wt + bt), A1 = sigmoid(.) * (A0 wt)
  for (int idx = tid; idx < n * T; idx += nt) {
    const int i = idx / T, c = idx % T;
    float wc[C0];
#pragma unroll
    for (int c0 = 0; c0 < C0; ++c0) wc[c0] = (c0 < C0) ? wt[c0 * T + c] : 0.f;
    const float bc = bt[c];
    float sum_tp = 0.f, sumL = 0.f, sumA[DM];
#pragma unroll
    for (int d = 0; d < DM; ++d) sumA[d] = 0.f;
    for (int j = 0; j < n; ++j) {
      const float* e = tab + (i * n + j) * PF;
      float pre = bc;
#pragma unroll
      for (int c0 = 0; c0 < C0; ++c0)
        if (c0 < C0) pre += e[c0] * wc[c0];
      sum_tp += cg_d2_softplus(pre);
      if (j != i) {
        const float sg = cg_d2_sigmoid(pre);
        float sq = 0.f, ltw = 2.f * (LAP ? hd[i * n + j] : 0.f) * wc[2 * dim];
#pragma unroll
        for (int d = 0; d < DM; ++d)
          if (d < dim) {
            const float awt = -k2 * e[dim + d] * wc[d] + k2 * e[d] * wc[dim + d] +
                              e[2 * dim + 1 + d] * wc[2 * dim];
            sumA[d] += sg * awt;
            sq += awt * awt;
            ltw += -2.f * k2 * k2 * (e[d] * wc[d] + e[dim + d] * wc[dim + d]);
          }
        if (LAP) sumL += sg * ltw + sg * (1.f - sg) * 2.f * sq;
      }
    }
    tp1m[idx] = sum_tp * inv_n;
#pragma unroll
    for (int d = 0; d < DM; ++d)
      if (d < dim) sumA1[(i * dim + d) * T + c] = sumA[d];
    if (LAP) Ltp1m[idx] = sumL * inv_n;
  }
  if (LAP)
    for (int idx = tid; idx < n * S; idx += nt) {
      const int i = idx / S, s = idx % S;
      float acc = 0.f;
      for (int j = 0; j < n; ++j)
        if (j != i) {
          const float* e = tab + (i * n + j) * PF;
#pragma unroll
          for (int d = 0; d < DM; ++d)
            if (d < dim) {
              const float aw = -k2 * e[dim + d] * w30[d * S + s] +
                               k2 * e[d] * w30[(dim + d) * S + s] +
                               e[2 * dim + 1 + d] * w30[2 * dim * S + s];
              acc += aw * aw;
            }
        }
      sq0p[idx] = acc;
    }
  __syncthreads();

  // ---- layer 0 of the sp stream -------------------------------------------------
  for (int idx = tid; idx < n * S; idx += nt) {
    const int i = idx / S, s = idx % S;
    float pre = b0[s], lt = 0.f;
    for (int c = 0; c < C0; ++c) {
      pre += tp0m[i * C0 + c] * w30[c * S + s];
      if (LAP) lt += Ltp0m[i * C0 + c] * w30[c * S + s];
    }
    const float sg = cg_d2_sigmoid(pre);
    sig0[idx] = sg;
    sp1[idx] = cg_d2_softplus(pre);
    float sqd = 0.f;
    for (int d = 0; d < dim; ++d) {
      const float* a = sA + (i * dim + d) * 3;
      const float saw = a[0] * w30[d * S + s] + a[1] * w30[(dim + d) * S + s] +
                        a[2] * w30[2 * dim * S + s];
      Dm[(i * dim + d) * S + s] = sg * saw * inv_n;
      sqd += saw * saw;
    }
    if (LAP) Lsp1[idx] = sg * lt + sg * (1.f - sg) * (sqd + sq0p[idx]) * inv_n * inv_n;
  }
  __syncthreads();
  for (int s = tid; s < S; s += nt) {
    float m = 0.f, ml = 0.f;
    for (int i = 0; i < n; ++i) {
      m += sp1[i * S + s];
      if (LAP) ml += Lsp1[i * S + s];
    }
    spmean[s] = m * inv_n;
    if (LAP) Lsp1mean[s] = ml * inv_n;
  }
  __syncthreads();

  // ---- final sp layer -------------------------------------------------------------
  for (int idx = tid; idx < n * S; idx += nt) {
    const int i = idx / S, s2 = idx % S;
    float pre = b1[s2];
    for (int s = 0; s < S; ++s)
      pre += sp1[i * S + s] * W1[s * S + s2] + spmean[s] * W2[s * S + s2];
    for (int c = 0; c < T; ++c) pre += tp1m[i * T + c] * W3[c * S + s2];
    sig1[idx] = cg_d2_sigmoid(pre);
    spfin[idx] = sp1[idx] + cg_d2_softplus(pre);
  }
  __syncthreads();
  for (int idx = tid; idx < nd; idx += nt) {
    const int i = idx / dim, b = idx % dim;
    float acc = bf[b];
    for (int s = 0; s < S; ++s) acc += spfin[i * S + s] * wf[s * dim + b];
    u[w * nd + idx] = xs[idx] + acc;
  }
  // per-row matrices: M = (I + W1 diag(sig1)) wf, N = -W3 diag(sig1) wf / n,
  // R = W2 diag(sig1) wf / n
  for (int idx = tid; idx < n * S * dim; idx += nt) {
    const int i = idx / (S * dim), s = (idx / dim) % S, b = idx % dim;
    float m = 0.f, r = 0.f;
    for (int t = 0; t < S; ++t) {
      const float sw = sig1[i * S + t] * wf[t * dim + b];
      m += W1[s * S + t] * sw;
      r += W2[s * S + t] * sw;
    }
    Mm[idx] = wf[s * dim + b] + m;
    Rm[idx] = r * inv_n;
  }
  for (int idx = tid; idx < n * T * dim; idx += nt) {
    const int i = idx / (T * dim), c = (idx / dim) % T, b = idx % dim;
    float acc = 0.f;
    for (int t = 0; t < S; ++t) acc += W3[c * S + t] * sig1[i * S + t] * wf[t * dim + b];
    Nm[idx] = -acc * inv_n;
  }
  __syncthreads();
  // K = -W3_0 diag(sig0) M / n;  dg = D M - SumA1 N
  for (int idx = tid; idx < n * C0 * dim; idx += nt) {
    const int i = idx / (C0 * dim), c = (idx / dim) % C0, b = idx % dim;
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc += w30[c * S + s] * sig0[i * S + s] * Mm[(i * S + s) * dim + b];
    Km[idx] = -acc * inv_n;
  }
  for (int idx = tid; idx < nd * dim; idx += nt) {
    const int i = idx / (dim * dim), a = (idx / dim) % dim, b = idx % dim;
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc += Dm[(i * dim + a) * S + s] * Mm[(i * S + s) * dim + b];
    for (int c = 0; c < T; ++c) acc -= sumA1[(i * dim + a) * T + c] * Nm[(i * T + c) * dim + b];
    dg[idx] = acc;
  }
  // ---- mean accumulator G_l = D_l - (1/n) sum_k sig0_k * (A0[k][l] W3_0) ------------
  for (int idx = tid; idx < n * S; idx += nt) {
    const int l = idx / S, s = idx % S;
    float acc[DM];
#pragma unroll
    for (int d = 0; d < DM; ++d) acc[d] = 0.f;
    for (int k = 0; k < n; ++k)
      if (k != l) {
        const float* e = tab + (k * n + l) * PF;
        const float sg = sig0[k * S + s];
#pragma unroll
        for (int d = 0; d < DM; ++d)
          if (d < dim)
            acc[d] += sg * (-k2 * e[dim + d] * w30[d * S + s] +
                            k2 * e[d] * w30[(dim + d) * S + s] +
                            e[2 * dim + 1 + d] * w30[2 * dim * S + s]);
      }
#pragma unroll
    for (int d = 0; d < DM; ++d)
      if (d < dim) G[(l * dim + d) * SP + s] = Dm[(l * dim + d) * S + s] - acc[d] * inv_n;
  }
  __syncthreads();
  if (LAP) {
    for (int idx = tid; idx < nd * S; idx += nt) {
      const int ld = idx / S, s2 = idx % S;
      float acc = 0.f;
      for (int s = 0; s < S; ++s) acc += G[ld * SP + s] * W2[s * S + s2];
      V[idx] = acc * inv_n;
    }
    __syncthreads();
    for (int s2 = tid; s2 < S; s2 += nt) {
      float acc = 0.f;
      for (int ld = 0; ld < nd; ++ld) acc += V[ld * S + s2] * V[ld * S + s2];
      VV[s2] = acc;
    }
    __syncthreads();
  }

  // ---- Jacobian blocks: one (i, l) pair per thread ----------------------------------
  float* Jw = J + w * nd * nd;
  for (int p = tid; p < n * n; p += nt) {
    const int i = p / n, l = p % n;
    float acc[DM][DM];
#pragma unroll
    for (int a = 0; a < DM; ++a)
#pragma unroll
      for (int b = 0; b < DM; ++b)
        acc[a][b] = (i == l && a < dim && b < dim)
                        ? dg[(i * dim + a) * dim + b] + (a == b ? 1.f : 0.f) : 0.f;
    for (int s = 0; s < S; ++s) {  // G_l R_i
#pragma unroll
      for (int a = 0; a < DM; ++a)
        if (a < dim) {
          const float g = G[(l * dim + a) * SP + s];
#pragma unroll
          for (int b = 0; b < DM; ++b)
            if (b < dim) acc[a][b] += g * Rm[(i * S + s) * dim + b];
        }
    }
    if (i != l) {
      const float* e = tab + p * PF;
      float al[DM], be[DM], ga[DM];
#pragma unroll
      for (int a = 0; a < DM; ++a)
        if (a < dim) {
          al[a] = -k2 * e[dim + a];
          be[a] = k2 * e[a];
          ga[a] = e[2 * dim + 1 + a];
#pragma unroll
          for (int b = 0; b < DM; ++b)  // A0[i][l] K_i
            if (b < dim)
              acc[a][b] += al[a] * Km[(i * C0 + a) * dim + b] +
                           be[a] * Km[(i * C0 + dim + a) * dim + b] +
                           ga[a] * Km[(i * C0 + 2 * dim) * dim + b];
        }
      for (int c = 0; c < T; ++c) {  // A1[i][l] N_i
        float pre = bt[c];
        for (int c0 = 0; c0 < C0; ++c0) pre += e[c0] * wt[c0 * T + c];
        const float sg = cg_d2_sigmoid(pre);
#pragma unroll
        for (int a = 0; a < DM; ++a)
          if (a < dim) {
            const float a1 = sg * (al[a] * wt[a * T + c] + be[a] * wt[(dim + a) * T + c] +
                                   ga[a] * wt[2 * dim * T + c]);
#pragma unroll
            for (int b = 0; b < DM; ++b)
              if (b < dim) acc[a][b] += a1 * Nm[(i * T + c) * dim + b];
          }
      }
    }
#pragma unroll
    for (int a = 0; a < DM; ++a)
#pragma unroll
      for (int b = 0; b < DM; ++b)
        if (a < dim && b < dim) Jw[(i * dim + b) * nd + l * dim + a] = acc[a][b];
  }

  // ---- Laplacian ------------------------------------------------------------------
  if (LAP) {
    // sum over (l, d) of (delta_il T_i + U[i][l] + V_l)^2 for feature s2 of row i
    for (int idx = tid; idx < n * S; idx += nt) {
      const int i = idx / S, s2 = idx % S;
      float Pq[C0];  // (sig0_i * W3_0[c0]) W1, so that (sig0_i * A0 W3_0) W1 = A0 Pq
#pragma unroll
      for (int c0 = 0; c0 < C0; ++c0) {
        float acc = 0.f;
        if (c0 < C0)
          for (int s = 0; s < S; ++s) acc += sig0[i * S + s] * w30[c0 * S + s] * W1[s * S + s2];
        Pq[c0] = acc;
      }
      float sq = VV[s2];
#pragma unroll
      for (int d = 0; d < DM; ++d)
        if (d < dim) {
          float t = 0.f, t3 = 0.f;
          for (int s = 0; s < S; ++s) t += Dm[(i * dim + d) * S + s] * W1[s * S + s2];
          for (int c = 0; c < T; ++c) t3 += sumA1[(i * dim + d) * T + c] * W3[c * S + s2];
          t += t3 * inv_n;
          sq += t * t + 2.f * t * V[(i * dim + d) * S + s2];
        }
      for (int l = 0; l < n; ++l)
        if (l != i) {
          const float* e = tab + (i * n + l) * PF;
          float al[DM], be[DM], ga[DM], uu[DM];
#pragma unroll
          for (int d = 0; d < DM; ++d)
            if (d < dim) {
              al[d] = -k2 * e[dim + d];
              be[d] = k2 * e[d];
              ga[d] = e[2 * dim + 1 + d];
              uu[d] = al[d] * Pq[d] + be[d] * Pq[dim + d] + ga[d] * Pq[2 * dim];
            }
          for (int c = 0; c < T; ++c) {
            float pre = bt[c];
            for (int c0 = 0; c0 < C0; ++c0) pre += e[c0] * wt[c0 * T + c];
            const float sgw = cg_d2_sigmoid(pre) * W3[c * S + s2];
#pragma unroll
            for (int d = 0; d < DM; ++d)
              if (d < dim)
                uu[d] += sgw * (al[d] * wt[d * T + c] + be[d] * wt[(dim + d) * T + c] +
                                ga[d] * wt[2 * dim * T + c]);
          }
#pragma unroll
          for (int d = 0; d < DM; ++d)
            if (d < dim) {
              const float U = -uu[d] * inv_n;
              sq += U * (U + 2.f * V[(l * dim + d) * S + s2]);
            }
        }
      float lf = 0.f;
      for (int s = 0; s < S; ++s)
        lf += Lsp1[i * S + s] * W1[s * S + s2] + Lsp1mean[s] * W2[s * S + s2];
      for (int c = 0; c < T; ++c) lf += Ltp1m[i * T + c] * W3[c * S + s2];
      const float sg = sig1[idx];
      Lfin[idx] = Lsp1[idx] + sg * lf + sg * (1.f - sg) * sq;
    }
    __syncthreads();
    for (int idx = tid; idx < nd; idx += nt) {
      const int i = idx / dim, b = idx % dim;
      float acc = 0.f;
      for (int s = 0; s < S; ++s) acc += Lfin[i * S + s] * wf[s * dim + b];
      lap[w * nd + idx] = acc;
    }
  }
}

// ---- K5: u and J alone, a warp per particle row ------------------------------
//
// One block of CG_D2R_WARPS warps per walker; warp w takes the rows w, w + 8,
// ...  Lane L of a row's warp owns the pairs (i, L) and (i, L + 32) (n <= 64)
// and makes their features in registers from one sincos of the folded half
// angle t = pi r / L per coordinate:
//   sin(2t) = 2 sin t cos t,  cos(2t) = 1 - 2 sin^2 t,  d = |(sin t_a)_a|,
//   d d / d r_a = k1 sin t_a cos t_a / d,
// all of period L in r, so r is folded into [-L/2, L/2] first.  No pair table
// exists: shared memory holds O(n S) floats (the rows' sig0, sp1, D, G, the
// weights and a scratch line per warp).  Three phases, two block barriers:
//   1. a warp per row: sums over j of the features -> sig0, sp1, D of row i;
//   2. a warp per column l: G_l = D_l - (1/n) sum_k sig0_k (A0[k][l] W3_0),
//      A0[k][l] from the pair (l, k) the warp holds (cos and |sin| are even in
//      r, sin and the gradient of |sin| odd); warp 0 also forms mean_i sp1 and
//      the final sp layer's row-independent part b1 + mean_i(sp1) W2;
//   3. a warp per row: the tp layer once per pair (one exp, one division, one
//      log: sigmoid and softplus), its row sum, sig1, u, the row's matrices
//      M, R, N, K, and the row's J blocks (i, l), lane l writing block (i, l)
//      of the contiguous rows (i, b) of J.  The diagonal block takes minus
//      the lanes' sum of A1[i][l] N_i for SumA1_i N_i.
// Sums over the lanes are fixed-order shuffle trees (cg_d2r_tree), sums over
// i ascend in one thread: a walker's result does not depend on its batch.
// tests/test_torch_flow_d2_rows.py holds a numpy model of this order.  Rows
// of four features are read 16 bytes at a time (the zero-padded sig0, G, R,
// W3_0, tp_w with tp_b, and Q = tp_w * N, which turns A1[i][l] N_i into 16
// rows of multiply-adds).  The production widths 16/16 have instantiations
// of their own, so that every loop over a width has a compile-time count;
// a lane owning one pair (n <= 32) takes 80 registers and three blocks an SM,
// two pairs 128 registers and two blocks.
#define CG_D2R_WARPS 8
#define CG_D2R_MAXN 64
#define CG_D2R_MAXW 32

__host__ __device__ constexpr int cg_d2r_pow2(int v) { return v <= 1 ? 1 : 2 * cg_d2r_pow2((v + 1) / 2); }

// Offsets (in floats) of K5's shared arrays.
struct cg_d2r_layout {
  int Pm, W1T, W2T, W3T, W30p, WTB, xs, sig0, sp1, D, G, B1W, scr;
  int S4, SS, GS, QW, scr_stride, total;
};

// A row stride (in floats) of whole 16-byte groups, an odd number of them:
// lanes reading 16 bytes each from rows k then hit distinct bank groups.
__host__ __device__ inline int cg_d2r_stride4(int v) {
  v = cg_d2_up4(v);
  return (v / 4) % 2 ? v : v + 4;
}

__host__ __device__ inline cg_d2r_layout cg_d2r_make_layout(int n, int dim, int S, int T) {
  const int C0 = 2 * dim + 1;
  cg_d2r_layout l;
  int o = 0;
  // Every array starts on a 16-byte boundary; rows read 4 features at a time
  // (sig0, G, W3_0, R, Q) are padded with zeros to S4 = S rounded up to 4.
  l.S4 = cg_d2_up4(S);
  l.SS = cg_d2r_stride4(S);        // lanes read rows k of sig0 and G
  l.GS = cg_d2r_stride4(dim * l.S4);
  l.QW = cg_d2_up4(C0 * dim);
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
  // per warp: row sums (32), sig1 (S), M (S x dim), R (S4 x dim), N (T x dim),
  // K (C0 x dim), D_i M_i (dim x dim), Q[c][q dim + b] = tp_w[q][c] N[c][b]
  l.scr_stride = 32 + cg_d2_up4(S * dim) + cg_d2_up4(S * dim) + l.S4 * dim + cg_d2_up4(T * dim) +
                 cg_d2_up4(C0 * dim) + cg_d2_up4(dim * dim) + T * l.QW;
  l.scr = cg_d2_take(&o, CG_D2R_WARPS * l.scr_stride);
  l.total = o;
  return l;
}

// sin and cos of |t| <= pi/2: Taylor series to t^13 and t^14 (remainders
// below 7e-10), relative accuracy kept for small t.
__device__ inline void cg_d2r_sincos(float t, float* s, float* c) {
  const float t2 = t * t;
  float ps = 1.f / 6227020800.f;
  ps = fmaf(ps, t2, -1.f / 39916800.f);
  ps = fmaf(ps, t2, 1.f / 362880.f);
  ps = fmaf(ps, t2, -1.f / 5040.f);
  ps = fmaf(ps, t2, 1.f / 120.f);
  ps = fmaf(ps, t2, -1.f / 6.f);
  *s = fmaf(t * t2, ps, t);
  float pc = -1.f / 87178291200.f;
  pc = fmaf(pc, t2, 1.f / 479001600.f);
  pc = fmaf(pc, t2, -1.f / 3628800.f);
  pc = fmaf(pc, t2, 1.f / 40320.f);
  pc = fmaf(pc, t2, -1.f / 720.f);
  pc = fmaf(pc, t2, 1.f / 24.f);
  pc = fmaf(pc, t2, -0.5f);
  *c = fmaf(t2, pc, 1.f);
}

// The features of pair (i, j), r = x_i - x_j: e = (cos k2 r, sin k2 r, d) and
// A0[i][j]'s entries al = -k2 sin k2 r, be = k2 cos k2 r, ga = d d / d r;
// A0[i][i] = 0 (r_ii is identically 0).
template <int DIM>
__device__ inline void cg_d2r_pair(const float* xs, int i, int j, float L, float invL,
                                   float k1, float k2, float (&e)[2 * DIM + 1],
                                   float (&al)[DIM], float (&be)[DIM], float (&ga)[DIM]) {
  float s1[DIM], c1[DIM], d2 = 0.f;
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    float r = xs[i * DIM + d] - xs[j * DIM + d];
    r = fmaf(-L, rintf(r * invL), r);
    cg_d2r_sincos(k1 * r, &s1[d], &c1[d]);
    d2 = fmaf(s1[d], s1[d], d2);
  }
  const float inv = d2 > 0.f ? rsqrtf(d2) : 0.f;
  const float self = (i == j) ? 0.f : 1.f;
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    const float c2 = fmaf(-2.f * s1[d], s1[d], 1.f), s2 = 2.f * s1[d] * c1[d];
    e[d] = c2;
    e[DIM + d] = s2;
    al[d] = -k2 * s2;  // s2 = 0 at i == j
    be[d] = self * k2 * c2;
    ga[d] = k1 * s1[d] * c1[d] * inv;
  }
  e[2 * DIM] = d2 * inv;
}

// The warp's sum of V values a lane (V a power of two <= 32): halving rounds
// at lane offsets 16, 8, ... (the lane with the offset's bit keeps its upper
// half and adds the partner's upper half, the other the lower halves), then
// butterfly rounds over the remaining offsets.  Lane L returns the sum of
// value L >> (5 - log2 V).  Destroys v.  Written as a recursion over
// compile-time halves so that every index of v is a constant (v stays in
// registers).
template <int V, int H>
__device__ __forceinline__ void cg_d2r_halve(float (&v)[V], int lane) {
  if constexpr (H >= 1) {
    constexpr int o = 32 * H / V;  // 16 for the first round
    const bool hi = (lane & o) != 0;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const float keep = hi ? v[j + H] : v[j];
      const float send = hi ? v[j] : v[j + H];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
    cg_d2r_halve<V, H / 2>(v, lane);
  }
}

template <int O>
__device__ __forceinline__ float cg_d2r_butterfly(float s) {
  if constexpr (O >= 1) return cg_d2r_butterfly<O / 2>(s + __shfl_xor_sync(0xffffffffu, s, O));
  return s;
}

template <int V>
__device__ __forceinline__ float cg_d2r_tree(float (&v)[V], int lane) {
  cg_d2r_halve<V, V / 2>(v, lane);
  return cg_d2r_butterfly<16 / V>(v[0]);
}

__device__ __forceinline__ float cg_d2r_allsum(float s) { return cg_d2r_butterfly<16>(s); }

// SM, TM: compile-time caps of the widths S, T (16 or 32); EX: the widths
// are the caps (then every loop over a width has a compile-time count); NP:
// the pairs a lane owns in a row (1 for n <= 32, else 2).
template <int DIM, int SM, int TM, int NP, bool EX>
__global__ void __launch_bounds__(32 * CG_D2R_WARPS, NP == 1 ? 3 : 2)
cg_flow_d2_rows_kernel(const float* __restrict__ x, const float* __restrict__ params,
                       float* __restrict__ u, float* __restrict__ J, int n, int S_, int T_,
                       float L) {
  const int S = EX ? SM : S_, T = EX ? TM : T_;
  extern __shared__ __align__(16) float cg_smem[];
  constexpr int dim = DIM, C0 = 2 * DIM + 1, V1 = cg_d2r_pow2(C0 + 3 * DIM);
  const int nd = n * dim, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const cg_d2r_layout o = cg_d2r_make_layout(n, dim, S, T);
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
  float* rs = cg_smem + o.scr + warp * o.scr_stride;  // this warp's scratch line
  float* sig1 = rs + 32;
  float* Mm = sig1 + cg_d2_up4(S * dim);  // sig1 holds sig1[t] wf[t][b]
  float* Rm = Mm + cg_d2_up4(S * dim);
  float* Nm = Rm + S4 * dim;
  float* Km = Nm + cg_d2_up4(T * dim);
  float* dg = Km + cg_d2_up4(C0 * dim);
  float* Qm = dg + cg_d2_up4(dim * dim);

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

  // ---- phase 1: a warp per row i, the sums over j of the pair features ------------
  for (int i = warp; i < n; i += CG_D2R_WARPS) {
    float part[V1];
#pragma unroll
    for (int v = 0; v < V1; ++v) part[v] = 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int j = lane + 32 * p;
      if (j < n) {
        float e[C0], al[DIM], be[DIM], ga[DIM];
        cg_d2r_pair<DIM>(xs, i, j, L, invL, k1, k2, e, al, be, ga);
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
    const float sum = cg_d2r_tree<V1>(part, lane);
    if ((lane & (32 / V1 - 1)) == 0) rs[lane / (32 / V1)] = sum;
    __syncwarp();
    for (int s = lane; s < S; s += 32) {
      float pre = b0[s];
      for (int c = 0; c < C0; ++c) pre += rs[c] * inv_n * w30[c * S + s];
      const float sg = cg_d2_sigmoid(pre);
      sig0[i * SS + s] = sg;
      sp1[i * S + s] = cg_d2_softplus(pre);
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        const float saw = rs[C0 + d] * w30[d * S + s] + rs[C0 + DIM + d] * w30[(dim + d) * S + s] +
                          rs[C0 + 2 * DIM + d] * w30[2 * dim * S + s];
        Dm[(i * dim + d) * S + s] = sg * saw * inv_n;
      }
    }
    __syncwarp();
  }
  __syncthreads();

  // ---- phase 2: a warp per column l, G_l from the mirrored pairs (l, k) --------------
  if (warp == 0) {  // mean_i sp1, and with it the row-independent part of pre1
    float* spmean = rs;
    for (int s = lane; s < S; s += 32) {
      float m = 0.f;
      for (int i = 0; i < n; ++i) m += sp1[i * S + s];
      spmean[s] = m * inv_n;
    }
    __syncwarp();
    for (int s2 = lane; s2 < S; s2 += 32) {
      float b = b1[s2];
      for (int s = 0; s < S; ++s) b += spmean[s] * W2[s * S + s2];
      B1W[s2] = b;
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
        cg_d2r_pair<DIM>(xs, l, k, L, invL, k1, k2, e, al, be, ga);
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
      const float g = cg_d2r_tree<SM>(acc[d], lane);
      const int s = lane / (32 / SM);
      if ((lane & (32 / SM - 1)) == 0 && s < S)
        G[l * GS + d * S4 + s] = Dm[(l * dim + d) * S + s] - g * inv_n;
    }
  }
  __syncthreads();

  // ---- phase 3: a warp per row i, the tp layer and the J blocks of the row ------------
  float* Jw = J + w * nd * nd;
  for (int i = warp; i < n; i += CG_D2R_WARPS) {
    float sigt[NP][TM], al[NP][DIM], be[NP][DIM], ga[NP][DIM], part[TM];
#pragma unroll
    for (int c = 0; c < TM; ++c) part[c] = 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int l = lane + 32 * p;
#pragma unroll
      for (int c = 0; c < TM; ++c) sigt[p][c] = 0.f;
      if (l < n) {
        float e[C0];
        cg_d2r_pair<DIM>(xs, i, l, L, invL, k1, k2, e, al[p], be[p], ga[p]);
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
            sigt[p][c] = pre >= 0.f ? r : ez * r;
            part[c] += fmaxf(pre, 0.f) + __logf(1.f + ez);
          }
      } else {
#pragma unroll
        for (int d = 0; d < DIM; ++d) al[p][d] = be[p][d] = ga[p][d] = 0.f;
      }
    }
    const float sum = cg_d2r_tree<TM>(part, lane);
    if ((lane & (32 / TM - 1)) == 0) rs[lane / (32 / TM)] = sum;  // sum_j tp1[i][j]
    __syncwarp();
    // the final sp layer of row i, and u
    float ub[DIM];
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
    }
#pragma unroll
    for (int b = 0; b < DIM; ++b) {
      const float tot = cg_d2r_allsum(ub[b]);
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
      for (int b = 0; b < DIM; ++b) a1s[a][b] = cg_d2r_allsum(a1s[a][b]);
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
    __syncwarp();
  }
}

#ifndef CG_CPU_SHIM
template <int DIM, int SM, int TM, int NP, bool EX>
static cudaError_t cg_launch_flow_d2_rows_w(const float* x, const float* params, float* u,
                                            float* J, int B, int n, int S, int T, float L,
                                            cudaStream_t st) {
  const int smem = (int)sizeof(float) * cg_d2r_make_layout(n, DIM, S, T).total;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(cg_flow_d2_rows_kernel<DIM, SM, TM, NP, EX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  cg_flow_d2_rows_kernel<DIM, SM, TM, NP, EX><<<B, 32 * CG_D2R_WARPS, smem, st>>>(x, params, u, J,
                                                                                  n, S, T, L);
  return cudaGetLastError();
}

template <int DIM>
static cudaError_t cg_launch_flow_d2_rows(const float* x, const float* params, float* u,
                                          float* J, int B, int n, int S, int T, float L,
                                          cudaStream_t st) {
  // the production widths 16/16 at their own instantiations, any other
  // widths up to 32 at one with run-time widths
  if (S != 16 || T != 16)
    return cg_launch_flow_d2_rows_w<DIM, 32, 32, 2, false>(x, params, u, J, B, n, S, T, L, st);
  if (n <= 32)
    return cg_launch_flow_d2_rows_w<DIM, 16, 16, 1, true>(x, params, u, J, B, n, S, T, L, st);
  return cg_launch_flow_d2_rows_w<DIM, 16, 16, 2, true>(x, params, u, J, B, n, S, T, L, st);
}

template <bool LAP, int DIM_>
static cudaError_t cg_launch_flow_d2_dim(const float* x, const float* params, float* u,
                                         float* J, float* lap, int B, int n, int S, int T,
                                         float L, cudaStream_t st) {
  const int smem = (int)sizeof(float) * cg_d2_make_layout(n, DIM_, S, T, LAP).total;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(cg_flow_d2_kernel<LAP, DIM_>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  cg_flow_d2_kernel<LAP, DIM_><<<B, CG_D2_THREADS, smem, st>>>(x, params, u, J, lap, n, S, T, L);
  return cudaGetLastError();
}

template <bool LAP>
static cudaError_t cg_launch_flow_d2(const float* x, const float* params, float* u, float* J,
                                     float* lap, int B, int n, int dim, int S, int T, float L,
                                     cudaStream_t st) {
  switch (dim) {
    case 1: return cg_launch_flow_d2_dim<LAP, 1>(x, params, u, J, lap, B, n, S, T, L, st);
    case 2: return cg_launch_flow_d2_dim<LAP, 2>(x, params, u, J, lap, B, n, S, T, L, st);
    case 3: return cg_launch_flow_d2_dim<LAP, 3>(x, params, u, J, lap, B, n, S, T, L, st);
  }
  return cudaErrorInvalidValue;
}

extern "C" {

int cg_flow_d2_param_count(int dim, int S, int T) { return cg_d2_params(dim, S, T); }

// Shared memory of one block in bytes of K5 (lap = 0) or K6 (lap = 1); -1
// where dim, or for K5 n or a width, is beyond what the kernel takes.
int cg_flow_d2_smem(int n, int dim, int S, int T, int lap) {
  if (dim < 1 || dim > CG_D2_MAXDIM || n < 1 || S < 1 || T < 1) return -1;
  if (!lap) {
    if (n > CG_D2R_MAXN || S > CG_D2R_MAXW || T > CG_D2R_MAXW) return -1;
    return (int)sizeof(float) * cg_d2r_make_layout(n, dim, S, T).total;
  }
  return (int)sizeof(float) * cg_d2_make_layout(n, dim, S, T, true).total;
}

// x (B, n, dim), params packed as above, u (B, n, dim), J (B, nd, nd); all
// contiguous f32, on the given stream.  Returns the CUDA error, else 0.
int cg_flow_d2_u_jac(const float* x, const float* params, float* u, float* J, int B, int n,
                     int dim, int S, int T, float L, void* stream) {
  if (B <= 0) return 0;
  if (cg_flow_d2_smem(n, dim, S, T, 0) < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dim) {
    case 1: return (int)cg_launch_flow_d2_rows<1>(x, params, u, J, B, n, S, T, L, st);
    case 2: return (int)cg_launch_flow_d2_rows<2>(x, params, u, J, B, n, S, T, L, st);
    case 3: return (int)cg_launch_flow_d2_rows<3>(x, params, u, J, B, n, S, T, L, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The same plus lap (B, nd).
int cg_flow_d2_u_jac_lap(const float* x, const float* params, float* u, float* J, float* lap,
                         int B, int n, int dim, int S, int T, float L, void* stream) {
  if (B <= 0) return 0;
  if (cg_flow_d2_smem(n, dim, S, T, 1) < 0) return (int)cudaErrorInvalidValue;
  return (int)cg_launch_flow_d2<true>(x, params, u, J, lap, B, n, dim, S, T, L,
                                      (cudaStream_t)stream);
}

}  // extern "C"
#endif
