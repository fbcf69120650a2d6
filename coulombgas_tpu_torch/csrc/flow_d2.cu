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

#ifndef CG_CPU_SHIM
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

// Shared memory of one block in bytes, without (lap = 0) or with the
// Laplacian; -1 where dim is beyond what the kernel takes.
int cg_flow_d2_smem(int n, int dim, int S, int T, int lap) {
  if (dim < 1 || dim > CG_D2_MAXDIM || n < 1 || S < 1 || T < 1) return -1;
  return (int)sizeof(float) * cg_d2_make_layout(n, dim, S, T, lap != 0).total;
}

// x (B, n, dim), params packed as above, u (B, n, dim), J (B, nd, nd); all
// contiguous f32, on the given stream.  Returns the CUDA error, else 0.
int cg_flow_d2_u_jac(const float* x, const float* params, float* u, float* J, int B, int n,
                     int dim, int S, int T, float L, void* stream) {
  if (B <= 0) return 0;
  if (cg_flow_d2_smem(n, dim, S, T, 0) < 0) return (int)cudaErrorInvalidValue;
  return (int)cg_launch_flow_d2<false>(x, params, u, J, nullptr, B, n, dim, S, T, L,
                                       (cudaStream_t)stream);
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
