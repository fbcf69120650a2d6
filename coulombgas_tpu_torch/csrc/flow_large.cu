// Depth-2 FermiNet flow forward + coordinate Jacobian, split by particle
// rows into two kernels that meet only through two means over rows.
//
//   x (B, n, dim)  ->  u (B, n, dim),  J (B, nd, nd)   rows (i, b), cols (l, a)
//
// Replaces: coulombgas_tpu/ops/pallas_flow_jac.py, flow_u_jac_pallas_large
// (kernel bodies _layer0_kernel and _final_layer_kernel).  Plain version:
// ops/cuda_flow_large.py:flow_u_jac_large_ref.  The mathematics:
//
//   layer 0   tp0[i][j] = [cos k2 r, sin k2 r, |sin k1 r|],  A0[i][j] = d tp0 / d x_i
//             (the conjugate block is -A0; A0[i][i] = 0);  sp and mean sp are
//             zero, so only the rows [2 dim, 2 dim + C0) of sp_w[0] (W30) act:
//             pre = mean_j tp0[i][j] W30 + b0,  sp1 = softplus(pre),
//             Jsp1[i][l] = sigmoid(pre) (delta_il sum_j AW_ij - AW_il) / n,
//             AW = A0 W30
//   means     spmean = mean_i sp1,  jmean = mean_i Jsp1        (between the kernels)
//   layer 1   tp1 = softplus(tp0 Wt + bt),  A1 = sigmoid(tp0 Wt + bt) (A0 Wt),
//             pre = sp1 W1a + spmean W1b + mean_j tp1 W1c + b1  (W1 = sp_w[1] cut
//             at rows S and 2 S),  sp = sp1 + softplus(pre),
//             Jsp = Jsp1 + sigmoid(pre) (Jsp1 W1a + jmean W1b
//                                        + (delta_il sum_j AW1_ij - AW1_il) / n),
//             AW1 = A1 W1c
//   head      u = x + sp Wf + bf,  J = I + Jsp Wf
//
// Bound on this card: operations.  What must move is x in and u, J out (27 MB
// at n = 57, batch 512); the layer-1 Jacobian alone needs n^2 dim S (S + T)
// multiply-adds a walker, about 10 Mflop a walker in all at n = 57, widths 16
// (5.2 Gflop at batch 512), which takes longer at the f32 rate than those
// bytes at the memory rate.
//
// Design.  The TPU kernel cut rows into chunks of 8/7/6 and walkers into
// 128-lane blocks; here one block owns one walker and a chunk of
// CG_LARGE_ROWS rows (grid: walkers x row chunks, 4096 blocks at n = 57,
// batch 512, enough to fill 132 SMs several times over).  Inside a block the
// rows of the chunk are taken one after the other; for the current row the
// block builds its n pair features (cos, sin, |sin|, d|sin|/dr: 3 dim + 1
// numbers a pair) in shared memory, and every later phase rebuilds A0, AW,
// A1 on the spot from that table.  Only sp1 and Jsp1 go through device
// memory (design "b": tp1 and A1 are per-pair functions of x and are
// rebuilt by the second kernel instead of stored): at n = 57, batch 512,
// Jsp1 is 213 MB written once and read twice (the mean between the kernels,
// then the second kernel), sp1 1.9 MB.  The (n, dim, S) row state of the
// second kernel (Jsp1 of the row, A1, the new Jsp, jmean W1b) lives in
// shared memory, 40 KB at n = 57.  Each phase gives one thread one output
// element and lets it loop over the reduction index in ascending order: no
// partial sums cross threads, no atomics, and a walker's result does not
// depend on the batch it is in.
#include <cuda_runtime.h>
#include <math.h>

#define CG_LARGE_MAXDIM 3
#define CG_LARGE_THREADS 256
#define CG_LARGE_ROWS 8

__host__ __device__ inline int cg_lg_up4(int v) { return (v + 3) & ~3; }

// Packed weights of a depth-2 flow, in the order ops/cuda_flow_jac.py packs
// them: sp_w[0] ((2 dim + C0) x S), sp_b[0], sp_w[1] ((2 S + T) x S), sp_b[1],
// tp_w[0] (C0 x T), tp_b[0], final_w (S x dim), final_b.
__host__ __device__ inline int cg_lg_params(int dim, int S, int T) {
  const int C0 = 2 * dim + 1;
  return (2 * dim + C0) * S + S + (2 * S + T) * S + S + C0 * T + T + S * dim + dim;
}

__host__ __device__ inline int cg_lg_pf(int dim) { return (3 * dim + 1) | 1; }

__device__ inline float cg_lg_sigmoid(float x) { return 1.f / (1.f + expf(-x)); }
// log(1 + e^x) = max(x, 0) + log1p(e^-|x|): logaddexp(x, 0), no threshold.
__device__ inline float cg_lg_softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// Offsets (in floats) of the arrays one block keeps in shared memory.
struct cg_lg_layout0 {
  int P, xs, tab, tp0m, sig0, sumAW, total;
};
struct cg_lg_layout1 {
  int P, xs, tab, jW, spm, jrow, A1, Jsp, tp1s, tp1m, sumA1, sumAW1, sig, spf, sp1r, total;
};

__host__ __device__ inline int cg_lg_take(int* o, int k) {
  const int r = *o;
  *o += k;
  return r;
}

__host__ __device__ inline cg_lg_layout0 cg_lg_make_layout0(int n, int dim, int S, int T) {
  cg_lg_layout0 l;
  int o = 0;
  l.P = cg_lg_take(&o, cg_lg_up4(cg_lg_params(dim, S, T)));
  l.xs = cg_lg_take(&o, n * dim);
  l.tab = cg_lg_take(&o, n * cg_lg_pf(dim));  // pairs (i, j) of the current row i
  l.tp0m = cg_lg_take(&o, 2 * dim + 1);        // mean_j tp0[i][j]
  l.sig0 = cg_lg_take(&o, S);
  l.sumAW = cg_lg_take(&o, dim * S);           // sum_j AW_ij
  l.total = o;
  return l;
}

__host__ __device__ inline cg_lg_layout1 cg_lg_make_layout1(int n, int dim, int S, int T) {
  cg_lg_layout1 l;
  int o = 0;
  l.P = cg_lg_take(&o, cg_lg_up4(cg_lg_params(dim, S, T)));
  l.xs = cg_lg_take(&o, n * dim);
  l.tab = cg_lg_take(&o, n * cg_lg_pf(dim));
  l.jW = cg_lg_take(&o, n * dim * S);   // jmean W1b: the same for every row
  l.spm = cg_lg_take(&o, S);            // spmean
  l.jrow = cg_lg_take(&o, n * dim * S); // Jsp1 of the current row
  l.A1 = cg_lg_take(&o, n * dim * T);   // A1[i][l] of the current row
  l.Jsp = cg_lg_take(&o, n * dim * S);  // the row's Jsp after layer 1
  l.tp1s = cg_lg_take(&o, n * T);       // tp1[i][l]
  l.tp1m = cg_lg_take(&o, T);
  l.sumA1 = cg_lg_take(&o, dim * T);
  l.sumAW1 = cg_lg_take(&o, dim * S);
  l.sig = cg_lg_take(&o, S);
  l.spf = cg_lg_take(&o, S);
  l.sp1r = cg_lg_take(&o, S);
  l.total = o;
  return l;
}

// Pair features of row i against every j, into tab (n x PF):
//   e[d] = cos(k2 r_d), e[dim + d] = sin(k2 r_d), e[2 dim] = dij = |sin(k1 r)|,
//   e[2 dim + 1 + d] = d dij / d r_d,   r = x_i - x_j;
// the pair (i, i) has dij = 0 and a zero gradient.  The non-zero entries of
// A0[i][j][d][:] = d tp0[i][j] / d x_i[d] are then
//   [d] = -k2 e[dim + d],  [dim + d] = k2 e[d],  [2 dim] = e[2 dim + 1 + d].
template <int DIM>
__device__ inline void cg_lg_pair_row(const float* xs, float* tab, int i, int n, float k1,
                                      float k2, int tid, int nt) {
  constexpr int dim = DIM, PF = (3 * DIM + 1) | 1;
  for (int j = tid; j < n; j += nt) {
    float* e = tab + j * PF;
    float s1v[DIM], c1v[DIM];
    float sumsq = 0.f;
#pragma unroll
    for (int d = 0; d < dim; ++d) {
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
#pragma unroll
    for (int d = 0; d < dim; ++d) e[2 * dim + 1 + d] = (i == j) ? 0.f : k1 * s1v[d] * c1v[d] / safe;
  }
}

template <int DIM>
__global__ void cg_flow_large_layer0_kernel(const float* __restrict__ x,
                                            const float* __restrict__ params,
                                            float* __restrict__ sp1, float* __restrict__ Jsp1,
                                            int n, int S, int T, float L) {
  extern __shared__ __align__(16) float cg_smem[];
  constexpr int dim = DIM, C0 = 2 * DIM + 1, PF = (3 * DIM + 1) | 1;
  const int nd = n * dim;
  const cg_lg_layout0 o = cg_lg_make_layout0(n, dim, S, T);
  float* Pm = cg_smem + o.P;
  float* xs = cg_smem + o.xs;
  float* tab = cg_smem + o.tab;
  float* tp0m = cg_smem + o.tp0m;
  float* sig0 = cg_smem + o.sig0;
  float* sumAW = cg_smem + o.sumAW;
  const float* w30 = Pm + 2 * dim * S;  // rows of sp_w[0] that meet mean_j tp0
  const float* b0 = Pm + (2 * dim + C0) * S;

  const size_t w = blockIdx.x;
  const int i0 = blockIdx.y * CG_LARGE_ROWS;
  const int i1 = min(n, i0 + CG_LARGE_ROWS);
  const int tid = threadIdx.x, nt = blockDim.x;
  const float k1 = 3.14159265358979323846f / L, k2 = 2.f * k1;
  const float inv_n = 1.f / (float)n;
  const int P = cg_lg_params(dim, S, T);
  const int rowlen = n * dim * S;

  for (int idx = tid; idx < P; idx += nt) Pm[idx] = params[idx];
  for (int idx = tid; idx < nd; idx += nt) xs[idx] = x[w * nd + idx];
  __syncthreads();

  for (int i = i0; i < i1; ++i) {
    cg_lg_pair_row<DIM>(xs, tab, i, n, k1, k2, tid, nt);
    __syncthreads();
    for (int c = tid; c < C0; c += nt) {
      float s = 0.f;
      for (int j = 0; j < n; ++j) s += tab[j * PF + c];
      tp0m[c] = s * inv_n;
    }
    for (int idx = tid; idx < dim * S; idx += nt) {
      const int d = idx / S, s = idx % S;
      float acc = 0.f;
      for (int j = 0; j < n; ++j)
        if (j != i) {
          const float* e = tab + j * PF;
          acc += -k2 * e[dim + d] * w30[d * S + s] + k2 * e[d] * w30[(dim + d) * S + s] +
                 e[2 * dim + 1 + d] * w30[2 * dim * S + s];
        }
      sumAW[idx] = acc;
    }
    __syncthreads();
    for (int s = tid; s < S; s += nt) {
      float pre = b0[s];
      for (int c = 0; c < C0; ++c) pre += tp0m[c] * w30[c * S + s];
      sig0[s] = cg_lg_sigmoid(pre);
      sp1[(w * n + i) * S + s] = cg_lg_softplus(pre);
    }
    __syncthreads();
    // Jsp1[i][l][d][s], s fastest: neighbouring threads write neighbouring floats
    float* out = Jsp1 + (w * n + i) * (size_t)rowlen;
    for (int idx = tid; idx < rowlen; idx += nt) {
      const int l = idx / (dim * S), d = (idx / S) % dim, s = idx % S;
      float v;
      if (l == i) {
        v = sumAW[d * S + s];
      } else {
        const float* e = tab + l * PF;
        v = -(-k2 * e[dim + d] * w30[d * S + s] + k2 * e[d] * w30[(dim + d) * S + s] +
              e[2 * dim + 1 + d] * w30[2 * dim * S + s]);
      }
      out[idx] = sig0[s] * v * inv_n;
    }
    __syncthreads();  // tab and sig0 are rewritten for the next row
  }
}

template <int DIM>
__global__ void cg_flow_large_final_kernel(const float* __restrict__ x,
                                           const float* __restrict__ params,
                                           const float* __restrict__ sp1,
                                           const float* __restrict__ Jsp1,
                                           const float* __restrict__ spmean,
                                           const float* __restrict__ jmean,
                                           float* __restrict__ u, float* __restrict__ J,
                                           int n, int S, int T, float L) {
  extern __shared__ __align__(16) float cg_smem[];
  constexpr int dim = DIM, C0 = 2 * DIM + 1, PF = (3 * DIM + 1) | 1;
  const int nd = n * dim;
  const cg_lg_layout1 o = cg_lg_make_layout1(n, dim, S, T);
  float* Pm = cg_smem + o.P;
  float* xs = cg_smem + o.xs;
  float* tab = cg_smem + o.tab;
  float* jW = cg_smem + o.jW;
  float* spm = cg_smem + o.spm;
  float* jrow = cg_smem + o.jrow;
  float* A1 = cg_smem + o.A1;
  float* Jsp = cg_smem + o.Jsp;
  float* tp1s = cg_smem + o.tp1s;
  float* tp1m = cg_smem + o.tp1m;
  float* sumA1 = cg_smem + o.sumA1;
  float* sumAW1 = cg_smem + o.sumAW1;
  float* sig = cg_smem + o.sig;
  float* spf = cg_smem + o.spf;
  float* sp1r = cg_smem + o.sp1r;

  const float* W1a = Pm + (2 * dim + C0) * S + S;  // sp_w[1]: rows for sp, mean sp, mean tp
  const float* W1b = W1a + S * S;
  const float* W1c = W1b + S * S;
  const float* b1 = W1c + T * S;
  const float* wt = b1 + S;                        // tp_w[0] (C0 x T)
  const float* bt = wt + C0 * T;
  const float* wf = bt + T;                        // final_w (S x dim)
  const float* bf = wf + S * dim;

  const size_t w = blockIdx.x;
  const int i0 = blockIdx.y * CG_LARGE_ROWS;
  const int i1 = min(n, i0 + CG_LARGE_ROWS);
  const int tid = threadIdx.x, nt = blockDim.x;
  const float k1 = 3.14159265358979323846f / L, k2 = 2.f * k1;
  const float inv_n = 1.f / (float)n;
  const int P = cg_lg_params(dim, S, T);
  const int rowlen = n * dim * S;

  for (int idx = tid; idx < P; idx += nt) Pm[idx] = params[idx];
  for (int idx = tid; idx < nd; idx += nt) xs[idx] = x[w * nd + idx];
  for (int s = tid; s < S; s += nt) spm[s] = spmean[w * S + s];
  __syncthreads();
  // jmean W1b, (l, d) rows: the cross-row term, shared by every row of the chunk
  const float* jm = jmean + w * (size_t)rowlen;
  for (int idx = tid; idx < rowlen; idx += nt) {
    const int ld = idx / S, s2 = idx % S;
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc += jm[ld * S + s] * W1b[s * S + s2];
    jW[idx] = acc;
  }

  float* Jw = J + w * (size_t)nd * nd;
  for (int i = i0; i < i1; ++i) {
    cg_lg_pair_row<DIM>(xs, tab, i, n, k1, k2, tid, nt);
    const float* jin = Jsp1 + (w * n + i) * (size_t)rowlen;
    for (int idx = tid; idx < rowlen; idx += nt) jrow[idx] = jin[idx];
    for (int s = tid; s < S; s += nt) sp1r[s] = sp1[(w * n + i) * S + s];
    __syncthreads();
    // pair-local tp layer of row i: tp1 = softplus(tp0 wt + bt),
    // A1 = sigmoid(tp0 wt + bt) * (A0 wt), zero on the diagonal pair
    for (int idx = tid; idx < n * T; idx += nt) {
      const int l = idx / T, c = idx % T;
      const float* e = tab + l * PF;
      float pre = bt[c];
#pragma unroll
      for (int c0 = 0; c0 < C0; ++c0) pre += e[c0] * wt[c0 * T + c];
      tp1s[idx] = cg_lg_softplus(pre);
      const float sg = cg_lg_sigmoid(pre);
#pragma unroll
      for (int d = 0; d < dim; ++d)
        A1[(l * dim + d) * T + c] =
            (l == i) ? 0.f
                     : sg * (-k2 * e[dim + d] * wt[d * T + c] + k2 * e[d] * wt[(dim + d) * T + c] +
                             e[2 * dim + 1 + d] * wt[2 * dim * T + c]);
    }
    __syncthreads();
    for (int c = tid; c < T; c += nt) {
      float s = 0.f;
      for (int l = 0; l < n; ++l) s += tp1s[l * T + c];
      tp1m[c] = s * inv_n;
    }
    for (int idx = tid; idx < dim * T; idx += nt) {
      const int d = idx / T, c = idx % T;
      float s = 0.f;
      for (int l = 0; l < n; ++l) s += A1[(l * dim + d) * T + c];
      sumA1[idx] = s;
    }
    __syncthreads();
    // last sp layer of row i (residual), and sum_j AW1_ij = (sum_j A1_ij) W1c
    for (int s2 = tid; s2 < S; s2 += nt) {
      float pre = b1[s2];
      for (int s = 0; s < S; ++s) pre += sp1r[s] * W1a[s * S + s2] + spm[s] * W1b[s * S + s2];
      for (int c = 0; c < T; ++c) pre += tp1m[c] * W1c[c * S + s2];
      sig[s2] = cg_lg_sigmoid(pre);
      spf[s2] = sp1r[s2] + cg_lg_softplus(pre);
    }
    for (int idx = tid; idx < dim * S; idx += nt) {
      const int d = idx / S, s2 = idx % S;
      float acc = 0.f;
      for (int c = 0; c < T; ++c) acc += sumA1[d * T + c] * W1c[c * S + s2];
      sumAW1[idx] = acc;
    }
    __syncthreads();
    for (int b = tid; b < dim; b += nt) {
      float acc = bf[b];
      for (int s = 0; s < S; ++s) acc += spf[s] * wf[s * dim + b];
      u[(w * n + i) * dim + b] = xs[i * dim + b] + acc;
    }
    // Jsp[i][l][d][s2] = Jsp1 + sig (Jsp1 W1a + jmean W1b + (delta_il sumAW1 - AW1_il) / n)
    for (int idx = tid; idx < rowlen; idx += nt) {
      const int ld = idx / S, d = ld % dim, l = ld / dim, s2 = idx % S;
      float acc = jW[idx];
      const float* jr = jrow + ld * S;
      for (int s = 0; s < S; ++s) acc += jr[s] * W1a[s * S + s2];
      float aw = (l == i) ? sumAW1[d * S + s2] : 0.f;
      const float* a1 = A1 + ld * T;
      for (int c = 0; c < T; ++c) aw -= a1[c] * W1c[c * S + s2];
      Jsp[idx] = jrow[idx] + sig[s2] * (acc + aw * inv_n);
    }
    __syncthreads();
    // J[(i, b), (l, a)] = delta + sum_s Jsp[l][a][s] wf[s][b]; (l, a) fastest
    for (int idx = tid; idx < dim * nd; idx += nt) {
      const int b = idx / nd, la = idx % nd;
      float acc = (la == i * dim + b) ? 1.f : 0.f;
      for (int s = 0; s < S; ++s) acc += Jsp[la * S + s] * wf[s * dim + b];
      Jw[(size_t)(i * dim + b) * nd + la] = acc;
    }
    __syncthreads();  // the row's tables are rewritten for the next row
  }
}

#ifndef CG_CPU_SHIM
template <int DIM>
static cudaError_t cg_launch_large_dim(const float* x, const float* params, float* sp1,
                                       float* Jsp1, const float* spmean, const float* jmean,
                                       float* u, float* J, int B, int n, int S, int T, float L,
                                       bool final, cudaStream_t st) {
  const dim3 grid(B, (n + CG_LARGE_ROWS - 1) / CG_LARGE_ROWS);
  if (!final) {
    const int smem = (int)sizeof(float) * cg_lg_make_layout0(n, DIM, S, T).total;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(cg_flow_large_layer0_kernel<DIM>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
    }
    cg_flow_large_layer0_kernel<DIM><<<grid, CG_LARGE_THREADS, smem, st>>>(x, params, sp1, Jsp1,
                                                                          n, S, T, L);
  } else {
    const int smem = (int)sizeof(float) * cg_lg_make_layout1(n, DIM, S, T).total;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(cg_flow_large_final_kernel<DIM>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
    }
    cg_flow_large_final_kernel<DIM><<<grid, CG_LARGE_THREADS, smem, st>>>(
        x, params, sp1, Jsp1, spmean, jmean, u, J, n, S, T, L);
  }
  return cudaGetLastError();
}

static cudaError_t cg_launch_large(const float* x, const float* params, float* sp1, float* Jsp1,
                                   const float* spmean, const float* jmean, float* u, float* J,
                                   int B, int n, int dim, int S, int T, float L, bool final,
                                   cudaStream_t st) {
  switch (dim) {
    case 1: return cg_launch_large_dim<1>(x, params, sp1, Jsp1, spmean, jmean, u, J, B, n, S, T, L, final, st);
    case 2: return cg_launch_large_dim<2>(x, params, sp1, Jsp1, spmean, jmean, u, J, B, n, S, T, L, final, st);
    case 3: return cg_launch_large_dim<3>(x, params, sp1, Jsp1, spmean, jmean, u, J, B, n, S, T, L, final, st);
  }
  return cudaErrorInvalidValue;
}

extern "C" {

int cg_flow_large_param_count(int dim, int S, int T) { return cg_lg_params(dim, S, T); }

int cg_flow_large_rows_per_block() { return CG_LARGE_ROWS; }

// Shared memory of one block in bytes, the larger of the two kernels' needs;
// -1 where dim is beyond what the kernels take.
int cg_flow_large_smem(int n, int dim, int S, int T) {
  if (dim < 1 || dim > CG_LARGE_MAXDIM || n < 1 || S < 1 || T < 1) return -1;
  const int a = cg_lg_make_layout0(n, dim, S, T).total, b = cg_lg_make_layout1(n, dim, S, T).total;
  return (int)sizeof(float) * (a > b ? a : b);
}

// Layer 0: x (B, n, dim), params packed as above -> sp1 (B, n, S),
// Jsp1 (B, n, n, dim, S); all contiguous f32, on the given stream.  Returns
// the CUDA error, else 0.
int cg_flow_large_layer0(const float* x, const float* params, float* sp1, float* Jsp1, int B,
                         int n, int dim, int S, int T, float L, void* stream) {
  if (B <= 0) return 0;
  if (cg_flow_large_smem(n, dim, S, T) < 0) return (int)cudaErrorInvalidValue;
  return (int)cg_launch_large(x, params, sp1, Jsp1, nullptr, nullptr, nullptr, nullptr, B, n, dim,
                              S, T, L, false, (cudaStream_t)stream);
}

// Layer 1 and the head: x, params, sp1, Jsp1 as written by layer 0, spmean
// (B, S) = mean_i sp1, jmean (B, n, dim, S) = mean_i Jsp1 -> u (B, n, dim),
// J (B, nd, nd).
int cg_flow_large_final(const float* x, const float* params, const float* sp1, const float* Jsp1,
                        const float* spmean, const float* jmean, float* u, float* J, int B, int n,
                        int dim, int S, int T, float L, void* stream) {
  if (B <= 0) return 0;
  if (cg_flow_large_smem(n, dim, S, T) < 0) return (int)cudaErrorInvalidValue;
  return (int)cg_launch_large(x, params, const_cast<float*>(sp1), const_cast<float*>(Jsp1),
                              spmean, jmean, u, J, B, n, dim, S, T, L, true,
                              (cudaStream_t)stream);
}

}  // extern "C"
#endif
