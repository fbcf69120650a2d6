// Fused Metropolis log-density tail: one thread block per walker.
//
//   logp = log det(D^H D) + 1/2 log det(J^T J),
//   D[i][m] = L^(-dim/2) exp(i k_m . u_i)
//
// Replaces: coulombgas_tpu/ops/pallas_fused_logp.py, _fused_logp_kernel
// (entry point fused_logp_pallas).
//
// Bound on this card: operations, narrowly.  Per walker the kernel must read
// J (nd*nd floats) and u, k (n*dim each) and write one float; the lower
// triangles of the two Gram products (nd^3 + 4 n^3 flops) and the two
// eliminations (nd^3/3 + 4 n^3/3) take about 1.4 times as long at the f32
// rate as those bytes at the memory rate (n = 29, dim = 2).  What sets the
// time in practice is latency: the eliminations are chains of dependent
// steps.
//
// Design: the block's warps are two groups that work at the same time, each
// synchronised by its own named barrier (bar.sync id, count), so neither
// waits on the other's steps.  12 warps (8 + 4) at n = 57, dim 2; 6 (4 + 2)
// where nd <= 108, so that four blocks share an SM at n = 29:
//
//   G group     G = J^T J: J is streamed through a three-stage ring of 4-row
//               tiles by cp.async, each thread accumulating up to three 4 x 4
//               register tiles of the lower triangle (J is never held whole);
//               then the blocked elimination of G (chol_blocked.cuh).
//   H group     D (sincosf, not the fast intrinsic: angles reach tens of
//               radians), H = D^H D in 2 x 2 complex register tiles, and the
//               blocked elimination of H in complex form (n steps on n x n,
//               not its real 2n x 2n embedding), both in float64.
//
// Why H is float64: H is ill-conditioned on thermalised walkers (cond 4e5 at
// n = 57 on the checkpoint's).  There an n-term f32 sum in order moves its
// log det by about 0.06, ten times what a blocked f32 matrix product does,
// and even an exact H rounded to f32 leaves the f32 elimination 4e-3 off; and
// where D is singular (two equal rows of u) an f32 H has a pivot of roundoff
// size 1e-7 rather than 1e-16, so the log-density of such a proposal is not
// strongly negative.  In f64 the error is that of D's f32 entries (1e-5).
// The f64 units are otherwise idle, and the H group's chain is the shorter
// one.  G = J^T J is well-conditioned (J is near the identity) and stays
// f32: there an f32 sum in order is within 1e-5 of f64 at n = 57.
//
// The eliminations go by panels of 8 columns: one warp factors the panel
// (its pivots, deflation decisions and in-panel updates, __syncwarp between
// steps), then its group subtracts the rank-8 trailing product in register
// tiles, with two group barriers a panel: 2 nd / 8 + 2 n / 8 barriers on two
// independent chains instead of nd + n block-wide ones.  The block-wide
// barriers are three: after u, k are loaded; once both Grams are computed
// (D lies where G is stored, so G's tiles leave their registers only after
// H's Gram has read D); and before the result is written.  Shared memory:
// G, H, the ring, u, k: 33 KB at n = 29 and 112 KB at n = 57 (dim 2), so two
// blocks are resident per SM at n = 57; 80 registers a thread, so four
// 6-warp blocks at n = 29.
// The n ceiling: nd <= 152 (three tiles of G a thread).
#include <cuda_runtime.h>

#include "chol_blocked.cuh"

#define CG_FL_MAXWARPS 12  // two thirds for G, one third for H
#define CG_FL_RING 4    // rows of J in a ring stage
#define CG_FL_STAGES 3  // ring stages
#define CG_FL_TILES 3   // 4 x 4 tiles of G a thread accumulates
#define CG_FL_MAXND (4 * 38)  // 38 tile rows: 741 <= 3 x 256 tiles

__host__ __device__ inline int cg_fl_up4(int v) { return (v + 3) & ~3; }

extern "C" {

// Floats of shared memory for one walker: G's storage (which holds D before
// G's tiles are stored), H (float64 pairs), the ring, u and k, the two
// panels' inverse pivots (float64 for H) and the two results.
__host__ __device__ inline int cg_fused_logp_floats(int n, int dim) {
  const int m = n * dim;
  const int g = cg_pad_real(m) * cg_ld_real(m), d = 2 * n * cg_pad_cplx(n);
  return cg_fl_up4(g > d ? g : d) + 4 * cg_pad_cplx(n) * cg_ld_cplx(n) +
         CG_FL_STAGES * CG_FL_RING * cg_pad_real(m) + cg_fl_up4(2 * n * dim) + 3 * CG_NB + 4;
}

}  // extern "C"

__device__ inline void cg_cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ inline void cg_cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ inline void cg_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(32 * CG_FL_MAXWARPS, 2)
cg_fused_logp_kernel(const float* __restrict__ u, const float* __restrict__ kv,
                     const float* __restrict__ J, float* __restrict__ out, int n, int dim,
                     float c) {
  extern __shared__ __align__(16) float cg_smem[];
  const int GT = 32 * (2 * (blockDim.x >> 5) / 3), HT = blockDim.x - GT;
  const int m = n * dim, mpg = cg_pad_real(m), ldg = cg_ld_real(m);
  const int mph = cg_pad_cplx(n), ldh = cg_ld_cplx(n);
  const int greg = cg_fl_up4(mpg * ldg > 2 * n * mph ? mpg * ldg : 2 * n * mph);
  float* G = cg_smem;                                  // mpg x ldg   J^T J
  float2* D = reinterpret_cast<float2*>(cg_smem);      // n x mph     D, before G is stored
  double2* H = reinterpret_cast<double2*>(G + greg);   // mph x ldh   D^H D (float64)
  float* ring = reinterpret_cast<float*>(H + mph * ldh);  // stages x CG_FL_RING x mpg
  float* us = ring + CG_FL_STAGES * CG_FL_RING * mpg;  // n x dim
  float* ks = us + n * dim;                            // n x dim
  double* invd_h = reinterpret_cast<double*>(us + cg_fl_up4(2 * n * dim));  // CG_NB
  float* invd_g = reinterpret_cast<float*>(invd_h + CG_NB);                 // CG_NB
  float* res = invd_g + CG_NB;                         // log det G, log det H
  const size_t w = blockIdx.x;
  const int tid = threadIdx.x;

  for (int idx = tid; idx < n * dim; idx += blockDim.x) {
    us[idx] = u[w * n * dim + idx];
    ks[idx] = kv[w * n * dim + idx];
  }
  __syncthreads();

  float acc[CG_FL_TILES][4][4];
  int r0[CG_FL_TILES], c0[CG_FL_TILES];
  const int ntg = mpg / 4, ntiles_g = ntg * (ntg + 1) / 2;
  if (tid < GT) {
    // ---- G = J^T J, lower triangle, J streamed through the ring ----------------
    const float* Jw = J + w * m * m;
#pragma unroll
    for (int t = 0; t < CG_FL_TILES; ++t) {
      const int q = tid + t * GT;
      int tr = 0, tc = 0;
      if (q < ntiles_g) cg_tri_tile(q, tr, tc);
      r0[t] = 4 * tr;
      c0[t] = 4 * tc;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[t][i][j] = 0.f;
    }
    // the ring's pad columns stay zero, so pad rows and columns of G are zero
    for (int idx = tid; idx < CG_FL_STAGES * CG_FL_RING * (mpg - m); idx += GT) {
      const int row = idx / (mpg - m), col = m + idx % (mpg - m);
      ring[row * mpg + col] = 0.f;
    }
    const int nch = (m + CG_FL_RING - 1) / CG_FL_RING;
    auto fetch = [&](int ch) {
      float* st = ring + (ch % CG_FL_STAGES) * CG_FL_RING * mpg;
      const int rows = (m - ch * CG_FL_RING) < CG_FL_RING ? m - ch * CG_FL_RING : CG_FL_RING;
      const float* src = Jw + ch * CG_FL_RING * m;
      for (int e = tid; e < rows * m; e += GT) {
        const int jj = e / m, col = e - jj * m;
        cg_cp_async4(st + jj * mpg + col, src + e);
      }
      cg_cp_commit();
    };
    // Chunk ch + 2 goes into the stage chunk ch - 1 was read from, after the
    // barrier that follows every thread's reads of it: one barrier a chunk.
    fetch(0);
    if (nch > 1) fetch(1);
    for (int ch = 0; ch < nch; ++ch) {
      if (ch + 1 < nch)
        cg_cp_wait<1>();
      else
        cg_cp_wait<0>();
      cg_group_bar(1, GT);  // chunk ch has landed for every thread
      if (ch + 2 < nch) fetch(ch + 2);
      const float* st = ring + (ch % CG_FL_STAGES) * CG_FL_RING * mpg;
      const int rows = (m - ch * CG_FL_RING) < CG_FL_RING ? m - ch * CG_FL_RING : CG_FL_RING;
      for (int jj = 0; jj < rows; ++jj) {
#pragma unroll
        for (int t = 0; t < CG_FL_TILES; ++t)
          if (tid + t * GT < ntiles_g) {
            const float4 a = *reinterpret_cast<const float4*>(st + jj * mpg + r0[t]);
            const float4 b = *reinterpret_cast<const float4*>(st + jj * mpg + c0[t]);
            const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[t][i][j] += av[i] * bv[j];
          }
      }
    }
  } else {
    // ---- D, then H = D^H D, lower triangle ----------------------------------
    const int hid = tid - GT;
    for (int idx = hid; idx < n * mph; idx += HT) {
      const int i = idx / mph, mm = idx - i * mph;
      float2 v = make_float2(0.f, 0.f);  // the pad column stays zero
      if (mm < n) {
        float ang = 0.f;
        for (int d = 0; d < dim; ++d) ang += us[i * dim + d] * ks[mm * dim + d];
        float s, co;
        sincosf(ang, &s, &co);
        v = make_float2(c * co, c * s);
      }
      D[idx] = v;
    }
    cg_group_bar(2, HT);
    const int nth = mph / 2, ntiles_h = nth * (nth + 1) / 2;
    for (int q = hid; q < ntiles_h; q += HT) {
      int tr, tc;
      cg_tri_tile(q, tr, tc);
      const int a0 = 2 * tr, b0 = 2 * tc;
      double hr[2][2] = {{0., 0.}, {0., 0.}}, hi[2][2] = {{0., 0.}, {0., 0.}};
      for (int i = 0; i < n; ++i) {
        const float4 da = *reinterpret_cast<const float4*>(D + i * mph + a0);
        const float4 db = *reinterpret_cast<const float4*>(D + i * mph + b0);
        const double ar[2] = {da.x, da.z}, ai[2] = {da.y, da.w};
        const double br[2] = {db.x, db.z}, bi[2] = {db.y, db.w};
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int q2 = 0; q2 < 2; ++q2) {
            hr[p][q2] += ar[p] * br[q2] + ai[p] * bi[q2];
            hi[p][q2] += ar[p] * bi[q2] - ai[p] * br[q2];
          }
      }
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int q2 = 0; q2 < 2; ++q2) H[(a0 + p) * ldh + b0 + q2] = make_double2(hr[p][q2], hi[p][q2]);
    }
  }
  __syncthreads();  // both Grams are computed: D is read, G may be stored over it

  if (tid < GT) {
#pragma unroll
    for (int t = 0; t < CG_FL_TILES; ++t)
      if (tid + t * GT < ntiles_g)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<float4*>(G + (r0[t] + i) * ldg + c0[t]) =
              make_float4(acc[t][i][0], acc[t][i][1], acc[t][i][2], acc[t][i][3]);
    cg_group_bar(1, GT);
    const float ld_g = cg_blocked_chol_real(G, m, ldg, invd_g, tid, GT, 1);
    if (tid == 0) res[0] = ld_g;
  } else {
    const int hid = tid - GT;
    const float ld_h = cg_blocked_chol_herm(H, n, ldh, invd_h, hid, HT, 2);
    if (hid == 0) res[1] = ld_h;
  }
  __syncthreads();
  if (tid == 0) out[w] = res[1] + 0.5f * res[0];
}

// Shared memory needed for one walker in bytes; -1 beyond the n ceiling.
extern "C" int cg_fused_logp_smem(int n, int dim) {
  if (n * dim > CG_FL_MAXND) return -1;
  return (int)sizeof(float) * cg_fused_logp_floats(n, dim);
}

// Warps of a block: 6 (4 for G, 2 for H) where G's tiles fit three a thread
// of 128 (nd <= 108), so that four blocks and their four elimination chains
// share an SM; else 12.
inline int cg_fused_logp_warps(int n, int dim) {
  const int nt = cg_pad_real(n * dim) / 4;
  return nt * (nt + 1) / 2 <= CG_FL_TILES * 128 ? 6 : CG_FL_MAXWARPS;
}

extern "C" {

// u, kv (B, n, dim), J (B, nd, nd), out (B,), all contiguous f32;
// c = L^(-dim/2).  Returns cudaGetLastError().
int cg_fused_logp(const float* u, const float* kv, const float* J, float* out,
                  int B, int n, int dim, float c, void* stream) {
  if (B <= 0) return 0;
  const int smem = cg_fused_logp_smem(n, dim);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cg_fused_logp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  cg_fused_logp_kernel<<<B, 32 * cg_fused_logp_warps(n, dim), smem, (cudaStream_t)stream>>>(
      u, kv, J, out, n, dim, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
