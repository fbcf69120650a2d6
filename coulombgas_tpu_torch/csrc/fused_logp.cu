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
// rate as those bytes at the memory rate (n = 29, dim = 2).  In practice the
// kernel is limited by latency: the nd + n dependent elimination steps each
// end in a block-wide barrier.
//
// Design: everything between the inputs and the one output stays in shared
// memory — the angle matrix, cos/sin, the Hermitian Gram H (real and
// imaginary parts), the real Gram G — so device memory is touched once.
// The Hermitian matrix is eliminated in complex form (n steps on n x n)
// rather than through its real 2n x 2n embedding.  sincosf, not the fast
// intrinsic: angles reach tens of radians and the log-det is sensitive to
// them.  About 40 KB of shared memory per block at n = 29, dim = 2, so
// several walkers are resident per SM and hide each other's barriers.
#include <cuda_runtime.h>

#include "chol.cuh"

extern "C" {

// Floats of shared memory for one walker.
__host__ __device__ inline int cg_fused_logp_floats(int n, int dim) {
  const int nd = n * dim;
  return nd * nd + nd * cg_ld(nd) + 2 * n * n + 2 * n * cg_ld(n) + 2 * n * dim;
}

__global__ void cg_fused_logp_kernel(const float* __restrict__ u,
                                     const float* __restrict__ kv,
                                     const float* __restrict__ J,
                                     float* __restrict__ out, int n, int dim,
                                     float c) {
  extern __shared__ float cg_smem[];
  const int nd = n * dim, ldg = cg_ld(nd), ldh = cg_ld(n);
  float* Js = cg_smem;        // nd x nd   J as given
  float* G = Js + nd * nd;    // nd x ldg  J^T J
  float* Dr = G + nd * ldg;   // n x n     Re D
  float* Di = Dr + n * n;     // n x n     Im D
  float* Hr = Di + n * n;     // n x ldh   Re D^H D
  float* Hi = Hr + n * ldh;   // n x ldh   Im D^H D
  float* us = Hi + n * ldh;   // n x dim
  float* ks = us + n * dim;   // n x dim
  const size_t w = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int idx = tid; idx < n * dim; idx += nt) {
    us[idx] = u[w * n * dim + idx];
    ks[idx] = kv[w * n * dim + idx];
  }
  for (int idx = tid; idx < nd * nd; idx += nt) Js[idx] = J[w * nd * nd + idx];
  __syncthreads();

  // D = c exp(i ang), ang[i][m] = sum_d u[i][d] k[m][d]
  for (int idx = tid; idx < n * n; idx += nt) {
    const int i = idx / n, m = idx % n;
    float ang = 0.f;
    for (int d = 0; d < dim; ++d) ang += us[i * dim + d] * ks[m * dim + d];
    float s, co;
    sincosf(ang, &s, &co);
    Dr[idx] = c * co;
    Di[idx] = c * s;
  }
  // G = J^T J, lower triangle (all the elimination reads)
  for (int idx = tid; idx < nd * nd; idx += nt) {
    const int a = idx / nd, b = idx % nd;
    if (b > a) continue;
    float acc = 0.f;
    for (int j = 0; j < nd; ++j) acc += Js[j * nd + a] * Js[j * nd + b];
    G[a * ldg + b] = acc;
  }
  __syncthreads();
  // H = D^H D, lower triangle
  for (int idx = tid; idx < n * n; idx += nt) {
    const int a = idx / n, b = idx % n;
    if (b > a) continue;
    float hr = 0.f, hi = 0.f;
    for (int i = 0; i < n; ++i) {
      const float ar = Dr[i * n + a], ai = Di[i * n + a];
      const float br = Dr[i * n + b], bi = Di[i * n + b];
      hr += ar * br + ai * bi;
      hi += ar * bi - ai * br;
    }
    Hr[a * ldh + b] = hr;
    Hi[a * ldh + b] = hi;
  }
  const float ld_h = cg_chol_logdet_herm(Hr, Hi, n, ldh);
  const float ld_g = cg_chol_logdet_real(G, nd, ldg);
  if (tid == 0) out[w] = ld_h + 0.5f * ld_g;
}

#ifndef CG_CPU_SHIM
int cg_fused_logp_smem(int n, int dim) {
  return (int)sizeof(float) * cg_fused_logp_floats(n, dim);
}

// u, kv (B, n, dim), J (B, nd, nd), out (B,), all contiguous f32;
// c = L^(-dim/2).  Returns cudaGetLastError().
int cg_fused_logp(const float* u, const float* kv, const float* J, float* out,
                  int B, int n, int dim, float c, void* stream) {
  if (B <= 0) return 0;
  const int smem = cg_fused_logp_smem(n, dim);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cg_fused_logp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  cg_fused_logp_kernel<<<B, 256, smem, (cudaStream_t)stream>>>(u, kv, J, out, n, dim, c);
  return (int)cudaGetLastError();
}
#endif

}  // extern "C"
