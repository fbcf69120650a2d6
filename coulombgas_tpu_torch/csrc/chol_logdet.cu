// Batched log det of small SPD matrices: one thread block per matrix.
//
// Replaces: coulombgas_tpu/ops/pallas_logdet.py, _chol_logdet_kernel
// (entry point chol_logdet_pallas).
//
// Bound on this card: bytes.  Each matrix is read once from device memory
// (m*m floats) and one float is written; the elimination's m^3/3 multiply-adds
// are far below the f32 rate that those bytes would allow.  What actually
// limits the kernel is the chain of m dependent elimination steps, each
// ending in a block-wide barrier.
//
// Design: the matrix is copied into shared memory once and all m steps run
// there, so device memory is touched once per matrix.  A block of 256 threads
// shares the (m-k-1)^2 updates of a step.  Several blocks are resident per SM
// (13.5 KB of shared memory each at m = 58), which hides the barrier latency
// of one block behind the work of the others.  The row stride is padded to an
// odd number so that column reads do not collide on shared-memory banks.
#include <cuda_runtime.h>

#include "chol.cuh"

extern "C" {

__global__ void cg_chol_logdet_kernel(const float* __restrict__ A,
                                      float* __restrict__ out, int m, int ld) {
  extern __shared__ float cg_smem[];
  const float* a = A + (size_t)blockIdx.x * m * m;
  for (int idx = threadIdx.x; idx < m * m; idx += blockDim.x)
    cg_smem[(idx / m) * ld + idx % m] = a[idx];
  const float v = cg_chol_logdet_real(cg_smem, m, ld);
  if (threadIdx.x == 0) out[blockIdx.x] = v;
}

#ifndef CG_CPU_SHIM
// Shared memory needed for an m x m matrix, in bytes.
int cg_chol_logdet_smem(int m) { return (int)sizeof(float) * m * cg_ld(m); }

// A (B, m, m) contiguous f32, out (B,) f32.  Returns cudaGetLastError().
int cg_chol_logdet(const float* A, float* out, int B, int m, void* stream) {
  if (B <= 0) return 0;
  const int smem = cg_chol_logdet_smem(m);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cg_chol_logdet_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  cg_chol_logdet_kernel<<<B, 256, smem, (cudaStream_t)stream>>>(A, out, m, cg_ld(m));
  return (int)cudaGetLastError();
}
#endif

}  // extern "C"
