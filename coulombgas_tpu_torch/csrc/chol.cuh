// Block-cooperative pivot-free Cholesky eliminations on one small matrix held
// in shared memory.  Shared by fused_logp.cu and chol_logdet.cu.
//
// Semantics (identical to ops/logdet.py:chol_logdet_ref of the port and to
// the reference's coulombgas_tpu/ops/logdet.py): at step k the pivot
// d = A[k][k]; if d < PIVOT_FLOOR the step is deflated — it contributes
// log(PIVOT_FLOOR) and its column takes no part in the update — so a singular
// matrix gives a large negative, finite log-determinant, never NaN.
// Otherwise log d is added and the trailing block gets the rank-1 update
// A[r][c] -= A[r][k] A[c][k] / d.
//
// Only the lower triangle (row >= column) is read and updated: step k reads
// column k below the diagonal, and nothing later reads above it.  So a caller
// needs to fill the lower triangle only.
//
// Every thread of the block must call these functions; each returns the
// log-determinant in every thread.  The matrix is destroyed.
#pragma once
#include <math.h>

#define CG_PIVOT_FLOOR 1e-30f

// Row stride for an m-column matrix in shared memory: odd, so that a walk
// down a column touches distinct banks.
__host__ __device__ inline int cg_ld(int m) { return m | 1; }

// The threads of a block as a TX x TY grid over (column, row) of the trailing
// block, so that the update needs no division: 16 x 16 for the 256 threads the
// launchers use.  Threads beyond TX * TY (a block size that is no multiple of
// 16) take no part.
struct CgGrid {
  int tx, ty, TX, TY;
  __device__ CgGrid() {
    TX = blockDim.x >= 16 ? 16 : 1;
    TY = blockDim.x / TX;
    tx = threadIdx.x % TX;
    ty = threadIdx.x / TX;
  }
};

// Real symmetric positive definite, m x m, row stride ld.
__device__ inline float cg_chol_logdet_real(float* A, int m, int ld) {
  const float log_floor = logf(CG_PIVOT_FLOOR);
  const CgGrid g;
  float acc = 0.f;
  for (int k = 0; k < m; ++k) {
    __syncthreads();  // the previous step's update is complete
    const float d = A[k * ld + k];
    const bool bad = d < CG_PIVOT_FLOOR;
    const float d_use = bad ? 1.f : d;
    acc += bad ? log_floor : logf(d_use);
    if (!bad && g.ty < g.TY) {  // `bad` is uniform: every thread read the same d
      const float inv = 1.f / d_use;
      // Column k is read only; the writes go to rows > k, columns k < c <= r.
      for (int r = k + 1 + g.ty; r < m; r += g.TY) {
        const float ark = A[r * ld + k] * inv;
        for (int c = k + 1 + g.tx; c <= r; c += g.TX) A[r * ld + c] -= ark * A[c * ld + k];
      }
    }
  }
  return acc;
}

// Complex Hermitian positive definite H = Hr + i Hi, n x n, row stride ld.
// Update: H[r][c] -= H[r][k] conj(H[c][k]) / d.
__device__ inline float cg_chol_logdet_herm(float* Hr, float* Hi, int n, int ld) {
  const float log_floor = logf(CG_PIVOT_FLOOR);
  const CgGrid g;
  float acc = 0.f;
  for (int k = 0; k < n; ++k) {
    __syncthreads();
    const float d = Hr[k * ld + k];  // the diagonal of a Hermitian matrix is real
    const bool bad = d < CG_PIVOT_FLOOR;
    const float d_use = bad ? 1.f : d;
    acc += bad ? log_floor : logf(d_use);
    if (!bad && g.ty < g.TY) {
      const float inv = 1.f / d_use;
      for (int r = k + 1 + g.ty; r < n; r += g.TY) {
        const float ar = Hr[r * ld + k] * inv, ai = Hi[r * ld + k] * inv;
        for (int c = k + 1 + g.tx; c <= r; c += g.TX) {
          const float br = Hr[c * ld + k], bi = Hi[c * ld + k];
          Hr[r * ld + c] -= ar * br + ai * bi;
          Hi[r * ld + c] -= ai * br - ar * bi;
        }
      }
    }
  }
  return acc;
}
