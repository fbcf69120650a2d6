// Blocked, deflating, pivot-free Cholesky eliminations run by a group of
// warps of a block, synchronised by their own named barrier.  Used by
// fused_logp.cu, where two groups eliminate two matrices at the same time.
// chol_logdet.cu runs the same order on its own packed storage, every warp
// of its group factoring the panel for its own rows in registers, and takes
// CG_NB, cg_pad_real and cg_tri_tile from here.
//
// Semantics are those of chol.cuh (and of ops/logdet.py:chol_logdet_ref):
// at step k the pivot d = A[k][k]; d < PIVOT_FLOOR deflates the step — it
// contributes log(PIVOT_FLOOR) and its column takes part in no update —
// otherwise log d is added and A[r][c] -= A[r][k] A[c][k] / d for r >= c > k.
//
// Order (right-looking, panels of CG_NB columns):
//   panel    warp 0 of the group eliminates the panel's columns k0 .. k1-1
//            one after the other, over all rows below (lanes over rows,
//            __syncwarp between steps).  A step reads its pivot only after
//            every earlier column — of earlier panels through the trailing
//            updates, of this panel through the steps before — has updated
//            it.  A deflated step zeroes its column below the diagonal and
//            stores 0 as its inverse pivot, so it adds nothing to the rest
//            of its panel and nothing to the trailing product.
//   trailing after one group barrier, every thread of the group takes
//            register tiles of the lower trailing block and subtracts the
//            rank-CG_NB product sum_k (A[r][k] / d_k) A[c][k], k in the panel
//            in ascending order; then one more group barrier.
// So the chain is 2 m / CG_NB group barriers instead of m block barriers.
//
// Storage: row-major, only the lower triangle is meaningful (upper entries
// of diagonal tiles are updated too and never read).  Rows and columns are
// padded to the tile size with finite values (the callers fill the pads with
// zeros); the row stride makes rows start in distinct 16-byte bank groups.
#pragma once
#include <math.h>

#include "chol.cuh"

#define CG_NB 8

// bar.sync on barrier `id` (1..15) for `count` threads (a multiple of 32).
__device__ inline void cg_group_bar(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// The q-th tile (row tr, column tc <= tr) of a lower triangle of tiles.
__device__ inline void cg_tri_tile(int q, int& tr, int& tc) {
  int r = (int)((sqrtf(8.f * (float)q + 1.f) - 1.f) * 0.5f);
  while (r * (r + 1) / 2 > q) --r;
  while ((r + 1) * (r + 2) / 2 <= q) ++r;
  tr = r;
  tc = q - r * (r + 1) / 2;
}

// Row strides: real matrices in floats, m padded to a multiple of 4 and
// the stride = 4 (mod 8); complex float64 ones in pairs, padded to even, odd.
__host__ __device__ inline int cg_pad_real(int m) { return (m + 3) & ~3; }
__host__ __device__ inline int cg_ld_real(int m) {
  const int p = cg_pad_real(m);
  return (p % 8 == 4) ? p : p + 4;
}
__host__ __device__ inline int cg_pad_cplx(int m) { return (m + 1) & ~1; }
__host__ __device__ inline int cg_ld_cplx(int m) { return cg_pad_cplx(m) + 1; }

// Real symmetric, m x m (padded to cg_pad_real(m) rows and columns), row
// stride ld, 16-byte aligned.  Called by all `gsize` threads of the group
// (gtid = 0 .. gsize-1, warp 0 = gtid 0..31); invd: CG_NB floats of shared
// memory.  Returns the log-determinant in warp 0 of the group.
__device__ inline float cg_blocked_chol_real(float* A, int m, int ld, float* invd, int gtid,
                                             int gsize, int bar_id) {
  const float log_floor = logf(CG_PIVOT_FLOOR);
  const int lane = gtid & 31, mp = cg_pad_real(m);
  float acc = 0.f;
  for (int k0 = 0; k0 < m; k0 += CG_NB) {
    const int k1 = k0 + CG_NB < m ? k0 + CG_NB : m;
    if (gtid < 32) {  // the panel, by warp 0
      for (int k = k0; k < k1; ++k) {
        const float d = A[k * ld + k];
        const bool bad = d < CG_PIVOT_FLOOR;  // uniform: every lane read the same d
        acc += bad ? log_floor : logf(d);
        if (bad) {
          for (int r = k + 1 + lane; r < m; r += 32) A[r * ld + k] = 0.f;
          if (lane == 0) invd[k - k0] = 0.f;
        } else {
          const float inv = 1.f / d;
          float colk[CG_NB];  // A[k + cc][k], the panel's later columns' entries
#pragma unroll
          for (int cc = 1; cc < CG_NB; ++cc) colk[cc] = k + cc < k1 ? A[(k + cc) * ld + k] : 0.f;
          for (int r = k + 1 + lane; r < m; r += 32) {
            const float ark = A[r * ld + k] * inv;
            const int ce = r < k1 - 1 ? r : k1 - 1;
#pragma unroll
            for (int cc = 1; cc < CG_NB; ++cc)
              if (k + cc <= ce) A[r * ld + k + cc] -= ark * colk[cc];
          }
          if (lane == 0) invd[k - k0] = inv;
        }
        __syncwarp();
      }
    }
    if (k1 >= m) break;  // no trailing block
    cg_group_bar(bar_id, gsize);
    // trailing block rows/columns k1 .. mp-1 in 4 x 4 tiles
    const int nt = (mp - k1) / 4, ntiles = nt * (nt + 1) / 2;
    for (int q = gtid; q < ntiles; q += gsize) {
      int tr, tc;
      cg_tri_tile(q, tr, tc);
      const int r0 = k1 + 4 * tr, c0 = k1 + 4 * tc;
      float a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(A + (r0 + i) * ld + c0);
        a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < CG_NB; h += 4) {
        float uu[4][4], vv[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 x = *reinterpret_cast<const float4*>(A + (r0 + i) * ld + k0 + h);
          const float4 y = *reinterpret_cast<const float4*>(A + (c0 + i) * ld + k0 + h);
          uu[i][0] = x.x * invd[h]; uu[i][1] = x.y * invd[h + 1];
          uu[i][2] = x.z * invd[h + 2]; uu[i][3] = x.w * invd[h + 3];
          vv[i][0] = y.x; vv[i][1] = y.y; vv[i][2] = y.z; vv[i][3] = y.w;
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) a[i][j] -= uu[i][kk] * vv[j][kk];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(A + (r0 + i) * ld + c0) =
            make_float4(a[i][0], a[i][1], a[i][2], a[i][3]);
    }
    cg_group_bar(bar_id, gsize);
  }
  return acc;
}

// Complex Hermitian H, n x n as float64 (re, im) pairs (padded to
// cg_pad_cplx(n)), row stride ld in pairs (odd: rows start in distinct
// 16-byte bank groups), 16-byte aligned; invd: CG_NB doubles.  Update
// H[r][c] -= H[r][k] conj(H[c][k]) / d, all in float64; the pivot test and
// the log are those of the real elimination.  As cg_blocked_chol_real
// otherwise; 2 x 2 tiles.
__device__ inline float cg_blocked_chol_herm(double2* H, int n, int ld, double* invd, int gtid,
                                             int gsize, int bar_id) {
  const double log_floor = log((double)CG_PIVOT_FLOOR);
  const int lane = gtid & 31, mp = cg_pad_cplx(n);
  double acc = 0.;
  for (int k0 = 0; k0 < n; k0 += CG_NB) {
    const int k1 = k0 + CG_NB < n ? k0 + CG_NB : n;
    if (gtid < 32) {
      for (int k = k0; k < k1; ++k) {
        const double d = H[k * ld + k].x;  // the diagonal of a Hermitian matrix is real
        const bool bad = d < (double)CG_PIVOT_FLOOR;
        acc += bad ? log_floor : log(d);
        if (bad) {
          for (int r = k + 1 + lane; r < n; r += 32) H[r * ld + k] = make_double2(0., 0.);
          if (lane == 0) invd[k - k0] = 0.;
        } else {
          const double inv = 1. / d;
          double2 colk[CG_NB];  // H[k + cc][k]
#pragma unroll
          for (int cc = 1; cc < CG_NB; ++cc)
            colk[cc] = k + cc < k1 ? H[(k + cc) * ld + k] : make_double2(0., 0.);
          for (int r = k + 1 + lane; r < n; r += 32) {
            const double2 h = H[r * ld + k];
            const double ar = h.x * inv, ai = h.y * inv;
            const int ce = r < k1 - 1 ? r : k1 - 1;
#pragma unroll
            for (int cc = 1; cc < CG_NB; ++cc)
              if (k + cc <= ce) {
                const double2 b = colk[cc];
                double2& t = H[r * ld + k + cc];
                t.x -= ar * b.x + ai * b.y;
                t.y -= ai * b.x - ar * b.y;
              }
          }
          if (lane == 0) invd[k - k0] = inv;
        }
        __syncwarp();
      }
    }
    if (k1 >= n) break;
    cg_group_bar(bar_id, gsize);
    const int nt = (mp - k1) / 2, ntiles = nt * (nt + 1) / 2;
    for (int q = gtid; q < ntiles; q += gsize) {
      int tr, tc;
      cg_tri_tile(q, tr, tc);
      const int r0 = k1 + 2 * tr, c0 = k1 + 2 * tc;
      double2 a[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) a[i][j] = H[(r0 + i) * ld + c0 + j];
#pragma unroll 2
      for (int kk = 0; kk < CG_NB; ++kk) {
        const double s = invd[kk];
        double2 uu[2], vv[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const double2 x = H[(r0 + i) * ld + k0 + kk];
          uu[i] = make_double2(x.x * s, x.y * s);
          vv[i] = H[(c0 + i) * ld + k0 + kk];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            a[i][j].x -= uu[i].x * vv[j].x + uu[i].y * vv[j].y;
            a[i][j].y -= uu[i].y * vv[j].x - uu[i].x * vv[j].y;
          }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) H[(r0 + i) * ld + c0 + j] = a[i][j];
    }
    cg_group_bar(bar_id, gsize);
  }
  return (float)acc;
}
