// Batched log det of small SPD matrices: persistent groups of warps, each
// eliminating one matrix at a time in panels of CG_NB columns.
//
// Replaces: coulombgas_tpu/ops/pallas_logdet.py, _chol_logdet_kernel
// (entry point chol_logdet_pallas).
//
// Bound on this card: each matrix's lower triangle is read once from device
// memory (m (m + 1) / 2 floats) and one float is written; the elimination
// takes m^3/3 f32 operations.  At B 512 / m 171 the operations bound
// (0.0127 ms) is above the bytes bound (0.0090 ms); at m <= 114 bytes bound
// (chip_smoke.py:k3_bound).  What limits the kernel is latency: the chain of
// m dependent pivots per matrix (a shuffle, a division, two multiply-adds
// each), which runs well below the speed of its own dependencies beside the
// SM's other warps, and the shared-memory traffic of the trailing updates between the
// panels.
//
// Design (the launch plan — warps a group, groups a block, shared bytes,
// grid — is computed in Python by ops/cuda_logdet.py:k3_plan and checked
// here):
//   groups   a group of 1-8 warps owns one matrix at a time, synchronised by
//            __syncwarp (one warp) or its own named barrier (bar.sync id,
//            count; ids 1..15), never by a block-wide one; a block holds
//            several groups.  Groups are persistent: the grid is at most what
//            is resident, and group g takes matrices g, g + G, g + 2G, ...
//            The run-time ids make ptxas reserve all 16 barriers, so an SM
//            holds at most 4 blocks; the plan counts that.
//   storage  a matrix lives in shared memory as its lower triangle packed by
//            rows of 4 x 4 tiles (row r holds columns 0 .. 4 floor(r/4) + 3),
//            8 T (T + 1) floats for T = ceil(m/4): about half of m^2, so a
//            group fits every m <= 256 (137 KB at m 241, 72 KB at m 171,
//            11.5 KB at m 58, with the panel's columns).  Entries above the
//            diagonal within a diagonal tile, and the pad rows up to 4 T,
//            are zeros.
//   loading  4-byte cp.async of the lower triangle only (a row of A is
//            16-byte aligned only when m is a multiple of 4, and 4-byte
//            aligned for odd m), hidden by the other groups of the SM.  One
//            buffer a group: a second, to fetch the next matrix during this
//            one, would halve the groups an SM holds.
//   panel    every warp of the group holds the panel's 8 columns of its
//            share of the rows below k0 in registers (S slots of 32 rows a
//            lane) and a replica of the 8 x 8 diagonal block in lanes 0..7,
//            takes each pivot and the column entries of the block by
//            __shfl_sync within the warp, and updates its rows: no value
//            crosses warps inside a panel, and the pivot chain's
//            instructions are spread over the group.  A pivot below the
//            floor adds log(PIVOT_FLOOR), zeroes its column below the
//            diagonal and gets the inverse pivot 0; the lane of each pivot's
//            row takes its logarithm once.  Each warp writes its rows of the
//            panel column-major twice: V as eliminated and U = V / pivot.
//   trailing after one group barrier every thread of the group takes 4 x 4
//            register tiles of the lower trailing block and subtracts
//            sum_k U[k][r] V[k][c], k ascending, with 16-byte loads (U's
//            rows are broadcast within a tile row, V's are consecutive);
//            then one more barrier.  2 m / 8 barriers a matrix, not m.
// The arithmetic of each matrix is fixed by m alone (every replica of the
// diagonal block and every row takes the same operations, one thread owns
// each tile), so any plan, batch size or position in the batch gives the
// same bits — those of the one-step-per-barrier kernel this replaces, whose
// updates are the same fused multiply-adds in the same order.  Tensor cores
// are not used: the work is bound by latency and shared memory, not by
// arithmetic, and TF32 keeps three digits.
#include <cuda_runtime.h>

#include "chol_blocked.cuh"  // CG_NB, cg_pad_real, cg_tri_tile; CG_PIVOT_FLOOR

#define CG_K3_MAXM 256   // S <= 8 slots a lane for one warp
#define CG_K3_BLOCK 256  // most threads a block
#define CG_K3_SMEM_LIMIT 232448

// Floats of one packed matrix, and the offset of its row r.
__host__ __device__ inline int cg_k3_matrix_floats(int m) {
  const int t = (m + 3) >> 2;
  return 8 * t * (t + 1);
}
__device__ inline int cg_k3_row(int r) {
  const int t = r >> 2;
  return 8 * t * (t + 1) + (r & 3) * 4 * (t + 1);
}

// Floats of one group: its packed matrix, then the panel's columns, U and V
// (CG_NB rows of cg_pad_real(m) each).  Every part is a multiple of 4
// floats, so all stay 16-byte aligned.
__host__ __device__ inline int cg_k3_group_floats(int m) {
  return cg_k3_matrix_floats(m) + 2 * CG_NB * cg_pad_real(m);
}

#ifndef CG_CPU_SHIM
// The group's barrier: the warp's own for one warp, else named barrier
// `bar_id` for the group's `gsize` threads.
__device__ inline void cg_k3_sync(int bar_id, int gsize) {
  if (gsize == 32)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(bar_id), "r"(gsize) : "memory");
}
__device__ inline void cg_k3_cp4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ inline void cg_k3_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ inline void cg_k3_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
#endif

// Matrix b of A into the packed buffer M: its lower triangle by cp.async,
// zeros above the diagonal within the diagonal tiles and in the pad rows.
// Warps take rows in turn, lanes the columns of a row.
__device__ inline void cg_k3_fetch(float* M, const float* __restrict__ A, int b, int m, int gtid,
                                   int gsize) {
  const float* a = A + (size_t)b * m * m;
  const int lane = gtid & 31, warps = gsize >> 5, mp = cg_pad_real(m);
  for (int r = gtid >> 5; r < mp; r += warps) {
    float* row = M + cg_k3_row(r);
    const float* src = a + (size_t)r * m;
    const int len = (r & ~3) + 4, lim = r < m ? r : -1;
    for (int c = lane; c < len; c += 32) {
      if (c <= lim)
        cg_k3_cp4(row + c, src + c);
      else
        row[c] = 0.f;
    }
  }
}

// Row of the panel at (warp w of W, slot s, lane): slot 0 of lanes 0..7 holds
// the panel's own rows k0 .. k0+7 in every warp; the rows below go 24 a warp
// to lanes 8..31 of slot 0, then 32 a warp to each further slot.
__device__ inline int cg_k3_prow(int k0, int w, int W, int s, int lane) {
  return s == 0 ? (lane < 8 ? k0 + lane : k0 + 24 * w + lane)
                : k0 + 8 + 24 * W + 32 * ((s - 1) * W + w) + lane;
}

// Slots a lane needs for a matrix of m (padded to mp) rows in a group of W
// warps: the template parameter S of the instantiation.
__host__ __device__ inline int cg_k3_slots(int m, int W) {
  const int below = cg_pad_real(m) - 8 - 24 * W;
  return below > 0 ? 1 + (below + 32 * W - 1) / (32 * W) : 1;
}

// The panel of columns k0 .. k0+7, by every warp of the group for its rows:
// its rows from M into registers (rows k0 .. k0+3 store only up to column
// k0+3, the rest is above the diagonal), the 8 pivot steps on its replica
// of the diagonal block and its rows below, and, unless it is the last
// panel, U and V of its rows k0+8 .. mp-1.  Warp 0 adds the logarithms of
// the pivots to acc, each taken by the lane of its row, in order.
template <int S>
__device__ inline void cg_k3_panel(const float* M, float* U, float* V, int m, int k0, int w,
                                   int W, int lane, float& acc) {
  const int mp = cg_pad_real(m);
  float p[S][CG_NB];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int r = cg_k3_prow(k0, w, W, s, lane);
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
    if (r < m) {
      const float* row = M + cg_k3_row(r) + k0;
      lo = *reinterpret_cast<const float4*>(row);
      if (r >= k0 + 4) hi = *reinterpret_cast<const float4*>(row + 4);
    }
    p[s][0] = lo.x; p[s][1] = lo.y; p[s][2] = lo.z; p[s][3] = lo.w;
    p[s][4] = hi.x; p[s][5] = hi.y; p[s][6] = hi.z; p[s][7] = hi.w;
  }
  float invd[CG_NB];
#pragma unroll
  for (int kk = 0; kk < CG_NB; ++kk) {
    invd[kk] = 0.f;
    if (k0 + kk < m) {  // uniform
      // pivot A[k][k] and A[k+cc][k]: column kk of rows k0 + kk .. k0 + 7,
      // slot 0 of lanes kk .. 7
      const float d = __shfl_sync(0xffffffffu, p[0][kk], kk);
      float colk[CG_NB];
#pragma unroll
      for (int cc = kk + 1; cc < CG_NB; ++cc) colk[cc] = __shfl_sync(0xffffffffu, p[0][kk], cc);
      const bool bad = d < CG_PIVOT_FLOOR;  // uniform: every lane has the same d
      const float inv = bad ? 0.f : 1.f / d;
      invd[kk] = inv;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const bool below = s > 0 || lane > kk;  // row > k
        const float ark = below ? p[s][kk] * inv : 0.f;
        if (bad && below) p[s][kk] = 0.f;
#pragma unroll
        for (int cc = kk + 1; cc < CG_NB; ++cc) p[s][cc] -= ark * colk[cc];
      }
    }
  }
  if (w == 0) {  // lane kk < 8 still holds pivot kk in p[0][kk]
    float d = p[0][0];
#pragma unroll
    for (int kk = 1; kk < CG_NB; ++kk)
      if (lane == kk) d = p[0][kk];
    const float lg = d < CG_PIVOT_FLOOR ? logf(CG_PIVOT_FLOOR) : logf(d);
#pragma unroll
    for (int kk = 0; kk < CG_NB; ++kk) {
      const float l = __shfl_sync(0xffffffffu, lg, kk);
      if (k0 + kk < m) acc += l;
    }
  }
  if (k0 + CG_NB >= m) return;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int r = cg_k3_prow(k0, w, W, s, lane);
    if ((s > 0 || lane >= 8) && r < mp) {
#pragma unroll
      for (int kk = 0; kk < CG_NB; ++kk) {
        V[kk * mp + r] = p[s][kk];
        U[kk * mp + r] = p[s][kk] * invd[kk];
      }
    }
  }
}

// Tile (tr, tc) of M loses sum_k U[k][4 tr + i] V[k][4 tc + j], k ascending.
__device__ inline void cg_k3_tile(float* M, const float* U, const float* V, int mp, int tr, int tc) {
  float* tile = M + 8 * tr * (tr + 1) + 4 * tc;
  const int ld = 4 * (tr + 1);
  float a[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(tile + i * ld);
    a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
  }
#pragma unroll
  for (int kk = 0; kk < CG_NB; ++kk) {
    const float4 x = *reinterpret_cast<const float4*>(U + kk * mp + 4 * tr);
    const float4 y = *reinterpret_cast<const float4*>(V + kk * mp + 4 * tc);
    const float u[4] = {x.x, x.y, x.z, x.w}, v[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[i][j] -= u[i] * v[j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(tile + i * ld) = make_float4(a[i][0], a[i][1], a[i][2], a[i][3]);
}

// Deflating blocked elimination of the packed matrix M (destroyed); U, V:
// the group's panel columns.  Called by all `gsize` threads of the group;
// returns the log-determinant in warp 0.
template <int S>
__device__ inline float cg_k3_eliminate(float* M, float* U, float* V, int m, int gtid, int gsize,
                                        int bar_id) {
  const int lane = gtid & 31, w = gtid >> 5, W = gsize >> 5, mp = cg_pad_real(m);
  float acc = 0.f;
  for (int k0 = 0; k0 < m; k0 += CG_NB) {
    if (k0 > 0) cg_k3_sync(bar_id, gsize);  // the last trailing update is complete
    cg_k3_panel<S>(M, U, V, m, k0, w, W, lane, acc);
    if (k0 + CG_NB >= m) break;
    cg_k3_sync(bar_id, gsize);  // U and V are written
    const int t1 = (k0 + CG_NB) >> 2, nt = (mp >> 2) - t1;
    for (int q = gtid; q < nt * (nt + 1) / 2; q += gsize) {
      int tr, tc;
      cg_tri_tile(q, tr, tc);
      cg_k3_tile(M, U, V, mp, t1 + tr, t1 + tc);
    }
  }
  return acc;
}

// Register budget from the panel's size: 64 registers a thread up to 2 slots
// of rows a lane, 80 up to 4, 128 above (blocks of 256 threads: 4, 3, 2 an
// SM; ops/cuda_logdet.py:_register_cap counts the same).
#define CG_K3_MINB(S) ((S) <= 2 ? 4 : (S) <= 4 ? 3 : 2)

template <int S>
__global__ void __launch_bounds__(CG_K3_BLOCK, CG_K3_MINB(S))
cg_chol_logdet_kernel(const float* __restrict__ A, float* __restrict__ out, int B, int m,
                      int warps) {
  extern __shared__ __align__(16) float cg_smem[];
  const int gsize = 32 * warps, groups = blockDim.x / gsize;
  const int gib = threadIdx.x / gsize, gtid = threadIdx.x - gib * gsize;
  const int stride = gridDim.x * groups;  // G, the groups of the grid
  float* const M = cg_smem + gib * cg_k3_group_floats(m);
  float* const U = M + cg_k3_matrix_floats(m);
  float* const V = U + CG_NB * cg_pad_real(m);
  const int bar_id = 1 + gib;
  for (int b = blockIdx.x * groups + gib; b < B; b += stride) {  // b is uniform in the group
    cg_k3_fetch(M, A, b, m, gtid, gsize);
    cg_k3_commit();
    cg_k3_wait<0>();
    cg_k3_sync(bar_id, gsize);  // every thread's copies and zeros have landed
    const float v = cg_k3_eliminate<S>(M, U, V, m, gtid, gsize, bar_id);
    if (gtid == 0) out[b] = v;
    cg_k3_sync(bar_id, gsize);  // M, U and V are read to the end before they are refilled
  }
}

#ifndef CG_CPU_SHIM
extern "C" {

// Shared bytes of a block of `groups` groups.
int cg_chol_logdet_smem(int m, int groups) {
  return (int)sizeof(float) * groups * cg_k3_group_floats(m);
}

}  // extern "C"

// The instantiation for m and `warps`: S = cg_k3_slots(m, warps) slots a lane.
static const void* cg_k3_kernel(int m, int warps) {
  switch (cg_k3_slots(m, warps)) {
    case 1: return (const void*)cg_chol_logdet_kernel<1>;
    case 2: return (const void*)cg_chol_logdet_kernel<2>;
    case 3: return (const void*)cg_chol_logdet_kernel<3>;
    case 4: return (const void*)cg_chol_logdet_kernel<4>;
    case 5: return (const void*)cg_chol_logdet_kernel<5>;
    case 6: return (const void*)cg_chol_logdet_kernel<6>;
    case 7: return (const void*)cg_chol_logdet_kernel<7>;
    default: return (const void*)cg_chol_logdet_kernel<8>;
  }
}

static int cg_k3_plan_ok(int m, int warps, int groups, int smem) {
  const int threads = 32 * warps * groups;
  return m >= 0 && m <= CG_K3_MAXM && warps >= 1 && groups >= 1 && threads <= CG_K3_BLOCK &&
         (warps == 1 || groups <= 15) && smem == cg_chol_logdet_smem(m, groups) &&
         smem <= CG_K3_SMEM_LIMIT;
}

// Opt the instantiation in to `smem` bytes of dynamic shared memory.
static int cg_k3_attr(const void* kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

extern "C" {

// A (B, m, m) contiguous f32, out (B,) f32, with the launch plan of
// ops/cuda_logdet.py:k3_plan.  Returns cudaErrorInvalidValue for a plan the
// kernel cannot run (nothing is launched), else cudaGetLastError().
int cg_chol_logdet(const float* A, float* out, int B, int m, int warps, int groups, int smem,
                   int grid, void* stream) {
  if (!cg_k3_plan_ok(m, warps, groups, smem) || grid < 1) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const void* kernel = cg_k3_kernel(m, warps);
  const int e = cg_k3_attr(kernel, smem);
  if (e) return e;
  void* args[] = {(void*)&A, (void*)&out, (void*)&B, (void*)&m, (void*)&warps};
  const cudaError_t le = cudaLaunchKernel(kernel, dim3(grid), dim3(32 * warps * groups), args,
                                          (size_t)smem, (cudaStream_t)stream);
  return le != cudaSuccess ? (int)le : (int)cudaGetLastError();
}

// Blocks of this plan resident on one SM, as the runtime computes it from
// the instantiation's registers and the shared bytes; -1 for a plan the
// kernel cannot run.
int cg_chol_logdet_occupancy(int m, int warps, int groups) {
  const int smem = cg_chol_logdet_smem(m, groups);
  if (!cg_k3_plan_ok(m, warps, groups, smem)) return -1;
  const void* kernel = cg_k3_kernel(m, warps);
  if (cg_k3_attr(kernel, smem)) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, 32 * warps * groups, smem))
    return -1;
  return blocks;
}

}  // extern "C"
#endif
