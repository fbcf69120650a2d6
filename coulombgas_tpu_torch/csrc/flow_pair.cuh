// Device helpers shared by the warp-per-row flow kernels, K5 and K6
// (flow_d2.cu) and K4 (flow_large.cu): the pair features of the periodic
// FermiNet flow made in registers from one sincos a coordinate, and the
// fixed-order shuffle trees that sum a warp's values over its lanes.  Every
// sum here has one order, whatever the batch: a walker's result depends on
// its own inputs only.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

__host__ __device__ constexpr int cg_fp_pow2(int v) { return v <= 1 ? 1 : 2 * cg_fp_pow2((v + 1) / 2); }

// A row stride (in floats) of whole 16-byte groups, an odd number of them:
// lanes reading 16 bytes each from rows k then hit distinct bank groups.
__host__ __device__ inline int cg_fp_stride4(int v) {
  v = (v + 3) & ~3;
  return (v / 4) % 2 ? v : v + 4;
}

// sin and cos of |t| <= pi/2: Taylor series to t^13 and t^14 (remainders
// below 7e-10), relative accuracy kept for small t.
__device__ inline void cg_fp_sincos(float t, float* s, float* c) {
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
// A0[i][i] = 0 (r_ii is identically 0).  HD: also hd = sum_a d^2 d / d r_a^2,
// 0 at i == j, with 1 / d taken as 1 where d = 0 (coincident particles), as
// the plain versions do.
template <int DIM, bool HD = false>
__device__ inline void cg_fp_pair(const float* xs, int i, int j, float L, float invL,
                                   float k1, float k2, float (&e)[2 * DIM + 1],
                                   float (&al)[DIM], float (&be)[DIM], float (&ga)[DIM],
                                   float* hd = nullptr) {
  float s1[DIM], c1[DIM], d2 = 0.f;
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    float r = xs[i * DIM + d] - xs[j * DIM + d];
    r = fmaf(-L, rintf(r * invL), r);
    cg_fp_sincos(k1 * r, &s1[d], &c1[d]);
    d2 = fmaf(s1[d], s1[d], d2);
  }
  const float inv = d2 > 0.f ? rsqrtf(d2) : 0.f;
  const float self = (i == j) ? 0.f : 1.f;
  float hc = 0.f, hs = 0.f;
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    const float c2 = fmaf(-2.f * s1[d], s1[d], 1.f), s2 = 2.f * s1[d] * c1[d];
    e[d] = c2;
    e[DIM + d] = s2;
    al[d] = -k2 * s2;  // s2 = 0 at i == j
    be[d] = self * k2 * c2;
    ga[d] = k1 * s1[d] * c1[d] * inv;
    if (HD) {
      const float sc = s1[d] * c1[d];
      hc += c2;
      hs = fmaf(sc, sc, hs);
    }
  }
  e[2 * DIM] = d2 * inv;
  if (HD) {
    const float is = d2 > 0.f ? inv : 1.f;
    *hd = self * k1 * k1 * is * (hc - hs * is * is);
  }
}

// The warp's sum of V values a lane (V a power of two <= 32): halving rounds
// at lane offsets 16, 8, ... (the lane with the offset's bit keeps its upper
// half and adds the partner's upper half, the other the lower halves), then
// butterfly rounds over the remaining offsets.  Lane L returns the sum of
// value L >> (5 - log2 V).  Destroys v.  Written as a recursion over
// compile-time halves so that every index of v is a constant (v stays in
// registers).
template <int V, int H>
__device__ __forceinline__ void cg_fp_halve(float (&v)[V], int lane) {
  if constexpr (H >= 1) {
    constexpr int o = 32 * H / V;  // 16 for the first round
    const bool hi = (lane & o) != 0;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const float keep = hi ? v[j + H] : v[j];
      const float send = hi ? v[j] : v[j + H];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
    cg_fp_halve<V, H / 2>(v, lane);
  }
}

template <int O>
__device__ __forceinline__ float cg_fp_butterfly(float s) {
  if constexpr (O >= 1) return cg_fp_butterfly<O / 2>(s + __shfl_xor_sync(0xffffffffu, s, O));
  return s;
}

template <int V>
__device__ __forceinline__ float cg_fp_tree(float (&v)[V], int lane) {
  cg_fp_halve<V, V / 2>(v, lane);
  return cg_fp_butterfly<16 / V>(v[0]);
}

// cg_fp_tree with the sum of value v written to out[v] (out: a warp's row
// sums; the caller orders the reads with __syncwarp).
template <int V>
__device__ __forceinline__ void cg_fp_tree_to(float (&v)[V], int lane, float* out) {
  const float sum = cg_fp_tree<V>(v, lane);
  if ((lane & (32 / V - 1)) == 0) out[lane / (32 / V)] = sum;
}

__device__ __forceinline__ float cg_fp_allsum(float s) { return cg_fp_butterfly<16>(s); }
