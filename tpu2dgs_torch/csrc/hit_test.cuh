// The per-candidate hit test of the select kernels: AABB overlap and/or the
// exact conic-union-circle coverage of a splat against an inclusive pixel
// rectangle. One copy, included by select_values.cu (which carries the hits'
// channels) and select_counts.cu (which only counts them), so both decide
// every candidate with the same instructions (`hits4`, four consecutive
// candidates a thread): their counts are bit-equal.
// blend_common.cuh runs `exact_coverage` on the blend kernels' pixel blocks.
//
// Compiled with --fmad=false and IEEE division, in the operation order of
// the plain PyTorch version (raster/select_kernel.py:_exact_coverage).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

constexpr int kMacro = 1024;  // candidates walk in whole blocks of 8 x 128
constexpr int kPer = 4;       // consecutive candidates a thread tests: one float4

struct HitTest {
  int box[4];      // channels x0, x1, y0, y1 (use_box)
  int exact[13];   // channels r0..r8, fcx, fcy, te2, fr2 (use_exact)
  int use_box;
  int use_exact;
};

struct Rect {
  float x0, x1, y0, y1;
};

// Host side: fill a HitTest from the launcher's index arrays (either may be
// null to skip that test).
static inline HitTest make_hit_test(const int* box_idx, const int* exact_idx) {
  HitTest t = {};
  t.use_box = box_idx != nullptr;
  t.use_exact = exact_idx != nullptr;
  for (int i = 0; i < 4; ++i) t.box[i] = box_idx ? box_idx[i] : 0;
  for (int i = 0; i < 13; ++i) t.exact[i] = exact_idx ? exact_idx[i] : 0;
  return t;
}

// jnp.minimum / jnp.maximum semantics: NaN propagates (a NaN in, the
// canonical NaN out), one instruction each (sm_80's min.NaN / max.NaN). Of
// two zeros either may come out: no test below tells +0 from -0, because a
// clamped value only enters sums that are then squared.
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return min_nan(max_nan(x, lo), hi);
}

struct Conic {
  float r[9];
  float te2;
  __device__ __forceinline__ float q(float x, float y) const {
    const float pu = r[0] * x + r[3] * y + r[6];
    const float pv = r[1] * x + r[4] * y + r[7];
    const float pw = r[2] * x + r[5] * y + r[8];
    return pu * pu + pv * pv - te2 * (pw * pw);
  }
};

// tpu2dgs/raster/select_kernel.py:_exact_coverage, operation for operation.
__device__ inline bool exact_coverage(const float* v, float rx0, float rx1, float ry0,
                                      float ry1) {
  Conic k;
#pragma unroll
  for (int i = 0; i < 9; ++i) k.r[i] = v[i];
  const float fcx = v[9], fcy = v[10], te2 = v[11], fr2 = v[12];
  k.te2 = te2;
  const float* r = k.r;

  const float ccx = clip(fcx, rx0, rx1);
  const float ccy = clip(fcy, ry0, ry1);
  const float dx = fcx - ccx;
  const float dy = fcy - ccy;
  const bool circ = dx * dx + dy * dy <= fr2;

  const float a = r[0] * r[0] + r[1] * r[1] - te2 * (r[2] * r[2]);
  const float b = 2.0f * (r[0] * r[3] + r[1] * r[4] - te2 * (r[2] * r[5]));
  const float c = r[3] * r[3] + r[4] * r[4] - te2 * (r[5] * r[5]);
  const float d = 2.0f * (r[0] * r[6] + r[1] * r[7] - te2 * (r[2] * r[8]));
  const float e = 2.0f * (r[3] * r[6] + r[4] * r[7] - te2 * (r[5] * r[8]));

  const float inv2c = 0.5f / (c > 0.0f ? c : 1.0f);
  const float inv2a = 0.5f / (a > 0.0f ? a : 1.0f);
  const float y_a = clip(-(b * rx0 + e) * inv2c, ry0, ry1);
  const float y_b = clip(-(b * rx1 + e) * inv2c, ry0, ry1);
  const float x_c = clip(-(b * ry0 + d) * inv2a, rx0, rx1);
  const float x_d = clip(-(b * ry1 + d) * inv2a, rx0, rx1);
  float best = min_nan(min_nan(k.q(rx0, y_a), k.q(rx1, y_b)),
                       min_nan(k.q(x_c, ry0), k.q(x_d, ry1)));
  const float det = 4.0f * a * c - b * b;
  const float invdet = 1.0f / (det > 0.0f ? det : 1.0f);
  const float xs = (b * e - 2.0f * c * d) * invdet;
  const float ys = (b * d - 2.0f * a * e) * invdet;
  const bool interior = (xs >= rx0) & (xs <= rx1) & (ys >= ry0) & (ys <= ry1);
  if (interior) best = min_nan(best, k.q(xs, ys));
  const bool not_ell = (a <= 0.0f) | (c <= 0.0f) | (det <= 0.0f);
  return (best <= 0.0f) | not_ell | circ;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float part(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Bits 0-3: do candidates j..j+3 of the channel-major list `base` (channel c
// at base[c * m + j], j a multiple of 4, base 16-byte aligned) hit the
// rectangle? One float4 load per tested channel; reads only the 4 and/or 13
// tested channels.
__device__ __forceinline__ unsigned hits4(const float* __restrict__ base, size_t m, int j,
                                          const HitTest& t, const Rect& rc) {
  unsigned bits = 0xFu;
  if (t.use_box) {
    const float4 x0 = load4(base + t.box[0] * m + j);
    const float4 x1 = load4(base + t.box[1] * m + j);
    const float4 y0 = load4(base + t.box[2] * m + j);
    const float4 y1 = load4(base + t.box[3] * m + j);
    bits = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const bool hit = (part(x0, k) <= rc.x1) & (part(x1, k) >= rc.x0) &
                       (part(y0, k) <= rc.y1) & (part(y1, k) >= rc.y0);
      bits |= (unsigned)hit << k;
    }
  }
  if (t.use_exact) {
    float4 v4[13];
#pragma unroll
    for (int i = 0; i < 13; ++i) v4[i] = load4(base + t.exact[i] * m + j);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      float v[13];
#pragma unroll
      for (int i = 0; i < 13; ++i) v[i] = part(v4[i], k);
      if (!exact_coverage(v, rc.x0, rc.x1, rc.y0, rc.y1)) bits &= ~(1u << k);
    }
  }
  return bits;
}

// The candidates a row walks: whole macro blocks up to its parent's live
// count, as the TPU kernels (hits past the count inside the last block
// still count).
__device__ __forceinline__ int walked_candidates(int parent_count, int m) {
  const int live = max(0, min(parent_count, m));
  return (live + kMacro - 1) / kMacro * kMacro;
}
