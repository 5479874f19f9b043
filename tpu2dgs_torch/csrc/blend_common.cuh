// What the forward and backward blend kernels share: the per-pixel splat
// response and hit test, the cull of a staged record chunk, and the
// asynchronous staging of that chunk. One copy, included by
// blend_forward.cu and blend_backward.cu, so both decide every (record,
// pixel) pair with the same instructions.
//
// Compiled with --fmad=false and IEEE division, in the operation order of
// the plain PyTorch version (raster/cuda_backend.py:_splat_response).
//
// A 16 x 128-pixel tile (column-major, t = tix * nty + tiy) is cut into 8
// sub-tiles of 16 x 16 pixels, one CTA each; sub-tile r covers columns
// [16 r, 16 r + 15] of the tile, and each of its 4 warps a block of 16 x 4
// pixels. Records are staged kChunk at a time, channel-major, every channel
// of kStage. The cull runs `exact_coverage` (hit_test.cuh, the test
// binning's L3 runs on whole tiles) on the warp's inclusive rectangle: the
// conic and low-pass circle it tests are inflated by a margin (te2 and fr2,
// raster/preprocess.py), so it keeps every pair the per-pixel hit test
// below can pass, and a pair it clears would have blended nothing: w = 0.
// The union of a sub-tile's 4 warp masks is the sub-tile's mask
// (cuda_backend.subtile_coverage is the plain version of both). A warp
// walks only its own block's entries: the finer cull costs each warp 2 tests
// per chunk and saves it the responses of the entries that reach only the
// sub-tile's other blocks.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hit_test.cuh"

namespace blend {

constexpr int kBY = 16;
constexpr int kBX = 128;
constexpr int kPlane = kBY * kBX;
constexpr int kSubW = 16;               // sub-tile width; its height is kBY
constexpr int kSubs = kBX / kSubW;      // 8 sub-tiles per tile
constexpr int kSubPix = kBY * kSubW;    // 256 pixels per sub-tile
constexpr int kThreads = 128;           // one CTA per sub-tile
constexpr int kWarps = kThreads / 32;
constexpr int kPix = kSubPix / kThreads;  // 2 pixels per thread: one column, 2 rows
constexpr int kChunk = 64;              // records staged per step
constexpr int kStage = 24;              // record channels staged: all of them
constexpr int kOutCh = 16;

// float32 roundings of tpu2dgs_torch/raster/common.py
constexpr float kAlphaClamp = 0.9900000095367432f;
constexpr float kOneMinusClamp = 0.009999999776482582f;  // 1 - ALPHA_CLAMP
constexpr float kAlphaMin = 0.003921568859368563f;       // 1/255
constexpr float kCutoff2 = 9.0f;
constexpr float kFilterInvSquare = 2.0f;
constexpr float kIntersectNear = 0.20000000298023224f;
constexpr float kTEps = 9.999999747378752e-05f;
constexpr float kMedianT = 0.5f;
constexpr float kDistNear = 0.20000000298023224f;
constexpr float kDistFar = 100.0f;
constexpr float kDistSpan = 99.80000305175781f;  // DIST_FAR - DIST_NEAR
constexpr float kDmDd = 0.20040079951286316f;    // DIST_FAR * DIST_NEAR / span

// One staged chunk: channel c of entry k at rec[c][k].
struct Chunk {
  float rec[kStage][kChunk];
};

// The thread's pixels inside its sub-tile: column lx, rows ly0 and ly0 + 1.
// A warp covers a compact 16 x 4 block.
__device__ __forceinline__ int pixel_col(int tid) { return tid % kSubW; }
__device__ __forceinline__ int pixel_row0(int tid) { return (tid / kSubW) * kPix; }

// The record channels the response reads.
struct Geom {
  float r[9];           // c1, c2, c3: the linearized homography
  float a0, a1, a2;     // channels 9:12, the intersection depth
  float op, fcx, fcy;   // channels 18, 19, 20
};

__device__ __forceinline__ Geom load_geom(const Chunk& s, int k) {
  Geom g;
#pragma unroll
  for (int i = 0; i < 9; ++i) g.r[i] = s.rec[i][k];
  g.a0 = s.rec[9][k];
  g.a1 = s.rec[10][k];
  g.a2 = s.rec[11][k];
  g.op = s.rec[18][k];
  g.fcx = s.rec[19][k];
  g.fcy = s.rec[20][k];
  return g;
}

struct Response {
  float alpha, depthp, G, su, sv, inv;
  bool hit, not_clamped, use3d;
};

// _splat_response, operation for operation.
__device__ __forceinline__ Response splat_response(const Geom& g, float px, float py) {
  Response o;
  const float pu = px * g.r[0] + py * g.r[3] + g.r[6];
  const float pv = px * g.r[1] + py * g.r[4] + g.r[7];
  const float pw = px * g.r[2] + py * g.r[5] + g.r[8];
  const bool valid = pw != 0.0f;
  o.inv = valid ? 1.0f / pw : 0.0f;
  o.su = pu * o.inv;
  o.sv = pv * o.inv;
  const float rho3d = o.su * o.su + o.sv * o.sv;
  const float dx = px - g.fcx;
  const float dy = py - g.fcy;
  const float rho2d = kFilterInvSquare * (dx * dx + dy * dy);
  o.use3d = rho3d <= rho2d;
  const float rho = o.use3d ? rho3d : rho2d;
  const bool inside = (rho3d <= kCutoff2) | (rho2d <= rho3d);
  o.depthp = o.su * g.a0 + o.sv * g.a1 + g.a2;
  o.G = expf(-0.5f * rho);
  const float raw = g.op * o.G;
  o.not_clamped = raw < kAlphaClamp;
  o.alpha = isnan(raw) ? raw : (o.not_clamped ? raw : kAlphaClamp);
  o.hit = valid & inside & (o.depthp >= kIntersectNear) & (o.alpha >= kAlphaMin);
  return o;
}

// The distortion loss's depth map, _map_depth.
__device__ __forceinline__ float safe_depth(float d) { return isnan(d) ? d : fmaxf(d, 1e-6f); }
__device__ __forceinline__ float map_depth(float safe) {
  return kDistFar * (safe - kDistNear) / (kDistSpan * safe);
}

constexpr int kWarpRows = 32 * kPix / kSubW;  // a warp's pixel block: 16 x 4

// Does staged entry k reach the inclusive rectangle [x0, x1] x [y0, y1]?
__device__ __forceinline__ bool entry_covers(const Chunk& s, int k, float x0, float x1,
                                             float y0, float y1) {
  float v[13];
#pragma unroll
  for (int i = 0; i < 9; ++i) v[i] = s.rec[i][k];
  v[9] = s.rec[19][k];
  v[10] = s.rec[20][k];
  v[11] = s.rec[22][k];
  v[12] = s.rec[23][k];
  return exact_coverage(v, x0, x1, y0, y1);
}

// The cull of one staged chunk for the calling warp's pixel block, columns
// [x0, x0 + 15] and rows [wy0, wy0 + 3]: bit k is set when entry c0 + k is
// live (below `live`) and reaches the block. Lanes test entries lane and
// lane + 32.
__device__ __forceinline__ uint64_t cull_warp(const Chunk& s, int c0, int live, float x0,
                                              float wy0) {
  const int lane = threadIdx.x & 31;
  const float x1 = x0 + (float)(kSubW - 1), wy1 = wy0 + (float)(kWarpRows - 1);
  const bool lo = (c0 + lane < live) && entry_covers(s, lane, x0, x1, wy0, wy1);
  const bool hi = (c0 + lane + 32 < live) && entry_covers(s, lane + 32, x0, x1, wy0, wy1);
  return (uint64_t)__ballot_sync(0xffffffffu, lo) |
         ((uint64_t)__ballot_sync(0xffffffffu, hi) << 32);
}

// Asynchronous staging: every channel of entries [c0, c0 + kChunk) of the
// channel-major list `rec` (channel c at rec[c * capk + j]) into `dst`, by
// 4-byte cp.async with zero fill past `count` (which never exceeds capk).
// The caller commits the group and waits on it.
__device__ __forceinline__ void stage_chunk(Chunk& dst, const float* __restrict__ rec,
                                            int capk, int c0, int count) {
  for (int i = threadIdx.x; i < kStage * kChunk; i += blockDim.x) {
    const int ch = i / kChunk;
    const int k = i % kChunk;
    const int j = c0 + k;
    const bool live = j < count;
    const float* src = rec + (size_t)ch * capk + (live ? j : 0);
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(&dst.rec[ch][k]);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(live ? 4 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace blend
