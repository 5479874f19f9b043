// Select kernel: per-row stream compaction of candidate channels.
//
// Replaces tpu2dgs/raster/select_kernel.py:_select_values_kernel (the TPU
// kernel behind select_values). For each output row (an inclusive pixel
// rectangle) the kernel walks its parent's candidate list in order, tests
// every candidate for AABB overlap (box channels) and/or the exact
// conic-union-circle coverage of the splat (13 record channels), and writes
// the first `cap` hits, every carried channel, in candidate order. Slots
// past the count hold pad_vals; the count returned is the TOTAL number of
// hits, which may exceed cap.
//
// What bounds it on an H100: device memory. Every candidate's tested
// channels are read once and every output slot written once; the coverage
// test is about 200 operations on 52 bytes per candidate, below the ~20
// f32 operations per byte at which the card's compute becomes the limit.
// Design: one 1024-thread block per row, one candidate per thread per step
// (coalesced channel-major reads); __ballot_sync/__popc rank hits inside a
// warp and a shared-memory scan across the 32 warps ranks them in the
// block, so the row's running cursor advances in candidate order and a
// hit's channels are copied straight to out[row, c, cursor + rank]. The
// walk covers the same whole 1024-candidate macro blocks as the TPU kernel
// (counts include hits past parent_counts inside the last macro block).
// Known weakness: the first binning level has few rows (7 screen columns
// at 800 px), so only a few of the 132 SMs work on it.
//
// Bit-exactness: values are copied, never computed. The coverage test is
// compiled with --fmad=false and IEEE division, in the plain version's
// operation order, so it decides each candidate exactly as the plain
// PyTorch version does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;          // candidates per step
constexpr int kWarps = kThreads / 32;
constexpr int kMacro = 1024;            // TPU macro block: 8 x 128 candidates
constexpr int kMaxChan = 32;

struct Params {
  int box[4];      // channels x0, x1, y0, y1 (use_box)
  int exact[13];   // channels r0..r8, fcx, fcy, te2, fr2 (use_exact)
  int use_box;
  int use_exact;
  int n_chan;
  int m;           // candidates per parent, a multiple of kMacro
  int cap;
  float pads[kMaxChan];
};

// jnp.minimum / jnp.maximum semantics: NaN propagates.
__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : (a < b ? a : b);
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : (a > b ? a : b);
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
__device__ bool exact_coverage(const float* v, float rx0, float rx1, float ry0,
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

__global__ void __launch_bounds__(kThreads)
select_values_kernel(const float* __restrict__ chan, const int* __restrict__ parent,
                     const int* __restrict__ pcnt, const float* __restrict__ rx0p,
                     const float* __restrict__ rx1p, const float* __restrict__ ry0p,
                     const float* __restrict__ ry1p, float* __restrict__ out,
                     int* __restrict__ counts, const Params p) {
  __shared__ int warp_hits[kWarps];
  __shared__ int warp_base[kWarps];
  __shared__ int step_hits;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float rx0 = rx0p[row], rx1 = rx1p[row], ry0 = ry0p[row], ry1 = ry1p[row];
  const size_t m = (size_t)p.m;
  const float* base = chan + (size_t)parent[row] * p.n_chan * m;
  float* orow = out + (size_t)row * p.n_chan * p.cap;

  // Whole macro blocks up to the parent's live count, as the TPU kernel.
  const int live = max(0, min(pcnt[row], p.m));
  const int walk = (live + kMacro - 1) / kMacro * kMacro;

  int cursor = 0;
  for (int j0 = 0; j0 < walk; j0 += kThreads) {
    const int j = j0 + tid;
    bool hit = true;
    if (p.use_box) {
      const float x0 = base[p.box[0] * m + j];
      const float x1 = base[p.box[1] * m + j];
      const float y0 = base[p.box[2] * m + j];
      const float y1 = base[p.box[3] * m + j];
      hit = (x0 <= rx1) & (x1 >= rx0) & (y0 <= ry1) & (y1 >= ry0);
    }
    if (p.use_exact) {
      float v[13];
#pragma unroll
      for (int i = 0; i < 13; ++i) v[i] = base[p.exact[i] * m + j];
      hit = hit & exact_coverage(v, rx0, rx1, ry0, ry1);
    }

    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {
      const int own = warp_hits[lane];
      int incl = own;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      warp_base[lane] = incl - own;
      if (lane == 31) step_hits = incl;
    }
    __syncthreads();
    if (hit) {
      const int rank = cursor + warp_base[warp] + __popc(ballot & ((1u << lane) - 1u));
      if (rank < p.cap) {
        for (int c = 0; c < p.n_chan; ++c) orow[(size_t)c * p.cap + rank] = base[c * m + j];
      }
    }
    cursor += step_hits;
    __syncthreads();  // warp_hits / warp_base / step_hits are reused
  }

  const int filled = min(cursor, p.cap);
  for (int c = 0; c < p.n_chan; ++c) {
    const float pad = p.pads[c];
    for (int k = filled + tid; k < p.cap; k += kThreads) orow[(size_t)c * p.cap + k] = pad;
  }
  if (tid == 0) counts[row] = cursor;
}

}  // namespace

// chan (n_parents, n_chan, m) f32; parent, pcnt (rows,) i32; rx0..ry1 (rows,)
// f32; out (rows, n_chan, cap) f32; counts (rows,) i32. box_idx (4 ints) or
// exact_idx (13 ints) may be null to skip that test; pad_vals holds n_chan
// floats. Index arrays and pad values are host memory.
extern "C" int select_values_launch(const float* chan, const int* parent, const int* pcnt,
                                    const float* rx0, const float* rx1, const float* ry0,
                                    const float* ry1, float* out, int* counts, int rows,
                                    int n_chan, int m, int cap,
                                    const int* box_idx, const int* exact_idx,
                                    const float* pad_vals, int device, void* stream) {
  if (n_chan > kMaxChan || m % kMacro != 0 || (!box_idx && !exact_idx))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params p = {};
  p.use_box = box_idx != nullptr;
  p.use_exact = exact_idx != nullptr;
  for (int i = 0; i < 4; ++i) p.box[i] = box_idx ? box_idx[i] : 0;
  for (int i = 0; i < 13; ++i) p.exact[i] = exact_idx ? exact_idx[i] : 0;
  p.n_chan = n_chan;
  p.m = m;
  p.cap = cap;
  for (int c = 0; c < n_chan; ++c) p.pads[c] = pad_vals[c];
  if (rows > 0) {
    select_values_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
        chan, parent, pcnt, rx0, rx1, ry0, ry1, out, counts, p);
  }
  return (int)cudaGetLastError();
}
