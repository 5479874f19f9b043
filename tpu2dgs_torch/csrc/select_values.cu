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
// Bit-exactness: values are copied, never computed. The hit test lives in
// hit_test.cuh, shared with the count-only kernel (select_counts.cu): it is
// compiled with --fmad=false and IEEE division, in the plain version's
// operation order, so it decides each candidate exactly as the plain
// PyTorch version does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hit_test.cuh"

namespace {

constexpr int kThreads = 1024;          // candidates per step
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChan = 32;

struct Params {
  HitTest test;
  int n_chan;
  int m;           // candidates per parent, a multiple of kMacro
  int cap;
  float pads[kMaxChan];
};

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
  const Rect rc = {rx0p[row], rx1p[row], ry0p[row], ry1p[row]};
  const size_t m = (size_t)p.m;
  const float* base = chan + (size_t)parent[row] * p.n_chan * m;
  float* orow = out + (size_t)row * p.n_chan * p.cap;

  const int walk = walked_candidates(pcnt[row], p.m);

  int cursor = 0;
  for (int j0 = 0; j0 < walk; j0 += kThreads) {
    const int j = j0 + tid;
    const bool hit = candidate_hits(base, m, j, p.test, rc);

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
  p.test = make_hit_test(box_idx, exact_idx);
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
