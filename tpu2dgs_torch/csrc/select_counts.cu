// Count-only select kernel: per-row TOTAL hits, nothing carried.
//
// Replaces tpu2dgs/raster/select_kernel.py:_count_kernel (the TPU kernel
// behind select_counts). For each output row (an inclusive pixel rectangle)
// it tests every walked candidate of the row's parent list with the select
// kernel's own hit test (hit_test.cuh: AABB overlap and/or exact splat
// coverage) and returns how many hit. The walk is select_values': whole
// 1024-candidate macro blocks up to min(parent_count, m), so the counts are
// bit-equal to the counts select_values returns for the same arguments.
//
// What bounds it on an H100: the operations of the exact test (about 200
// per candidate on 52 bytes) when many rows share one parent list, which
// then stays in L2; the bytes of the tested channels otherwise. Design: a
// count has no order to keep, so there is no rank scan. A row is split
// over gridDim.y blocks of 256 threads that stride over its candidates;
// a warp counts its hits with __ballot_sync/__popc, the block sums its
// warps through shared memory and adds its part to the row's count with
// one integer atomicAdd (integer sums do not depend on their order, so
// the result is the same from run to run). The launcher zeroes the counts
// on the same stream first.
// Only the 4 or 13 tested channels are read.

#include <cuda_runtime.h>

#include "hit_test.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
select_counts_kernel(const float* __restrict__ chan, const int* __restrict__ parent,
                     const int* __restrict__ pcnt, const float* __restrict__ rx0p,
                     const float* __restrict__ rx1p, const float* __restrict__ ry0p,
                     const float* __restrict__ ry1p, int* __restrict__ counts,
                     int n_chan, int m_int, const HitTest test) {
  __shared__ int warp_hits[kWarps];

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int walk = walked_candidates(pcnt[row], m_int);
  const int first = blockIdx.y * kThreads;
  if (first >= walk) return;  // the whole block: nothing of this row is left for it

  const Rect rc = {rx0p[row], rx1p[row], ry0p[row], ry1p[row]};
  const size_t m = (size_t)m_int;
  const float* base = chan + (size_t)parent[row] * n_chan * m;

  // walk, first and the stride are multiples of 32: the lanes of a warp
  // leave the loop together, so every ballot sees the full warp.
  int hits = 0;
  for (int j = first + tid; j < walk; j += gridDim.y * kThreads) {
    const bool hit = candidate_hits(base, m, j, test, rc);
    hits += __popc(__ballot_sync(0xffffffffu, hit));
  }
  if ((tid & 31) == 0) warp_hits[tid >> 5] = hits;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_hits[w];
    if (total) atomicAdd(&counts[row], total);
  }
}

}  // namespace

// chan (n_parents, n_chan, m) f32; parent, pcnt (rows,) i32; rx0..ry1 (rows,)
// f32; counts (rows,) i32, zeroed here before the kernel adds into it.
// box_idx (4 ints) or exact_idx (13 ints) may be null to skip that test;
// both are host memory.
// `splits` blocks share a row (at least 1).
extern "C" int select_counts_launch(const float* chan, const int* parent, const int* pcnt,
                                    const float* rx0, const float* rx1, const float* ry0,
                                    const float* ry1, int* counts, int rows, int n_chan,
                                    int m, int splits, const int* box_idx,
                                    const int* exact_idx, int device, void* stream) {
  if (m % kMacro != 0 || splits < 1 || splits > 65535 || (!box_idx && !exact_idx))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows > 0) {
    err = cudaMemsetAsync(counts, 0, sizeof(int) * (size_t)rows, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    select_counts_kernel<<<dim3(rows, splits), kThreads, 0, (cudaStream_t)stream>>>(
        chan, parent, pcnt, rx0, rx1, ry0, ry1, counts, n_chan, m,
        make_hit_test(box_idx, exact_idx));
  }
  return (int)cudaGetLastError();
}
