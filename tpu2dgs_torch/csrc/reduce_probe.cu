// Reduction probe: two ways to sum (16,128) planes over their 16 rows.
//
// Replaces scripts/reduce_probe.py:kernel_vpu (reduce_probe_shuffle) and
// scripts/reduce_probe.py:kernel_mxu (reduce_probe_mma). Both compute
//
//   acc[x] = sum over s < steps, k < 16 of (k + 1) * sum over y < 16 of
//            (base[y, x] * f + f),   f = float(s * 16 + k + 1),
//
// the backward blend kernel's per-record reduction in miniature: a fresh
// (16,128) plane per (s, k), built in registers from s and k so nothing can
// be hoisted out of the loop, summed over its rows and consumed. Each runs
// as ONE block, as the TPU probe's grid is (1,): the question is what one
// SM does with the reduction, not how the card fills up.
//
// What bounds them on an H100: operations (8 KB in, 512 B out).
//
//  * reduce_probe_shuffle, the SIMT way. 512 threads; a warp owns 8
//    columns, a lane 4 rows of one column (lane = 8 * row_group + column),
//    so a plane's column sum is 3 adds in the thread and 2 __shfl_xor_sync
//    steps across the 4 row groups.
//  * reduce_probe_mma, the tensor-core way, with the TPU kernel's
//    arithmetic: the 16 planes of a step go into a (256,128) slab in shared
//    memory, each value split three ways by masking its top 16 bits (hi,
//    mid, lo: 8 mantissa bits each, so each part is exact in bfloat16), and
//    a {0,1} selector (16,256) times each part on the tensor cores
//    (nvcuda::wmma 16x16x16, bfloat16 in, float32 accumulate) sums every
//    plane's rows at once; the three products are added and the weights
//    1..16 applied. 256 threads: warp w owns output columns 16w..16w+15.
//    The slab is kept as three bfloat16 slabs (204 KB of dynamic shared
//    memory with the row padding): the float32 slab of the TPU kernel
//    would be written and read once more for nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int BY = 16;
constexpr int BX = 128;
constexpr int NPLANES = 16;

__device__ __forceinline__ float plane_value(float base, float f) {
  return base * f + f;
}

// ---------------------------------------------------------------- shuffle

constexpr int kShuffleThreads = 512;

__global__ void __launch_bounds__(kShuffleThreads)
reduce_probe_shuffle_kernel(const float* __restrict__ base, float* __restrict__ acc_out,
                            int steps) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int x = (tid >> 5) * 8 + (lane & 7);
  const int y0 = (lane >> 3) * 4;
  float b[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) b[i] = base[(y0 + i) * BX + x];

  float acc = 0.0f;
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int k = 0; k < NPLANES; ++k) {
      const float f = (float)(s * NPLANES + k + 1);
      float row = (plane_value(b[0], f) + plane_value(b[1], f))
                  + (plane_value(b[2], f) + plane_value(b[3], f));
      row += __shfl_xor_sync(0xffffffffu, row, 8);
      row += __shfl_xor_sync(0xffffffffu, row, 16);
      acc += row * (float)(k + 1);
    }
  }
  if (lane < 8) acc_out[x] = acc;
}

// -------------------------------------------------------------------- mma

constexpr int kMmaThreads = 256;
constexpr int kSlabRows = NPLANES * BY;               // 256: the product's depth
// Row strides in shared memory, in elements. A wmma fragment load reads 16
// rows at once: with strides of 256 and 512 bytes every row would start on
// the same bank, so each row is padded by 16 bytes.
constexpr int kSlabLd = BX + 8;                       // 272 bytes
constexpr int kSelLd = kSlabRows + 8;                 // 528 bytes
constexpr int kSlabElems = kSlabRows * kSlabLd;       // one bfloat16 slab
constexpr size_t kMmaShared =
    3 * kSlabElems * sizeof(__nv_bfloat16)            // hi, mid, lo slabs
    + NPLANES * kSelLd * sizeof(__nv_bfloat16)        // the selector
    + NPLANES * BX * sizeof(float);                   // the (16,128) product

__device__ __forceinline__ float top16(float v) {
  return __uint_as_float(__float_as_uint(v) & 0xFFFF0000u);
}

__global__ void __launch_bounds__(kMmaThreads)
reduce_probe_mma_kernel(const float* __restrict__ base, float* __restrict__ acc_out,
                        int steps) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* slab = reinterpret_cast<__nv_bfloat16*>(smem);   // [3][256][kSlabLd]
  __nv_bfloat16* sel = slab + 3 * kSlabElems;                     // [16][kSelLd]
  float* prod = reinterpret_cast<float*>(sel + NPLANES * kSelLd);  // [16][128]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int x = tid & (BX - 1);
  const int y0 = (tid >> 7) * 8;  // two threads per column, 8 rows each
  float b[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) b[i] = base[(y0 + i) * BX + x];

  // selector: row r sums slab rows 16r .. 16r+15 (plane r's 16 rows)
  for (int i = tid; i < NPLANES * kSlabRows; i += kMmaThreads) {
    const int r = i / kSlabRows, c = i % kSlabRows;
    sel[r * kSelLd + c] = __float2bfloat16(c / BY == r ? 1.0f : 0.0f);
  }

  float acc = 0.0f;
  for (int s = 0; s < steps; ++s) {
    // plane store: value -> hi + mid + lo, each exact in bfloat16
#pragma unroll
    for (int k = 0; k < NPLANES; ++k) {
      const float f = (float)(s * NPLANES + k + 1);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p = plane_value(b[i], f);
        const float hi = top16(p);
        const float rem = p - hi;
        const float mid = top16(rem);
        const float lo = rem - mid;
        const int at = (k * BY + y0 + i) * kSlabLd + x;
        slab[at] = __float2bfloat16(hi);
        slab[kSlabElems + at] = __float2bfloat16(mid);
        slab[2 * kSlabElems + at] = __float2bfloat16(lo);
      }
    }
    __syncthreads();

    // (16,256) selector x (256,128) part, three parts, columns 16w..16w+15
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[3];
#pragma unroll
    for (int part = 0; part < 3; ++part) {
      wmma::fill_fragment(c[part], 0.0f);
      for (int kk = 0; kk < kSlabRows / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bm;
        wmma::load_matrix_sync(a, sel + kk * 16, kSelLd);
        wmma::load_matrix_sync(
            bm, slab + part * kSlabElems + kk * 16 * kSlabLd + warp * 16, kSlabLd);
        wmma::mma_sync(c[part], a, bm, c[part]);
      }
    }
#pragma unroll
    for (int i = 0; i < c[0].num_elements; ++i) c[0].x[i] = (c[0].x[i] + c[1].x[i]) + c[2].x[i];
    wmma::store_matrix_sync(prod + warp * 16, c[0], BX, wmma::mem_row_major);
    __syncthreads();

    if (tid < BX) {
      float row = 0.0f;
#pragma unroll
      for (int k = 0; k < NPLANES; ++k) row += prod[k * BX + tid] * (float)(k + 1);
      acc += row;
    }
    // The next step's plane stores touch only the slabs, which every warp
    // has finished reading; prod is rewritten only after the next barrier.
  }
  if (tid < BX) acc_out[tid] = acc;
}

}  // namespace

// base (16,128) f32 and acc (128,) f32 on the device.
extern "C" int reduce_probe_shuffle_launch(const float* base, float* acc, int steps,
                                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  reduce_probe_shuffle_kernel<<<1, kShuffleThreads, 0, (cudaStream_t)stream>>>(base, acc,
                                                                              steps);
  return (int)cudaGetLastError();
}

extern "C" int reduce_probe_mma_launch(const float* base, float* acc, int steps, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(reduce_probe_mma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMmaShared);
  if (err != cudaSuccess) return (int)err;
  reduce_probe_mma_kernel<<<1, kMmaThreads, kMmaShared, (cudaStream_t)stream>>>(base, acc,
                                                                              steps);
  return (int)cudaGetLastError();
}
