// Reduction probe: two ways to sum (16,128) planes over their 16 rows.
//
// Replaces scripts/reduce_probe.py:kernel_vpu (reduce_probe_shuffle) and
// scripts/reduce_probe.py:kernel_mxu (reduce_probe_mma). Both compute
//
//   acc[x] = sum over s < steps, k < 16 of (k + 1) * sum over y < 16 of
//            (base[y, x] * f + f),   f = float(s * 16 + k + 1),
//
// the backward blend kernel's per-record reduction in miniature: a fresh
// (16,128) plane per (s, k), built in registers from the resident base and
// f so nothing can be hoisted out of the loop, summed over its rows and
// consumed. Each runs as ONE block, as the TPU probe's grid is (1,): the
// question is what one SM does with the reduction, not how the card fills.
//
// What bounds them on an H100: operations (8 KB in, 512 B out), and of the
// operations the instructions one SM can dispatch, 4 warp-instructions a
// clock (128 lanes), not the FLOP roofline. The roofline counts a fused
// multiply-add as two FLOPs; a dispatch slot takes one instruction whatever
// it is. Both kernels build each plane value with one explicit
// __fmaf_rn(base, f, f): the library is built with --fmad=false (the
// select kernel's bit-equality needs it), which would otherwise keep the
// multiply and the add apart. No other FMA is used; the weights are a
// multiply and an add, as in the plain version.
//
//  * reduce_probe_shuffle, the SIMT way, with the reduction the backward
//    blend kernel uses. 512 threads; a warp owns 8 columns, a lane 4 rows
//    of one column (lane = 8 * row_group + column). A step: each lane makes
//    its 64 values (16 planes x 4 rows, an FMA each) and sums each plane's
//    4 (3 adds); a transpose tree over the 4 row groups then finishes all
//    16 planes with 8 + 4 shuffles (32 if each plane took its own 2): the
//    lanes xor 16 apart swap halves of their 16 sums, those xor 8 apart
//    quarters, and each lane ends owning 4 planes' column sums, which it
//    weights, sums and adds to its accumulator, one add a step; 2 shuffles
//    after the loop join a column's 4 lanes. The plane a register slot
//    holds is a lane-dependent permutation (plane = slot ^ (8 * bit4 + 4 *
//    bit3) of the lane), chosen so that every exchange sends and keeps
//    fixed registers: no select. f is carried as floats (f0 advances by
//    16.0f a step, a plane adds its lane's offset: exact below 2^24). Per
//    lane and step about 164 instructions for 64 values, 2.6 a value,
//    against the 1.5 dispatch slots a value the FLOP bound allows (3 FLOPs a
//    value, an FMA counted as two): it cannot pass about 60% of the bound.
//  * reduce_probe_mma, the tensor-core way, with the TPU kernel's
//    arithmetic: each value p split three ways by masking its top 16 bits
//    (hi = top16(p), mid = top16(p - hi), lo = p - hi - mid: each part 8
//    significant bits, exact in bfloat16, hi + mid + lo == p), and a {0,1}
//    selector product of each part on the tensor cores, bfloat16 in,
//    float32 accumulate, through mma.sync.m16n8k16 in inline PTX. Nothing
//    is staged in shared memory: a warp keeps the 8 base values its
//    fragments need in registers for the whole run and builds the A
//    fragments from them every plane.
//    Orientation: A (16 x 16, row-major) is the plane transposed, rows m =
//    16 columns x of an x-block, k = the 16 rows y; B (16 x 8) is the
//    selector, ones in column n = the plane's slot, zeros elsewhere; so D
//    column n collects sum over y of that plane's part. In the m16n8k16
//    layout (g = lane / 4, t = lane % 4) A register r holds x = g + 8 (r & 1)
//    at rows y = 2t + 8 (r >> 1) and y + 1, low half the even row, and B's
//    two registers both hold rows 2t, 2t+1 (and +8) of column g: for slot n
//    they are 0x3F803F80 (two bfloat16 ones) in the lanes with g == n and 0
//    elsewhere, 8 constants kept in registers. The split packs a pair of
//    parts into an A register with one byte permute, __byte_perm(a, b,
//    0x7632) (top halves of a and b): no rounding conversion, since every
//    part is its own top 16 bits. Per value: FMA, 2 masks, 2 subtractions,
//    1.5 permutes, about 7 dispatch slots with the products and f; 3.5 of
//    them (the masks and permutes) go to the integer pipe, which takes 16
//    lanes a clock a sub-partition, half the dispatch rate. That pipe binds
//    (about 0.51 ms at 1.98 GHz if it never idles); the 384 m16n8k16
//    products a step (each one plane's part of one x-block: 1/8 of each
//    product is useful work) overlap it on the tensor pipe. The split is
//    what the tensor-core route pays that the shuffle route does not.
//    Warps: 16 (512 threads), warp w on x-block w % 8 and planes
//    8 (w / 8) .. 8 (w / 8) + 7, each plane in D column plane % 8. A warp
//    keeps three accumulators (hi, mid, lo; a product chain of 8 a step
//    each), reset every step; at the end of the step (hi + mid) + lo, the
//    weights, and 2 shuffles within each quad give the step's weighted sum
//    of the warp's 8 planes for 2 columns. Four warps a sub-partition hide
//    the latency of the FMA -> mask -> subtract -> permute -> mma chain.
//    No barrier inside the loop; one after it, where the two plane groups'
//    sums meet in 1 KB of static shared memory.
//
// Both kernels are deterministic (fixed reduction orders, no atomics), so
// two launches give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BX = 128;
constexpr int NPLANES = 16;

__device__ __forceinline__ float plane_value(float base, float f) {
  return __fmaf_rn(base, f, f);
}

// ---------------------------------------------------------------- shuffle

constexpr int kShuffleThreads = 512;
constexpr int kShuffleDynamicSmem = 0;

__global__ void __launch_bounds__(kShuffleThreads)
reduce_probe_shuffle_kernel(const float* __restrict__ base, float* __restrict__ acc_out,
                            int steps) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int x = (tid >> 5) * 8 + (lane & 7);
  const int y0 = (lane >> 3) * 4;
  // slot i holds plane i ^ perm: the lanes xor 16 apart differ in bit 3 of
  // perm, the lanes xor 8 apart in bit 2
  const int perm = ((lane >> 4) & 1) * 8 + ((lane >> 3) & 1) * 4;
  float b[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) b[i] = base[(y0 + i) * BX + x];
  float offset[NPLANES];
#pragma unroll
  for (int i = 0; i < NPLANES; ++i) offset[i] = (float)(i ^ perm);
  float weight[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) weight[i] = (float)((i ^ perm) + 1);

  float acc = 0.0f;
  float f0 = 1.0f;  // s * 16 + 1
  for (int s = 0; s < steps; ++s) {
    float sum[NPLANES];
#pragma unroll
    for (int i = 0; i < NPLANES; ++i) {
      const float f = f0 + offset[i];
      sum[i] = (plane_value(b[0], f) + plane_value(b[1], f))
               + (plane_value(b[2], f) + plane_value(b[3], f));
    }
    // row groups {0,1} | {2,3}: keep slots 0-7, send 8-15
#pragma unroll
    for (int i = 0; i < 8; ++i) sum[i] += __shfl_xor_sync(0xffffffffu, sum[i + 8], 16);
    // row groups 0 | 1 (and 2 | 3): keep slots 0-3, send 4-7
#pragma unroll
    for (int i = 0; i < 4; ++i) sum[i] += __shfl_xor_sync(0xffffffffu, sum[i + 4], 8);
    acc += (sum[0] * weight[0] + sum[1] * weight[1]) + (sum[2] * weight[2] + sum[3] * weight[3]);
    f0 += 16.0f;
  }
  // the 4 lanes of a column own its 16 planes between them
  acc += __shfl_xor_sync(0xffffffffu, acc, 8);
  acc += __shfl_xor_sync(0xffffffffu, acc, 16);
  if (lane < 8) acc_out[x] = acc;
}

// -------------------------------------------------------------------- mma

constexpr int kXBlocks = BX / 16;                   // 8 x-blocks of 16 columns
constexpr int kPlaneGroups = 2;                     // warps per x-block
constexpr int kGroupPlanes = NPLANES / kPlaneGroups;  // 8: one D column each
constexpr int kMmaThreads = kXBlocks * kPlaneGroups * 32;
constexpr int kMmaDynamicSmem = 0;  // operands live in registers
constexpr uint32_t kBf16OnePair = 0x3F803F80u;      // two bfloat16 1.0
static_assert(kPlaneGroups == 2 && kGroupPlanes == 8,
              "a plane group fills the 8 columns of D");

__device__ __forceinline__ uint32_t top16_bits(float v) {
  return __float_as_uint(v) & 0xFFFF0000u;
}

// The top halves of a (low) and b (high): two bfloat16 values, exact when
// a's and b's low 16 bits are zero or are to be dropped.
__device__ __forceinline__ uint32_t pack_top_halves(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// d += a (16x16 bfloat16, row-major) x b (16x8 bfloat16, column-major)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b), "r"(b));
}

__global__ void __launch_bounds__(kMmaThreads)
reduce_probe_mma_kernel(const float* __restrict__ base, float* __restrict__ acc_out,
                        int steps) {
  __shared__ float group_acc[kPlaneGroups][BX];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int x0 = (warp % kXBlocks) * 16 + g;  // and x0 + 8
  const int group = warp / kXBlocks;

  // A register r: column x0 + 8 (r & 1), rows 2t + 8 (r >> 1) + {0, 1}
  float b[4][2];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      b[r][h] = base[(2 * t + 8 * (r >> 1) + h) * BX + x0 + 8 * (r & 1)];
  uint32_t sel[kGroupPlanes];  // B for the plane in D column n
#pragma unroll
  for (int n = 0; n < kGroupPlanes; ++n) sel[n] = g == n ? kBf16OnePair : 0u;
  // D registers 0, 1 (x0) and 2, 3 (x0 + 8) hold columns 2t and 2t + 1
  const float w0 = (float)(group * kGroupPlanes + 2 * t + 1);
  const float w1 = w0 + 1.0f;

  float acc_lo = 0.0f, acc_hi = 0.0f;               // columns x0, x0 + 8
  float f0 = (float)(group * kGroupPlanes + 1);     // s * 16 + group * 8 + 1
  for (int s = 0; s < steps; ++s) {
    float d_hi[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float d_mid[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float d_lo[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < kGroupPlanes; ++n) {
      const float f = f0 + (float)n;
      uint32_t a_hi[4], a_mid[4], a_lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p0 = plane_value(b[r][0], f), p1 = plane_value(b[r][1], f);
        const float rem0 = p0 - __uint_as_float(top16_bits(p0));
        const float rem1 = p1 - __uint_as_float(top16_bits(p1));
        const float lo0 = rem0 - __uint_as_float(top16_bits(rem0));
        const float lo1 = rem1 - __uint_as_float(top16_bits(rem1));
        a_hi[r] = pack_top_halves(p0, p1);
        a_mid[r] = pack_top_halves(rem0, rem1);
        a_lo[r] = pack_top_halves(lo0, lo1);
      }
      mma_bf16(d_hi, a_hi, sel[n]);
      mma_bf16(d_mid, a_mid, sel[n]);
      mma_bf16(d_lo, a_lo, sel[n]);
    }
    float row[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) row[i] = (d_hi[i] + d_mid[i]) + d_lo[i];
    float step_lo = row[0] * w0 + row[1] * w1;
    float step_hi = row[2] * w0 + row[3] * w1;
    step_lo += __shfl_xor_sync(0xffffffffu, step_lo, 1);
    step_hi += __shfl_xor_sync(0xffffffffu, step_hi, 1);
    step_lo += __shfl_xor_sync(0xffffffffu, step_lo, 2);
    step_hi += __shfl_xor_sync(0xffffffffu, step_hi, 2);
    acc_lo += step_lo;
    acc_hi += step_hi;
    f0 += (float)NPLANES;
  }
  if (t == 0) {
    group_acc[group][x0] = acc_lo;
    group_acc[group][x0 + 8] = acc_hi;
  }
  __syncthreads();
  const int x = threadIdx.x;
  if (x < BX) acc_out[x] = group_acc[0][x] + group_acc[1][x];
}

}  // namespace

// base (16,128) f32 and acc (128,) f32 on the device.
extern "C" int reduce_probe_shuffle_launch(const float* base, float* acc, int steps,
                                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  reduce_probe_shuffle_kernel<<<1, kShuffleThreads, kShuffleDynamicSmem, (cudaStream_t)stream>>>(
      base, acc, steps);
  return (int)cudaGetLastError();
}

extern "C" int reduce_probe_mma_launch(const float* base, float* acc, int steps, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  reduce_probe_mma_kernel<<<1, kMmaThreads, kMmaDynamicSmem, (cudaStream_t)stream>>>(base, acc,
                                                                               steps);
  return (int)cudaGetLastError();
}

// The dynamic shared memory each launcher asks for, the bytes its launch
// passes (mma != 0: reduce_probe_mma).
extern "C" int reduce_probe_dynamic_smem(int mma) {
  return mma ? kMmaDynamicSmem : kShuffleDynamicSmem;
}
