// Count-only select kernel: per-row TOTAL hits, nothing carried.
//
// Replaces tpu2dgs/raster/select_kernel.py:_count_kernel (the TPU kernel
// behind select_counts). For each output row (an inclusive pixel rectangle)
// it tests every walked candidate of the row's parent list with the select
// kernel's own hit test (hit_test.cuh `hits4`: AABB overlap and/or exact
// splat coverage) and returns how many hit. The walk is select_values':
// whole 1024-candidate macro blocks up to min(parent_count, m), so the
// counts are bit-equal to the counts select_values returns for the same
// arguments.
//
// What bounds it on an H100: the operations of the exact test (about 200
// per candidate on 52 bytes) when many rows share one parent list, which
// then stays in L2; the bytes of the tested channels otherwise. Either way
// a row's walk is short against the card, so the design spreads the walks
// evenly over every SM and keeps one device operation a call:
//
// Work items are (row, chunk) pairs, a chunk being one 1024-candidate macro
// block, as in select_values.cu. The wrapper launches min(items, SMs x CTAs
// per SM) CTAs of 256 threads (select_counts_occupancy), which stride over
// the items in chunk-major order (every row's chunk 0 first), so the walked
// items spread over all CTAs whatever the rows' lengths. A CTA looks 256 of
// its positions ahead at once, one a thread: each reads its row's parent
// count, parent and rectangle, and the walked items are listed in shared
// memory in order. So an item past its row's walk costs one read of its
// parent count, made beside the others, and no item waits on a load of its
// own row before its candidates' loads. A thread tests 4 consecutive
// candidates through one float4 load per tested channel; a warp sums its
// threads' hit bits (__popc, __reduce_add_sync) and the block sums its warps
// through shared memory. A row that walks one chunk stores its count there.
// Otherwise the item stores its count in a scratch slot (row, chunk) and
// takes a ticket of its row (an atomic add with acquire-release semantics:
// the slot is visible before the ticket); the item that draws the row's
// last ticket reads the row's item counts through L2 (__ldcg, at most
// m / 1024), stores their sum in counts[row] with a plain store and puts the
// ticket back to 0. The item (row, 0) of a row that walks nothing stores 0.
// So every row's count is stored exactly once, nothing adds into `counts`
// and nothing is zeroed before the kernel: a call is one launch. Integer
// sums do not depend on their order, so two launches give the same counts.
//
// The tickets: an int32 per row that is 0 before every launch and 0 after
// it (the last ticket resets it). The wrapper keeps one buffer per (device,
// stream), made with zeros when first needed; launches on one stream run
// one after the other, so no two of them share a ticket at once. A
// launch on another stream gets that stream's own buffer. Scratch holds
// rows x chunks ints, uninitialised: only walked items write their slot and
// only the row's last item reads them.
// Registers: __launch_bounds__(256, 3), 80 registers for 3 CTAs an SM. At
// 4 CTAs an SM (64 registers, as select_values) the exact test spilled 96
// bytes and more, and the tile level ran 10% slower. The kernel is
// instantiated for each combination of the two tests, so a call runs only
// the test it asked for.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hit_test.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinCtas = 3;  // CTAs an SM, for __launch_bounds__
static_assert(kThreads * kPer == kMacro, "a work item is one macro block of the walk");

struct Params {
  HitTest test;
  int n_chan;
  int m;       // candidates per parent, a multiple of kMacro
  int rows;
  int chunks;  // m / kMacro: work items per row
};

// Ticket of a row: an atomic add with acquire-release semantics at device
// scope. The release orders this item's slot before its ticket; the acquire,
// for the item that draws the last ticket, orders every earlier item's slot
// before what it reads next.
__device__ __forceinline__ int take_ticket(int* ticket) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(ticket)
               : "memory");
  return old;
}

template <bool kBox, bool kExact>
__global__ void __launch_bounds__(kThreads, kMinCtas)
select_counts_kernel(const float* __restrict__ chan, const int* __restrict__ parent,
                     const int* __restrict__ pcnt, const float* __restrict__ rx0p,
                     const float* __restrict__ rx1p, const float* __restrict__ ry0p,
                     const float* __restrict__ ry1p, int* __restrict__ counts,
                     int* __restrict__ item_hits, int* __restrict__ tickets, const Params p) {
  // The walked items among the CTA's next kThreads positions, in order.
  __shared__ int s_row[kThreads], s_ch[kThreads], s_walked[kThreads], s_parent[kThreads];
  __shared__ float4 s_rect[kThreads];
  __shared__ int warp_walked[kWarps];
  // Double-buffered: buf flips after each walked item, so that item's
  // barrier lies between warp 0's read of a buffer and its next write.
  __shared__ int warp_hits[2][kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t m = (size_t)p.m;
  const int items = p.rows * p.chunks;
  HitTest test = p.test;
  test.use_box = kBox;
  test.use_exact = kExact;

  int buf = 0;
  for (int first = blockIdx.x; first < items; first += kThreads * gridDim.x) {
    // Look ahead: thread t reads what position first + t * gridDim.x needs,
    // all of them at once, so no item waits on its own row's loads.
    const int idx = first + tid * gridDim.x;
    bool walk = false;
    int a_row = 0, a_ch = 0, a_walked = 0, a_parent = 0;
    float4 a_rect = {};
    if (idx < items) {
      a_ch = idx / p.rows;  // chunk-major: every row's chunk 0 first
      a_row = idx - a_ch * p.rows;
      const int count = pcnt[a_row];
      a_parent = parent[a_row];
      a_rect = make_float4(rx0p[a_row], rx1p[a_row], ry0p[a_row], ry1p[a_row]);
      a_walked = walked_candidates(count, p.m) / kMacro;  // chunks the row walks
      walk = a_ch < a_walked;
      if (a_walked == 0 && a_ch == 0) counts[a_row] = 0;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, walk);
    if (lane == 0) warp_walked[warp] = __popc(mask);
    __syncthreads();
    int n_walked = 0, slot = __popc(mask & ((1u << lane) - 1u));
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      n_walked += warp_walked[w];
      slot += w < warp ? warp_walked[w] : 0;
    }
    if (walk) {
      s_row[slot] = a_row;
      s_ch[slot] = a_ch;
      s_walked[slot] = a_walked;
      s_parent[slot] = a_parent;
      s_rect[slot] = a_rect;
    }
    __syncthreads();

    for (int i = 0; i < n_walked; ++i) {
      const int row = s_row[i];
      const int ch = s_ch[i];
      const int walked = s_walked[i];
      const float4 r4 = s_rect[i];
      const Rect rc = {r4.x, r4.y, r4.z, r4.w};
      const float* base = chan + (size_t)s_parent[i] * p.n_chan * m;
      const unsigned bits = hits4(base, m, ch * kMacro + kPer * tid, test, rc);
      const int n = __reduce_add_sync(0xffffffffu, __popc(bits));
      if (lane == 0) warp_hits[buf][warp] = n;
      __syncthreads();
      if (warp == 0) {
        const int total =
            __reduce_add_sync(0xffffffffu, lane < kWarps ? warp_hits[buf][lane] : 0);
        if (walked == 1) {
          if (lane == 0) counts[row] = total;
        } else {
          int* row_hits = item_hits + (size_t)row * p.chunks;
          int last = 0;
          if (lane == 0) {
            row_hits[ch] = total;
            last = take_ticket(&tickets[row]) == walked - 1;
          }
          if (__shfl_sync(0xffffffffu, last, 0)) {
            __syncwarp();  // lane 0's acquire comes before every lane's reads
            int sum = 0;
#pragma unroll 1
            for (int k = lane; k < walked; k += 32) sum += __ldcg(row_hits + k);
            sum = __reduce_add_sync(0xffffffffu, sum);
            if (lane == 0) {
              counts[row] = sum;
              tickets[row] = 0;  // no item of this launch takes the row's ticket again
            }
          }
        }
      }
      buf ^= 1;
    }
    __syncthreads();  // every item of the batch read its entries before the next batch's
  }
}

using Kernel = void (*)(const float*, const int*, const int*, const float*, const float*,
                        const float*, const float*, int*, int*, int*, const Params);

Kernel kernel_for(bool box, bool exact) {
  if (box && exact) return select_counts_kernel<true, true>;
  return box ? select_counts_kernel<true, false> : select_counts_kernel<false, true>;
}

}  // namespace

// CTAs of select_counts_kernel that one SM holds at once (the least over
// its three instantiations), and the device's SM count: the wrapper
// launches at most their product, enough for the card to hold every CTA.
extern "C" int select_counts_occupancy(int device, int* ctas_per_sm, int* sms) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  *ctas_per_sm = 1 << 30;
  for (int v = 1; v < 4; ++v) {
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, (const void*)kernel_for(v & 1, v & 2), kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    *ctas_per_sm = n < *ctas_per_sm ? n : *ctas_per_sm;
  }
  return (int)cudaSuccess;
}

// chan (n_parents, n_chan, m) f32, 16-byte aligned; parent, pcnt (rows,)
// i32; rx0..ry1 (rows,) f32; counts (rows,) i32, written here, never read;
// item_hits rows * (m / 1024) i32, uninitialised; tickets (rows,) i32, all
// 0, left all 0 by the kernel (for this stream only: see the header).
// `ctas` CTAs stride over the items. box_idx (4 ints) or exact_idx (13
// ints) may be null to skip that test; both are host memory.
extern "C" int select_counts_launch(const float* chan, const int* parent, const int* pcnt,
                                    const float* rx0, const float* rx1, const float* ry0,
                                    const float* ry1, int* counts, int* item_hits,
                                    int* tickets, int rows, int n_chan, int m, int ctas,
                                    const int* box_idx, const int* exact_idx, int device,
                                    void* stream) {
  if (m % kMacro != 0 || (!box_idx && !exact_idx) || ctas < 1 ||
      reinterpret_cast<uintptr_t>(chan) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (rows <= 0) return (int)cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params p = {};
  p.test = make_hit_test(box_idx, exact_idx);
  p.n_chan = n_chan;
  p.m = m;
  p.rows = rows;
  p.chunks = m / kMacro;
  kernel_for(box_idx != nullptr, exact_idx != nullptr)<<<ctas, kThreads, 0,
                                                          (cudaStream_t)stream>>>(
      chan, parent, pcnt, rx0, rx1, ry0, ry1, counts, item_hits, tickets, p);
  return (int)cudaGetLastError();
}
