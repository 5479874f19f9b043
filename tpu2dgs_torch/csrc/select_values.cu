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
//
// Design: a row's walk is split over the whole card. A work item is one
// (row, chunk) pair, a chunk being one 1024-candidate macro block, so the
// binning levels give hundreds to thousands of items (7 x 128 at the first
// level of an 800 px image, whose 7 rows used to leave 125 of 132 SMs
// idle). Ranks must follow candidate order across a row's chunks, so each
// item is handled twice, in one cooperative launch of as many 256-thread
// CTAs as the card holds at once:
//   count: each thread tests 4 consecutive candidates (one float4 load
//     per tested channel) and keeps their 4 hit bits; the chunk's bits
//     (one byte per thread) and its hit count go to a scratch array the
//     wrapper allocates uninitialised (only walked chunks write entries
//     and only theirs are read), and the row's counter of counted chunks
//     goes up (the launcher zeroes the counters on the stream);
//   write: once the row's counter shows every walked chunk counted, a
//     chunk's first rank is the sum of its row's earlier chunk counts (at
//     most m / 1024 integers, from L2); a warp scan of the per-thread
//     counts and a scan over the 8 warps rank its hits, whose in-chunk
//     offsets are staged in shared memory by rank, so every carried
//     channel is copied with consecutive ranks on consecutive lanes. The
//     pad slots [min(total, cap), cap) are split over the row's chunks by
//     slot range and written in 16-byte stores; the row's last chunk
//     writes its count.
// The CTAs walk one fixed order of count and write positions (work_at):
// counts run a group of rows and a wave of CTAs ahead of writes, the two
// alternating position by position. So the exact tests (operations) of
// later rows run beside the copies and pads (bytes) of earlier ones, and a
// row's writes wait on its own counts only, which lie two waves of counts
// earlier. Every wait is on an earlier position and every CTA is
// resident, so the waits end. A chunk past its row's walk is not counted,
// counts as 0 hits and writes only its share of the pads. The walk covers
// the same whole 1024-candidate macro blocks as the TPU kernel (counts
// include hits past parent_counts inside the last macro block). The hit
// bits live in device memory, not shared memory, because a CTA may own any
// number of items; at 256 bytes an item they stay in L2. Registers are
// capped at 64 for 4 CTAs per SM (a few bytes spill): at 3 CTAs per SM and
// 80 registers the tile level ran slower.
//
// Bit-exactness: values are copied, never computed. The hit test lives in
// hit_test.cuh, shared with the count-only kernel (select_counts.cu): it is
// compiled with --fmad=false and IEEE division, in the plain version's
// operation order, so it decides each candidate exactly as the plain
// PyTorch version does. The float4 loads only feed it. The order of the
// output is fixed by the candidates, never by the schedule: two launches
// are bit-equal.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hit_test.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;                  // consecutive candidates per thread: one float4
constexpr int kChunk = kThreads * kPer;  // candidates per work item
static_assert(kChunk == kMacro, "a work item is one macro block of the walk");
constexpr int kMaxChan = 32;

struct Params {
  HitTest test;
  int n_chan;
  int m;           // candidates per parent, a multiple of kChunk
  int cap;
  int rows;
  int chunks;      // m / kChunk: work items per row
  int group;       // rows per group of the launch's order (work_at)
  int groups;
  int ahead;       // items the counts run ahead of the writes
  int positions;   // 2 * groups * group * chunks
  float pads[kMaxChan];
};

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float part(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Bits 0-3: do candidates j..j+3 of the channel-major list `base` hit the
// rectangle? candidate_hits' test, four candidates per float4 load.
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

// A load with acquire semantics at device scope: what the writer released
// before it is visible after it.
__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

enum Kind { kNone, kCount, kWrite };

struct Work {
  Kind kind;
  int row, ch;
};

// The work at position `pos` of the launch's order. The items are listed
// in groups of p.group rows, chunk-major inside a group (so the walked
// chunks, a row's first ones, spread over the CTAs); counts run p.ahead
// items ahead of writes, and where both are left they alternate:
//   count 0 .. ahead-1 | count ahead, write 0, count ahead+1, write 1, ... |
//   the last writes.
// With ahead = a group's items + the CTAs, a row's writes come two waves of
// counts after the last count of its group.
__device__ __forceinline__ Work work_at(int pos, const Params& p) {
  const int u = p.group * p.chunks;  // items of a group
  const int n = p.groups * u;        // items of the order, past-the-end rows included
  const int d = min(p.ahead, n);
  Kind kind = kCount;
  int idx = pos;
  if (pos >= 2 * n - d) {
    kind = kWrite;
    idx = pos - n;
  } else if (pos >= d) {
    const int q = pos - d;
    kind = (q & 1) ? kWrite : kCount;
    idx = (q & 1) ? q >> 1 : d + (q >> 1);
  }
  const int g = idx / u;
  const int r = idx - g * u;
  const int row = g * p.group + r % p.group;
  return {row < p.rows ? kind : kNone, row, r / p.group};
}

__global__ void __launch_bounds__(kThreads, 4)
select_values_kernel(const float* __restrict__ chan, const int* __restrict__ parent,
                     const int* __restrict__ pcnt, const float* __restrict__ rx0p,
                     const float* __restrict__ rx1p, const float* __restrict__ ry0p,
                     const float* __restrict__ ry1p, float* __restrict__ out,
                     int* __restrict__ counts, int* scratch, const Params p) {
  // Double-buffered: buf flips after each item that passed a barrier, so a
  // barrier of the next such item lies between a buffer's last read and
  // its next write.
  __shared__ int warp_hits[2][kWarps];
  __shared__ int row_sums[2][2];           // hits of the row's earlier chunks, row total
  __shared__ uint16_t slot[2][kChunk];     // in-chunk offset of each hit, by rank

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t m = (size_t)p.m;
  const int items = p.rows * p.chunks;
  // Scratch, row-major by item e = row * chunks + ch: each item's hit
  // count, each row's number of counted chunks (zeroed by the launcher),
  // each item's hit bits (a byte per thread). Read through L2 only (__ldcg):
  // other CTAs wrote them during this launch.
  int* chunk_hits = scratch;
  int* counted = scratch + items;
  uint8_t* chunk_bits = reinterpret_cast<uint8_t*>(scratch + items + p.rows);

  int buf = 0;
  for (int pos = blockIdx.x; pos < p.positions; pos += gridDim.x) {
    const Work w = work_at(pos, p);
    if (w.kind == kNone) continue;
    const int row = w.row;
    const int ch = w.ch;
    const size_t e = (size_t)row * p.chunks + ch;
    const int walked = walked_candidates(pcnt[row], p.m) / kChunk;  // chunks with entries

    if (w.kind == kCount) {
      // Test the chunk, count its hits, publish them. A chunk past its
      // row's walk is skipped: no write reads its entries.
      if (ch >= walked) continue;  // the whole CTA
      const Rect rc = {rx0p[row], rx1p[row], ry0p[row], ry1p[row]};
      const float* base = chan + (size_t)parent[row] * p.n_chan * m;
      const unsigned bits = hits4(base, m, ch * kChunk + kPer * tid, p.test, rc);
      chunk_bits[e * kThreads + tid] = (uint8_t)bits;
      const int n = __reduce_add_sync(0xffffffffu, __popc(bits));
      if (lane == 0) warp_hits[buf][warp] = n;
      __syncthreads();  // the CTA's bits are written before thread 0 releases them
      if (tid == 0) {
        int total = 0;
#pragma unroll
        for (int w8 = 0; w8 < kWarps; ++w8) total += warp_hits[buf][w8];
        chunk_hits[e] = total;
        __threadfence();
        atomicAdd(&counted[row], 1);
      }
      buf ^= 1;
      continue;
    }

    // Write: wait until every walked chunk of the row is counted (their
    // positions all come earlier), rank this chunk's hits in the row, copy
    // them, write this chunk's share of the pads.
    if (tid == 0) {
      while (load_acquire(&counted[row]) < walked) __nanosleep(64);
    }
    __syncthreads();
    const unsigned bits = ch < walked ? __ldcg(chunk_bits + e * kThreads + tid) : 0u;
    const int own = __popc(bits);
    int incl = own;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    if (lane == 31) warp_hits[buf][warp] = incl;
    if (warp == 0) {
      const int* row_hits = chunk_hits + (size_t)row * p.chunks;
      int before = 0, total = 0;
      for (int k = lane; k < walked; k += 32) {
        const int c = __ldcg(row_hits + k);
        total += c;
        before += k < ch ? c : 0;
      }
      before = __reduce_add_sync(0xffffffffu, before);
      total = __reduce_add_sync(0xffffffffu, total);
      if (lane == 0) {
        row_sums[buf][0] = before;
        row_sums[buf][1] = total;
      }
    }
    __syncthreads();
    int nh = 0;  // the chunk's hits
    if (ch < walked) {  // the whole CTA
      int rank = incl - own;  // in-chunk rank of this thread's first hit
#pragma unroll
      for (int w8 = 0; w8 < kWarps; ++w8) {
        const int s = warp_hits[buf][w8];
        nh += s;
        rank += w8 < warp ? s : 0;
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (bits >> k & 1u) slot[buf][rank++] = (uint16_t)(kPer * tid + k);
      }
      __syncthreads();
    }

    const int before = row_sums[buf][0];
    const int total = row_sums[buf][1];
    float* orow = out + (size_t)row * p.n_chan * p.cap;
    // Hits: ranks before .. before + nw - 1, the ones below cap. A thread
    // copies one hit, 8 channels' loads in flight at a time; consecutive
    // threads write consecutive ranks of a channel.
    const int nw = max(0, min(nh, p.cap - before));
    if (nw > 0) {
      const float* src = chan + (size_t)parent[row] * p.n_chan * m + (size_t)ch * kChunk;
      for (int k = tid; k < nw; k += kThreads) {
        const float* s = src + slot[buf][k];
        float* o = orow + before + k;
        int c = 0;
        for (; c + 8 <= p.n_chan; c += 8) {
          float v[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] = __ldg(s + (c + i) * m);
#pragma unroll
          for (int i = 0; i < 8; ++i) o[(size_t)(c + i) * p.cap] = v[i];
        }
        for (; c < p.n_chan; ++c) o[(size_t)c * p.cap] = __ldg(s + c * m);
      }
    }
    // Pads: [filled, cap) split over the row's chunks in shares of whole
    // 128-slot blocks counted from filled rounded down to 4 slots, so every
    // share is written in 16-byte stores (the first one's head in 4-byte
    // ones). Thread tid writes float4 groups tid, tid + 256, ... of the
    // share's (channel, group) pairs.
    const int filled = min(total, p.cap);
    const int base = filled & ~3;
    const int per = ((p.cap - base + p.chunks - 1) / p.chunks + 127) & ~127;
    const int lo = (int)min((long long)p.cap, base + (long long)ch * per);
    const int n4 = (min(p.cap, lo + per) - lo) >> 2;  // float4 groups per channel
    if (n4 > 0) {
      const int dc = kThreads / n4, dg = kThreads - dc * n4;
      int c = tid / n4, g = tid - c * n4;
      while (c < p.n_chan) {
        const int slot0 = lo + 4 * g;
        float* o = orow + (size_t)c * p.cap + slot0;
        const float pad = p.pads[c];
        if (slot0 >= filled) {
          *reinterpret_cast<float4*>(o) = make_float4(pad, pad, pad, pad);
        } else {
          for (int i = filled - slot0; i < 4; ++i) o[i] = pad;
        }
        c += dc;
        g += dg;
        if (g >= n4) {
          g -= n4;
          ++c;
        }
      }
    }
    if (ch == p.chunks - 1 && tid == 0) counts[row] = total;
    buf ^= 1;
  }
}

}  // namespace

// CTAs of select_values_kernel that one SM holds at once, and the device's
// SM count: the cooperative grid is at most their product. Fails where the
// device cannot launch cooperative kernels.
extern "C" int select_values_occupancy(int device, int* ctas_per_sm, int* sms) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, select_values_kernel,
                                                            kThreads, 0);
}

// chan (n_parents, n_chan, m) f32, 16-byte aligned; parent, pcnt (rows,)
// i32; rx0..ry1 (rows,) f32; out (rows, n_chan, cap) f32; counts (rows,)
// i32; scratch rows * (m / 1024) * 65 + rows i32, uninitialised (the rows
// counters are zeroed here, on the stream). `ctas` CTAs stride over the
// order of work_at with groups of `group` rows, counts `ahead` items ahead
// of writes: at most what the device holds at once
// (select_values_occupancy), or the cooperative launch is refused.
// box_idx (4 ints) or exact_idx (13 ints) may be null to skip that test;
// pad_vals holds n_chan floats. Index arrays and pad values are host memory.
extern "C" int select_values_launch(const float* chan, const int* parent, const int* pcnt,
                                    const float* rx0, const float* rx1, const float* ry0,
                                    const float* ry1, float* out, int* counts, int* scratch,
                                    int rows, int n_chan, int m, int cap, int ctas, int group,
                                    int ahead,
                                    const int* box_idx, const int* exact_idx,
                                    const float* pad_vals, int device, void* stream) {
  if (n_chan > kMaxChan || m % kChunk != 0 || (!box_idx && !exact_idx) ||
      reinterpret_cast<uintptr_t>(chan) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (rows <= 0) return (int)cudaSuccess;
  if (ctas < 1 || group < 1 || ahead < group * (m / kChunk)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int items = rows * (m / kChunk);
  err = cudaMemsetAsync(scratch + items, 0, sizeof(int) * (size_t)rows, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  Params p = {};
  p.test = make_hit_test(box_idx, exact_idx);
  p.n_chan = n_chan;
  p.m = m;
  p.cap = cap;
  p.rows = rows;
  p.chunks = m / kChunk;
  p.group = group;
  p.groups = (rows + group - 1) / group;
  p.ahead = ahead;
  p.positions = 2 * p.groups * group * p.chunks;
  for (int c = 0; c < n_chan; ++c) p.pads[c] = pad_vals[c];
  void* args[] = {(void*)&chan, (void*)&parent, (void*)&pcnt, (void*)&rx0, (void*)&rx1,
                  (void*)&ry0, (void*)&ry1, (void*)&out, (void*)&counts, (void*)&scratch,
                  (void*)&p};
  err = cudaLaunchCooperativeKernel((const void*)select_values_kernel, dim3(ctas),
                                    dim3(kThreads), args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch is not sticky: clear it for the next launcher
    return (int)err;
  }
  return (int)cudaGetLastError();
}
