// Backward blend kernel: per-record gradients of the front-to-back surfel
// compositing, as globally packed rows.
//
// Replaces tpu2dgs/raster/pallas_backend.py:_bwd_kernel (launched by
// _blend_bwd_call). Each 16 x 128-pixel tile (column-major,
// t = tix * nty + tiy) re-walks its record list back to front from the
// chunk of its last contributor (out channel 12). Per pixel it rebuilds the
// transmittance before each record as T / (1 - alpha), keeps suffix sums for
// the colour, depth, normal and distortion terms, and finds the median-depth
// record as the first one, walking backwards, whose T before it is above
// 0.5. Per record, the 19 per-pixel gradient contributions (record channels
// 0:19) are summed over the tile's 2048 pixels into one 20-float row; the
// 20th float carries record channel 21, the row of the record array the
// gradient belongs to. Tile t writes its row for list entry j at packed row
// off[t] + j, off being the exclusive prefix sum of the tiles' group-aligned
// effective counts. A group of `group` rows whose end would pass pack_cap is
// dropped whole, never clamped onto other tiles' rows. Every other row of a
// tile's reserved region [off, off + effective count) is written: zeros
// where the walk produced nothing.
//
// The work: a (record, pixel) pair costs about 50 f32 operations for the
// response and, where the pixel blended the record, about 145 more; only
// 2-3% of a list's pairs blend, and the longest list is several times the
// mean. Design: one cluster of 8 CTAs per tile,
// CTA r owning the 16 x 16 sub-tile r, 2 pixels per thread (one column, 2
// rows) with the walk's carries in registers and the 9 dout planes the walk
// reads in shared memory. Every CTA walks the same chunks, back to front
// from the tile's last contributor; records are staged 64 at a time with
// cp.async, double-buffered. Each warp culls the chunk for its 16 x 4 block
// (blend_common.cuh), keeping the entries that reach the block and lie at or
// before the sub-tile's last contributor, and walks only those. Per kept
// record each thread sums its pixels; a warp none of whose pixels blended
// writes zeros, the others reduce by a fixed transpose tree of 31 shuffles.
// After the chunk the CTA sums, for each entry one of its warps kept, those
// warps' partials in warp order into its [64][19] chunk buffer. Then
// cluster.sync(), and CTA r sums rows 8r .. 8r + 7 of the chunk over the 8
// CTAs' buffers in rank order through distributed shared memory (a CTA that
// kept no such entry adds nothing) and writes those 8 consecutive packed
// rows. Chunk buffers and masks are double-buffered, so one cluster barrier
// per chunk suffices. Every sum has a fixed order and there are no atomics,
// so two launches give the same bits. --fmad=false and IEEE division keep
// every per-pixel term, T / (1 - alpha) and the median test among them,
// equal to the plain PyTorch version's.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "blend_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace blend;

constexpr int kGrad = 19;                       // gradient channels per row
constexpr int kRow = 20;                        // packed row width
constexpr int kDout = 9;                        // dout planes kept: 0,1,2,4,5,6,7,8,9
constexpr int kRowsPerCta = kChunk / kSubs;     // rows of a chunk one CTA writes

// One level of the warp's transpose sum of 32 values: a lane keeps half of
// its values and trades the other half with its partner (lane ^ H), adding
// the partner's copy of what it keeps. After the levels 16, 8, 4, 2, 1, lane
// i holds the sum over the 32 lanes of v[i] in v[0]: 31 shuffles where a
// tree per value takes 5 x 19. Every sum has a fixed order.
template <int H>
__device__ __forceinline__ void transpose_level(float (&v)[32], int lane) {
  const bool upper = (lane & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

struct Smem {
  Chunk stage[2];                        // double-buffered record chunks
  float sdout[kDout][kSubPix];           // this sub-tile's dout planes
  float wpart[kWarps][kChunk][kGrad];    // per-warp partial of each kept entry
  float cbuf[2][kChunk][kGrad];          // the CTA's partials, read by the cluster
  uint64_t smask[2];                     // the CTA's kept entries per chunk buffer
  uint64_t wmask[kWarps];                // each warp's kept entries of this chunk
  uint64_t rmask[kSubs];                 // the cluster's masks of this chunk
  int wmax[kWarps];
  int max_last;                          // this sub-tile's last contributor
};

__global__ void __cluster_dims__(kSubs, 1, 1) __launch_bounds__(kThreads, 4)
blend_backward_kernel(const float* __restrict__ rec3, const int* __restrict__ counts,
                      const int* __restrict__ offs, const float* __restrict__ out,
                      const float* __restrict__ dout, float* __restrict__ dpack,
                      int nch, int capk, int nty, int group, int pack_cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();

  const int sub = (int)cluster.block_rank();
  const int t = blockIdx.x / kSubs;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int lx = pixel_col(tid);
  const int ly0 = pixel_row0(tid);
  const float x0 = (float)((t / nty) * kBX + sub * kSubW);
  const float y0 = (float)((t % nty) * kBY);
  const float px = x0 + (float)lx;

  const float* o = out + (size_t)t * kOutCh * kPlane;
  const float* d = dout + (size_t)t * kOutCh * kPlane;

  // Per-pixel carries of the walk and the forward's finals.
  float py[kPix], T_cur[kPix], acc_w[kPix], s_w[kPix], s_wm[kPix], acc_a[kPix],
      s_wm2[kPix], m1f[kPix], m2f[kPix], last[kPix], dt_term[kPix];
  bool med_done[kPix];
  int my_last = -1;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int gpix = (ly0 + k) * kBX + sub * kSubW + lx;
    const int lpix = (ly0 + k) * kSubW + lx;
    py[k] = y0 + (float)(ly0 + k);
    T_cur[k] = o[3 * kPlane + gpix];
    m1f[k] = o[10 * kPlane + gpix];
    m2f[k] = o[11 * kPlane + gpix];
    last[k] = o[12 * kPlane + gpix];
    dt_term[k] = d[3 * kPlane + gpix] * T_cur[k];
    acc_w[k] = s_w[k] = s_wm[k] = acc_a[k] = s_wm2[k] = 0.0f;
    med_done[k] = false;
    my_last = max(my_last, (int)last[k]);
    // dout channel 3 (T_final) went into dt_term; the walk reads the rest.
#pragma unroll
    for (int c = 0; c < kDout; ++c) sm.sdout[c][lpix] = d[(c < 3 ? c : c + 1) * kPlane + gpix];
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) my_last = max(my_last, __shfl_xor_sync(0xffffffffu, my_last, s));
  if (lane == 0) sm.wmax[warp] = my_last;
  __syncthreads();
  if (tid == 0) {
    int m = sm.wmax[0];
    for (int w = 1; w < kWarps; ++w) m = max(m, sm.wmax[w]);
    sm.max_last = m;
  }
  cluster.sync();  // every CTA's max_last is set

  const int sub_last = sm.max_last;
  int tile_last = -1;
  for (int q = 0; q < kSubs; ++q) tile_last = max(tile_last, *cluster.map_shared_rank(&sm.max_last, q));

  const int count = min(counts[t], capk);
  const int off = offs[t];
  const int n_chunks = tile_last < 0 ? 0 : tile_last / kChunk + 1;
  // Group-aligned effective count: the rows this tile reserved.
  const int walked_rows = tile_last < 0 ? 0 : (tile_last / group + 1) * group;
  const int eff = min((count + group - 1) / group * group, walked_rows);
  // Entries this sub-tile can have blended: live ones up to its last contributor.
  const int live = min(count, sub_last + 1);

  // Reserved rows above the walked chunks: zeros, split over the cluster.
  for (int i = n_chunks * kChunk * kRow + sub * kThreads + tid; i < eff * kRow;
       i += kSubs * kThreads) {
    const int j = i / kRow;
    if (off + (j / group) * group + group <= pack_cap) dpack[(size_t)off * kRow + i] = 0.0f;
  }

  const float* rec = rec3 + (size_t)t * nch * capk;
  if (n_chunks > 0) stage_chunk(sm.stage[0], rec, capk, (n_chunks - 1) * kChunk, count);
  cp_async_commit();
  for (int it = 0; it < n_chunks; ++it) {
    const int c0 = (n_chunks - 1 - it) * kChunk;
    const int b = it & 1;
    // Everyone is done with the buffer the next chunk lands in (the last one's).
    __syncthreads();
    if (it + 1 < n_chunks) {
      stage_chunk(sm.stage[b ^ 1], rec, capk, c0 - kChunk, count);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this chunk has landed for every thread
    const Chunk& ch = sm.stage[b];
    const uint64_t wkept = cull_warp(ch, c0, live, x0, y0 + (float)(warp * kWarpRows));
    if (lane == 0) sm.wmask[warp] = wkept;

    uint64_t todo = wkept;
    while (todo) {  // back to front
      const int kk = 63 - __clzll((long long)todo);
      todo ^= 1ull << kk;
      const float fj = (float)(c0 + kk);
      const Geom g = load_geom(ch, kk);

      // Thread sums over its kPix pixels, in pixel order. s_pu/s_pv/s_pw
      // serve channels 0:3 (times px, shared by the thread's pixels) and 6:9.
      float s_pu = 0.f, s_pv = 0.f, s_pw = 0.f;
      float acc[13];  // channels 3:6, 9:19
#pragma unroll
      for (int i = 0; i < 13; ++i) acc[i] = 0.f;
      bool any = false;

#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        const float y = py[k];
        const Response r = splat_response(g, px, y);
        // kept entries are live (below count)
        const bool blended = r.hit & (fj <= last[k]);
        if (!blended) continue;
        any = true;

        const int lpix = (ly0 + k) * kSubW + lx;
        const float d_r = sm.sdout[0][lpix], d_g = sm.sdout[1][lpix];
        const float d_b = sm.sdout[2][lpix], d_dep = sm.sdout[3][lpix];
        const float d_n0 = sm.sdout[4][lpix], d_n1 = sm.sdout[5][lpix];
        const float d_n2 = sm.sdout[6][lpix], d_med = sm.sdout[7][lpix];
        const float d_dist = sm.sdout[8][lpix];
        const float c_r = ch.rec[12][kk], c_g = ch.rec[13][kk], c_b = ch.rec[14][kk];
        const float n0 = ch.rec[15][kk], n1 = ch.rec[16][kk], n2 = ch.rec[17][kk];

        const float a = r.alpha;
        const float depthp = r.depthp;
        const float t_before = T_cur[k] / (1.0f - a);
        const float w = a * t_before;
        const float safe = safe_depth(depthp);
        const float m = map_depth(safe);
        const float wm = w * m;
        const float wm2 = wm * m;
        const float m1b = m1f[k] - s_wm[k] - wm;
        const float m2b = m2f[k] - s_wm2[k] - wm2;
        const float a_before = 1.0f - t_before;
        const float mm = m * m;
        const float two_m = 2.0f * m;

        const float dldw =
            d_r * c_r + d_g * c_g + d_b * c_b + d_dep * depthp + d_n0 * n0 + d_n1 * n1 +
            d_n2 * n2 +
            d_dist * (mm * a_before + m2b - two_m * m1b + mm * s_w[k] - two_m * s_wm[k]);

        const bool is_med = (t_before > kMedianT) & !med_done[k];
        if (is_med) med_done[k] = true;

        const float d_m = d_dist * (w * (two_m * a_before - 2.0f * m1b) +
                                    w * (two_m * s_w[k] - 2.0f * s_wm[k]));
        const float dm_dd = kDmDd / (safe * safe);
        const float d_d = d_dep * w + d_m * dm_dd + (is_med ? d_med : 0.0f);

        const float one_minus = fmaxf(1.0f - a, kOneMinusClamp);
        const float d_a =
            dldw * t_before + (acc_a[k] - acc_w[k] - dt_term[k]) / one_minus;

        acc_w[k] = acc_w[k] + dldw * w;
        acc_a[k] = acc_a[k] + d_dist * w * m * m * t_before;
        s_w[k] = s_w[k] + w;
        s_wm[k] = s_wm[k] + wm;
        s_wm2[k] = s_wm2[k] + wm2;
        T_cur[k] = t_before;

        const float d_op = r.not_clamped ? r.G * d_a : 0.0f;
        const float d_rho = r.not_clamped ? -0.5f * g.op * r.G * d_a : 0.0f;
        const float d_rho3d = r.use3d ? d_rho : 0.0f;
        const float d_su = 2.0f * r.su * d_rho3d + g.a0 * d_d;
        const float d_sv = 2.0f * r.sv * d_rho3d + g.a1 * d_d;
        const float d_pu = d_su * r.inv;
        const float d_pv = d_sv * r.inv;
        const float d_pw = -(r.su * d_su + r.sv * d_sv) * r.inv;

        s_pu += d_pu;
        s_pv += d_pv;
        s_pw += d_pw;
        acc[0] += y * d_pu;
        acc[1] += y * d_pv;
        acc[2] += y * d_pw;
        acc[3] += r.su * d_d;
        acc[4] += r.sv * d_d;
        acc[5] += d_d;
        acc[6] += w * d_r;
        acc[7] += w * d_g;
        acc[8] += w * d_b;
        acc[9] += w * d_n0;
        acc[10] += w * d_n1;
        acc[11] += w * d_n2;
        acc[12] += d_op;
      }

      float* part = sm.wpart[warp][kk];
      if (__any_sync(0xffffffffu, any)) {
        float v[32] = {px * s_pu, px * s_pv, px * s_pw, acc[0], acc[1], acc[2],
                       s_pu,      s_pv,      s_pw,      acc[3], acc[4], acc[5],
                       acc[6],    acc[7],    acc[8],    acc[9], acc[10], acc[11],
                       acc[12]};  // 19:32 zero
        transpose_level<16>(v, lane);
        transpose_level<8>(v, lane);
        transpose_level<4>(v, lane);
        transpose_level<2>(v, lane);
        transpose_level<1>(v, lane);
        if (lane < kGrad) part[lane] = v[0];  // lane i holds the sum of v[i]
      } else if (lane < kGrad) {
        part[lane] = 0.0f;
      }
    }
    __syncthreads();

    // The CTA's partial of each kept entry: its warps' partials in warp order.
    uint64_t wm[kWarps];
    uint64_t kept = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) kept |= (wm[w] = sm.wmask[w]);
    if (tid == 0) sm.smask[b] = kept;
    if (kept) {
      for (int i = tid; i < kChunk * kGrad; i += kThreads) {
        const int kk = i / kGrad;
        const int comp = i % kGrad;
        if ((kept >> kk) & 1) {
          float v = 0.0f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w)
            if ((wm[w] >> kk) & 1) v += sm.wpart[w][kk][comp];
          sm.cbuf[b][kk][comp] = v;
        }
      }
    }
    cluster.sync();  // every CTA's partials and mask of this chunk are final

    if (tid < kSubs) sm.rmask[tid] = *cluster.map_shared_rank(&sm.smask[b], tid);
    __syncthreads();
    // Rows 8 sub .. 8 sub + 7 of the chunk: consecutive packed rows, each the
    // sum over the cluster's CTAs in rank order.
    for (int i = tid; i < kRowsPerCta * kRow; i += kThreads) {
      const int kk = sub * kRowsPerCta + i / kRow;
      const int comp = i % kRow;
      const int jj = c0 + kk;
      float v = 0.0f;
      if (comp < kGrad) {
        for (int q = 0; q < kSubs; ++q) {
          if ((sm.rmask[q] >> kk) & 1) v += *cluster.map_shared_rank(&sm.cbuf[b][kk][comp], q);
        }
      } else if (jj < count) {
        v = ch.rec[21][kk];
      }
      if (off + (jj / group) * group + group <= pack_cap)
        dpack[(size_t)(off + jj) * kRow + comp] = v;
    }
  }
  cluster.sync();  // no CTA leaves while another may still read its shared memory
}

}  // namespace

// rec3 (tiles, nch, capk) f32 channel-major record lists, nch >= 24 (the
// cull reads te2 and fr2, channels 22 and 23); counts, offs (tiles,) i32;
// out, dout (tiles, 16, 16, 128) f32; dpack (pack_cap, 20) f32.
// group = min(256, capk) divides capk, is a multiple of 64, and divides
// every offset and pack_cap.
extern "C" int blend_backward_launch(const float* rec3, const int* counts, const int* offs,
                                     const float* out, const float* dout, float* dpack,
                                     int tiles, int nch, int capk, int nty, int group,
                                     int pack_cap, int device, void* stream) {
  if (nch < kStage || nty <= 0 || group <= 0 || group % kChunk != 0 || capk % group != 0 ||
      pack_cap % group != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(blend_backward_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem));
  if (err != cudaSuccess) return (int)err;
  if (tiles > 0) {
    blend_backward_kernel<<<tiles * kSubs, kThreads, sizeof(Smem), (cudaStream_t)stream>>>(
        rec3, counts, offs, out, dout, dpack, nch, capk, nty, group, pack_cap);
  }
  return (int)cudaGetLastError();
}

// Clusters of 8 CTAs the card holds at once, CTAs one SM holds at once, and
// the dynamic shared memory of one CTA.
extern "C" int blend_backward_occupancy(int device, int* clusters, int* ctas_per_sm,
                                        int* smem_bytes) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(blend_backward_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem));
  if (err != cudaSuccess) return (int)err;
  *smem_bytes = (int)sizeof(Smem);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, blend_backward_kernel,
                                                      kThreads, sizeof(Smem));
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kSubs * sms, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = sizeof(Smem);
  return (int)cudaOccupancyMaxActiveClusters(clusters, blend_backward_kernel, &cfg);
}
