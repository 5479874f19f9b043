// Forward blend kernel: front-to-back surfel compositing per screen tile.
//
// Replaces tpu2dgs/raster/pallas_backend.py:_fwd_kernel (launched by
// _blend_call). Each 16 x 128-pixel tile, in column-major order
// (t = tix * nty + tiy), walks its depth-sorted record list rec3[t, :, j]
// for j < counts[t]. Per pixel: the ray-splat intersection from the
// linearized homography (c1, c2, c3), rho = min(rho3d, low-pass rho2d),
// alpha = min(0.99, opacity * exp(-rho/2)), the hit test, the sticky kill
// when T * (1 - alpha) < 1e-4, and accumulation of rgb, T, expected depth,
// normal, median depth (while T > 0.5), the pairwise distortion through
// m1/m2 and the last contributor index. Output: the 16-channel layout of
// pallas_backend.py (OUT_CH), out[t, ch, y, x].
//
// What bounds it on an H100: operations. A pair that hits costs about 90
// f32 operations, one expf among them; only 2-3% of a list's (record,
// pixel) pairs hit, and the longest list of a scene is several times its
// mean. Design: one 128-thread CTA per 16 x 16 sub-tile (8 per tile, all
// independent: no pixel needs another sub-tile), 2 pixels per thread with
// their state in registers. Records are staged 64 at a time with cp.async,
// double-buffered so the next chunk lands while this one is walked; each
// warp culls the chunk for its 16 x 4 block (blend_common.cuh; about 18% of
// the entries reach a sub-tile, fewer a block) and walks only the entries
// it kept, in list order. A pair the cull clears would have added w = 0
// terms, so the output equals the plain version's. After each chunk __syncthreads_or over "any pixel
// alive" ends the sub-tile's walk; kills are per pixel, so the exit changes
// work, not outputs. expf (not __expf) and --fmad=false keep the arithmetic
// equal to the plain PyTorch version's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "blend_common.cuh"

namespace {

using namespace blend;

struct Pixel {
  float T, r, g, b, dep, n0, n1, n2, med, m1, m2, dist, last;
  bool alive;
};

// At most 85 registers a thread: six CTAs share an SM.
__global__ void __launch_bounds__(kThreads, 6)
blend_forward_kernel(const float* __restrict__ rec3, const int* __restrict__ counts,
                     float* __restrict__ out, int nch, int capk, int nty, int row0) {
  __shared__ Chunk stage[2];

  const int t = blockIdx.x / kSubs;
  const int sub = blockIdx.x % kSubs;
  const int tid = threadIdx.x;
  const int lx = pixel_col(tid);
  const int ly0 = pixel_row0(tid);
  const float x0 = (float)((t / nty) * kBX + sub * kSubW);
  // Tile row t % nty of a strip that starts at tile row row0 of the image:
  // the pixel rows and the cull's rectangles both follow from y0.
  const float y0 = (float)(((t % nty) + row0) * kBY);
  const float px = x0 + (float)lx;
  float py[kPix];
  Pixel s[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    py[k] = y0 + (float)(ly0 + k);
    s[k] = Pixel{1.0f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, -1.0f, true};
  }

  const int count = min(counts[t], capk);
  const int n_chunks = (count + kChunk - 1) / kChunk;
  const float* rec = rec3 + (size_t)t * nch * capk;
  if (n_chunks > 0) stage_chunk(stage[0], rec, capk, 0, count);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * kChunk;
    // Everyone is done with the buffer chunk c + 1 lands in (chunk c - 1's).
    __syncthreads();
    if (c + 1 < n_chunks) {
      stage_chunk(stage[(c + 1) & 1], rec, capk, c0 + kChunk, count);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c has landed for every thread
    const Chunk& ch = stage[c & 1];
    uint64_t todo = cull_warp(ch, c0, count, x0, y0 + (float)((tid >> 5) * kWarpRows));
    while (todo) {
      const int kk = __ffsll((long long)todo) - 1;
      todo &= todo - 1;
      const Geom g = load_geom(ch, kk);
      const float jj = (float)(c0 + kk);
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        Pixel& q = s[k];
        const Response o = splat_response(g, px, py[k]);
        if (!(o.hit & q.alive)) continue;  // adds w = 0: nothing
        const float test_t = q.T * (1.0f - o.alpha);
        if (test_t < kTEps) {
          q.alive = false;
          continue;
        }
        const float a = o.alpha;
        const float w = a * q.T;
        if (q.T > kMedianT) q.med = o.depthp;
        q.last = jj;
        const float m = map_depth(safe_depth(o.depthp));
        q.dist = q.dist + w * (m * m * (1.0f - q.T) + q.m2 - 2.0f * m * q.m1);
        q.m1 = q.m1 + w * m;
        q.m2 = q.m2 + w * m * m;
        q.T = q.T * (1.0f - a);
        q.r = q.r + w * ch.rec[12][kk];
        q.g = q.g + w * ch.rec[13][kk];
        q.b = q.b + w * ch.rec[14][kk];
        q.dep = q.dep + w * o.depthp;
        q.n0 = q.n0 + w * ch.rec[15][kk];
        q.n1 = q.n1 + w * ch.rec[16][kk];
        q.n2 = q.n2 + w * ch.rec[17][kk];
      }
    }
    bool any_alive = false;
#pragma unroll
    for (int k = 0; k < kPix; ++k) any_alive |= s[k].alive;
    if (!__syncthreads_or(any_alive)) break;
  }
  cp_async_wait<0>();  // a walk that ended early leaves no copy in flight

  float* o = out + (size_t)t * kOutCh * kPlane;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const Pixel& q = s[k];
    const float vals[kOutCh] = {q.r, q.g, q.b, q.T, q.dep, q.n0, q.n1, q.n2,
                                q.med, q.dist, q.m1, q.m2, q.last, 0.f, 0.f, 0.f};
    const int pix = (ly0 + k) * kBX + sub * kSubW + lx;
#pragma unroll
    for (int c = 0; c < kOutCh; ++c) o[c * kPlane + pix] = vals[c];
  }
}

}  // namespace

// rec3 (tiles, nch, capk) f32 channel-major record lists, nch >= 24 (the
// cull reads te2 and fr2, channels 22 and 23); counts (tiles,) i32;
// out (tiles, 16, 16, 128) f32. The tiles are a strip of nty tile rows
// whose first is tile row row0 >= 0 of the image (0: the whole image).
extern "C" int blend_forward_launch(const float* rec3, const int* counts, float* out,
                                    int tiles, int nch, int capk, int nty, int row0,
                                    int device, void* stream) {
  if (nch < kStage || nty <= 0 || row0 < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (tiles > 0) {
    blend_forward_kernel<<<tiles * kSubs, kThreads, 0, (cudaStream_t)stream>>>(
        rec3, counts, out, nch, capk, nty, row0);
  }
  return (int)cudaGetLastError();
}

// CTAs of the kernel one SM holds at once.
extern "C" int blend_forward_occupancy(int device, int* ctas_per_sm) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, blend_forward_kernel,
                                                            kThreads, 0);
}
