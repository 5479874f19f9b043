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
// What bounds it on an H100: operations. Each (record, pixel) pair costs
// about 90 f32 operations, one expf among them, against 21 record floats
// read per record for 2048 pixels. Design: one 512-thread block per tile, 4 pixels
// per thread with their state in registers; records are staged through
// shared memory 64 at a time (coalesced reads along the channel-major
// capk axis) and read back as broadcasts. After each chunk,
// __syncthreads_or over "any pixel alive" ends the walk once the whole tile
// has saturated; kills are per pixel, so the exit changes work, not
// outputs. expf (not __expf) and --fmad=false keep the arithmetic close to
// the plain PyTorch version's.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBY = 16;
constexpr int kBX = 128;
constexpr int kThreads = 512;
constexpr int kPix = kBY * kBX / kThreads;  // pixel rows per thread
constexpr int kChunk = 64;                  // records staged per step
constexpr int kRecRead = 21;                // record channels 0:21 are read
constexpr int kOutCh = 16;

// float32 roundings of tpu2dgs_torch/raster/common.py
constexpr float kAlphaClamp = 0.9900000095367432f;
constexpr float kAlphaMin = 0.003921568859368563f;  // 1/255
constexpr float kCutoff2 = 9.0f;
constexpr float kFilterInvSquare = 2.0f;
constexpr float kIntersectNear = 0.20000000298023224f;
constexpr float kTEps = 9.999999747378752e-05f;
constexpr float kMedianT = 0.5f;
constexpr float kDistNear = 0.20000000298023224f;
constexpr float kDistFar = 100.0f;
constexpr float kDistSpan = 99.80000305175781f;  // DIST_FAR - DIST_NEAR

struct Pixel {
  float T, r, g, b, dep, n0, n1, n2, med, m1, m2, dist, last;
  bool alive;
};

__global__ void __launch_bounds__(kThreads)
blend_forward_kernel(const float* __restrict__ rec3, const int* __restrict__ counts,
                     float* __restrict__ out, int nch, int capk, int nty) {
  __shared__ float srec[kRecRead][kChunk];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lx = tid % kBX;
  const int ly0 = (tid / kBX) * kPix;
  const float px = (float)((t / nty) * kBX) + (float)lx;
  float py[kPix];
  Pixel s[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    py[k] = (float)((t % nty) * kBY) + (float)(ly0 + k);
    s[k] = Pixel{1.0f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, -1.0f, true};
  }

  const int count = min(counts[t], capk);
  const float* rec = rec3 + (size_t)t * nch * capk;
  for (int c0 = 0; c0 < count; c0 += kChunk) {
    for (int i = tid; i < kRecRead * kChunk; i += kThreads) {
      const int ch = i / kChunk;
      const int j = c0 + i % kChunk;
      srec[ch][i % kChunk] = j < count ? rec[(size_t)ch * capk + j] : 0.0f;
    }
    __syncthreads();
    const int n = min(kChunk, count - c0);
    for (int kk = 0; kk < n; ++kk) {
      float r[kRecRead];
#pragma unroll
      for (int ch = 0; ch < kRecRead; ++ch) r[ch] = srec[ch][kk];
      const float jj = (float)(c0 + kk);
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        Pixel& q = s[k];
        const float y = py[k];
        // _splat_response
        const float pu = px * r[0] + y * r[3] + r[6];
        const float pv = px * r[1] + y * r[4] + r[7];
        const float pw = px * r[2] + y * r[5] + r[8];
        const bool valid = pw != 0.0f;
        const float inv = valid ? 1.0f / pw : 0.0f;
        const float su = pu * inv;
        const float sv = pv * inv;
        const float rho3d = su * su + sv * sv;
        const float dx = px - r[19];
        const float dy = y - r[20];
        const float rho2d = kFilterInvSquare * (dx * dx + dy * dy);
        const float rho = rho3d <= rho2d ? rho3d : rho2d;
        const bool inside = (rho3d <= kCutoff2) | (rho2d <= rho3d);
        const float depthp = su * r[9] + sv * r[10] + r[11];
        const float G = expf(-0.5f * rho);
        const float raw = r[18] * G;
        const float alpha = isnan(raw) ? raw : (raw < kAlphaClamp ? raw : kAlphaClamp);
        const bool hit = valid & inside & (depthp >= kIntersectNear) & (alpha >= kAlphaMin);
        // blend step
        const bool ok = hit & q.alive;
        const float test_t = q.T * (1.0f - alpha);
        const bool kill = ok & (test_t < kTEps);
        if (kill) q.alive = false;
        const float a = (ok & !kill) ? alpha : 0.0f;
        const float w = a * q.T;
        const bool blended = a > 0.0f;
        if (blended & (q.T > kMedianT)) q.med = depthp;
        if (blended) q.last = jj;
        const float safe = isnan(depthp) ? depthp : fmaxf(depthp, 1e-6f);
        const float m = kDistFar * (safe - kDistNear) / (kDistSpan * safe);
        q.dist = q.dist + w * (m * m * (1.0f - q.T) + q.m2 - 2.0f * m * q.m1);
        q.m1 = q.m1 + w * m;
        q.m2 = q.m2 + w * m * m;
        q.T = q.T * (1.0f - a);
        q.r = q.r + w * r[12];
        q.g = q.g + w * r[13];
        q.b = q.b + w * r[14];
        q.dep = q.dep + w * depthp;
        q.n0 = q.n0 + w * r[15];
        q.n1 = q.n1 + w * r[16];
        q.n2 = q.n2 + w * r[17];
      }
    }
    bool any_alive = false;
#pragma unroll
    for (int k = 0; k < kPix; ++k) any_alive |= s[k].alive;
    // Also the barrier before the next chunk overwrites srec.
    if (!__syncthreads_or(any_alive)) break;
  }

  float* o = out + (size_t)t * kOutCh * kBY * kBX;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const Pixel& q = s[k];
    const float vals[kOutCh] = {q.r, q.g, q.b, q.T, q.dep, q.n0, q.n1, q.n2,
                                q.med, q.dist, q.m1, q.m2, q.last, 0.f, 0.f, 0.f};
    const int pix = (ly0 + k) * kBX + lx;
#pragma unroll
    for (int ch = 0; ch < kOutCh; ++ch) o[ch * kBY * kBX + pix] = vals[ch];
  }
}

}  // namespace

// rec3 (tiles, nch, capk) f32 channel-major record lists, nch >= 21;
// counts (tiles,) i32; out (tiles, 16, 16, 128) f32.
extern "C" int blend_forward_launch(const float* rec3, const int* counts, float* out,
                                    int tiles, int nch, int capk, int nty, int device,
                                    void* stream) {
  if (nch < kRecRead || nty <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (tiles > 0) {
    blend_forward_kernel<<<tiles, kThreads, 0, (cudaStream_t)stream>>>(rec3, counts, out,
                                                                      nch, capk, nty);
  }
  return (int)cudaGetLastError();
}
