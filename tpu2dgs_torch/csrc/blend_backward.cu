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
// What bounds it on an H100: operations. A (record, pixel) pair costs about
// 70 f32 operations for the response and, where the pixel blended the
// record, about 110 more; the records, out and dout are read once and the
// rows written once, a few MB. Design: one 512-thread block per tile, 4
// pixels per thread (one column, 4 rows) with the walk's carries in
// registers; the 9 dout planes the walk reads lie in shared memory, because
// the register file cannot hold them beside the carries. Records are staged
// 64 at a time. Per record each thread sums its pixels' contributions, a
// warp whose pixels all missed the record skips the rest, the others reduce
// by shuffles in a fixed tree; 16 records' warp partials wait in shared
// memory, are then summed over the 16 warps in warp order and written as 16
// consecutive rows. Every sum has a fixed order, so the output is the same
// from run to run. --fmad=false and IEEE division keep T / (1 - alpha), and
// with it the median test, equal to the plain PyTorch version's.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBY = 16;
constexpr int kBX = 128;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPix = kBY * kBX / kThreads;  // pixel rows per thread
constexpr int kChunk = 64;                  // records staged per step
constexpr int kSub = 16;                    // records per row write-out
constexpr int kRecRead = 22;                // record channels 0:21 and the slot, 21
constexpr int kOutCh = 16;
constexpr int kGrad = 19;                   // gradient channels per row
constexpr int kRow = 20;                    // packed row width
constexpr int kDout = 9;                    // dout planes kept: 0,1,2,4,5,6,7,8,9
constexpr int kPlane = kBY * kBX;

// float32 roundings of tpu2dgs_torch/raster/common.py
constexpr float kAlphaClamp = 0.9900000095367432f;
constexpr float kOneMinusClamp = 0.009999999776482582f;  // 1 - ALPHA_CLAMP
constexpr float kAlphaMin = 0.003921568859368563f;       // 1/255
constexpr float kCutoff2 = 9.0f;
constexpr float kFilterInvSquare = 2.0f;
constexpr float kIntersectNear = 0.20000000298023224f;
constexpr float kMedianT = 0.5f;
constexpr float kDistNear = 0.20000000298023224f;
constexpr float kDistFar = 100.0f;
constexpr float kDistSpan = 99.80000305175781f;   // DIST_FAR - DIST_NEAR
constexpr float kDmDd = 0.20040079951286316f;     // DIST_FAR * DIST_NEAR / span

constexpr size_t kSmemBytes =
    sizeof(float) * (kDout * kPlane + kRecRead * kChunk + kSub * kWarps * kGrad);

__global__ void __launch_bounds__(kThreads, 1)
blend_backward_kernel(const float* __restrict__ rec3, const int* __restrict__ counts,
                      const int* __restrict__ offs, const float* __restrict__ out,
                      const float* __restrict__ dout, float* __restrict__ dpack,
                      int nch, int capk, int nty, int group, int pack_cap) {
  extern __shared__ float smem[];
  float* sdout = smem;                                  // [kDout][kPlane]
  float (*srec)[kChunk] = reinterpret_cast<float (*)[kChunk]>(smem + kDout * kPlane);
  float* spart = smem + kDout * kPlane + kRecRead * kChunk;  // [kSub][kWarps][kGrad]
  __shared__ int s_max_last;

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int lx = tid % kBX;
  const int ly0 = (tid / kBX) * kPix;
  const float px = (float)((t / nty) * kBX) + (float)lx;

  const float* o = out + (size_t)t * kOutCh * kPlane;
  const float* d = dout + (size_t)t * kOutCh * kPlane;

  if (tid == 0) s_max_last = -1;
  __syncthreads();

  // Per-pixel carries of the walk and the forward's finals.
  float py[kPix], T_cur[kPix], acc_w[kPix], s_w[kPix], s_wm[kPix], acc_a[kPix],
      s_wm2[kPix], m1f[kPix], m2f[kPix], last[kPix], dt_term[kPix];
  bool med_done[kPix];
  int my_last = -1;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int pix = (ly0 + k) * kBX + lx;
    py[k] = (float)((t % nty) * kBY) + (float)(ly0 + k);
    T_cur[k] = o[3 * kPlane + pix];
    m1f[k] = o[10 * kPlane + pix];
    m2f[k] = o[11 * kPlane + pix];
    last[k] = o[12 * kPlane + pix];
    dt_term[k] = d[3 * kPlane + pix] * T_cur[k];
    acc_w[k] = s_w[k] = s_wm[k] = acc_a[k] = s_wm2[k] = 0.0f;
    med_done[k] = false;
    my_last = max(my_last, (int)last[k]);
    // dout channel 3 (T_final) went into dt_term; the walk reads the rest.
#pragma unroll
    for (int c = 0; c < kDout; ++c)
      sdout[c * kPlane + pix] = d[(c < 3 ? c : c + 1) * kPlane + pix];
  }
  atomicMax(&s_max_last, my_last);
  __syncthreads();

  const int max_last = s_max_last;
  const int count = min(counts[t], capk);
  const int off = offs[t];
  const int start_chunk = max_last < 0 ? 0 : max_last / kChunk + 1;
  // Group-aligned effective count: the rows this tile reserved.
  const int walked_rows = max_last < 0 ? 0 : (max_last / group + 1) * group;
  const int eff = min((count + group - 1) / group * group, walked_rows);

  // Reserved rows above the walked chunks: zeros.
  for (int i = start_chunk * kChunk * kRow + tid; i < eff * kRow; i += kThreads) {
    const int j = i / kRow;
    if (off + (j / group) * group + group <= pack_cap) dpack[(size_t)off * kRow + i] = 0.0f;
  }

  const float* rec = rec3 + (size_t)t * nch * capk;
  for (int c = start_chunk - 1; c >= 0; --c) {
    const int c0 = c * kChunk;
    __syncthreads();  // the previous chunk's readers are done with srec
    for (int i = tid; i < kRecRead * kChunk; i += kThreads) {
      const int ch = i / kChunk;
      const int j = c0 + i % kChunk;
      srec[ch][i % kChunk] = j < count ? rec[(size_t)ch * capk + j] : 0.0f;
    }
    __syncthreads();

    for (int sub = kChunk / kSub - 1; sub >= 0; --sub) {
      for (int kk = kSub - 1; kk >= 0; --kk) {
        const int k_rec = sub * kSub + kk;
        const int jj = c0 + k_rec;
        const float fj = (float)jj;
        const float r0 = srec[0][k_rec], r1 = srec[1][k_rec], r2 = srec[2][k_rec];
        const float r3 = srec[3][k_rec], r4 = srec[4][k_rec], r5 = srec[5][k_rec];
        const float r6 = srec[6][k_rec], r7 = srec[7][k_rec], r8 = srec[8][k_rec];
        const float r9 = srec[9][k_rec], r10 = srec[10][k_rec], r11 = srec[11][k_rec];
        const float r18 = srec[18][k_rec];
        const float r19 = srec[19][k_rec], r20 = srec[20][k_rec];

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
          // _splat_response, as the forward kernel computes it
          const float pu = px * r0 + y * r3 + r6;
          const float pv = px * r1 + y * r4 + r7;
          const float pw = px * r2 + y * r5 + r8;
          const bool valid = pw != 0.0f;
          const float inv = valid ? 1.0f / pw : 0.0f;
          const float su = pu * inv;
          const float sv = pv * inv;
          const float rho3d = su * su + sv * sv;
          const float dx = px - r19;
          const float dy = y - r20;
          const float rho2d = kFilterInvSquare * (dx * dx + dy * dy);
          const bool use3d = rho3d <= rho2d;
          const float rho = use3d ? rho3d : rho2d;
          const bool inside = (rho3d <= kCutoff2) | (rho2d <= rho3d);
          const float depthp = su * r9 + sv * r10 + r11;
          const float G = expf(-0.5f * rho);
          const float raw = r18 * G;
          const bool nc = raw < kAlphaClamp;
          const float alpha = isnan(raw) ? raw : (nc ? raw : kAlphaClamp);
          const bool hit = valid & inside & (depthp >= kIntersectNear) & (alpha >= kAlphaMin);
          const bool blended = hit & (fj <= last[k]) & (jj < count);
          if (!blended) continue;
          any = true;

          const int pix = (ly0 + k) * kBX + lx;
          const float d_r = sdout[0 * kPlane + pix], d_g = sdout[1 * kPlane + pix];
          const float d_b = sdout[2 * kPlane + pix], d_dep = sdout[3 * kPlane + pix];
          const float d_n0 = sdout[4 * kPlane + pix], d_n1 = sdout[5 * kPlane + pix];
          const float d_n2 = sdout[6 * kPlane + pix], d_med = sdout[7 * kPlane + pix];
          const float d_dist = sdout[8 * kPlane + pix];
          const float c_r = srec[12][k_rec], c_g = srec[13][k_rec], c_b = srec[14][k_rec];
          const float n0 = srec[15][k_rec], n1 = srec[16][k_rec], n2 = srec[17][k_rec];

          const float a = alpha;
          const float t_before = T_cur[k] / (1.0f - a);
          const float w = a * t_before;
          const float safe = isnan(depthp) ? depthp : fmaxf(depthp, 1e-6f);
          const float m = kDistFar * (safe - kDistNear) / (kDistSpan * safe);
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
          const float d_a = dldw * t_before + (acc_a[k] - acc_w[k] - dt_term[k]) / one_minus;

          acc_w[k] = acc_w[k] + dldw * w;
          acc_a[k] = acc_a[k] + d_dist * w * m * m * t_before;
          s_w[k] = s_w[k] + w;
          s_wm[k] = s_wm[k] + wm;
          s_wm2[k] = s_wm2[k] + wm2;
          T_cur[k] = t_before;

          const float d_op = nc ? G * d_a : 0.0f;
          const float d_rho = nc ? -0.5f * r18 * G * d_a : 0.0f;
          const float d_rho3d = use3d ? d_rho : 0.0f;
          const float d_su = 2.0f * su * d_rho3d + r9 * d_d;
          const float d_sv = 2.0f * sv * d_rho3d + r10 * d_d;
          const float d_pu = d_su * inv;
          const float d_pv = d_sv * inv;
          const float d_pw = -(su * d_su + sv * d_sv) * inv;

          s_pu += d_pu;
          s_pv += d_pv;
          s_pw += d_pw;
          acc[0] += y * d_pu;
          acc[1] += y * d_pv;
          acc[2] += y * d_pw;
          acc[3] += su * d_d;
          acc[4] += sv * d_d;
          acc[5] += d_d;
          acc[6] += w * d_r;
          acc[7] += w * d_g;
          acc[8] += w * d_b;
          acc[9] += w * d_n0;
          acc[10] += w * d_n1;
          acc[11] += w * d_n2;
          acc[12] += d_op;
        }

        float* part = spart + (kk * kWarps + warp) * kGrad;
        if (__any_sync(0xffffffffu, any)) {
          float v[kGrad] = {px * s_pu, px * s_pv, px * s_pw, acc[0], acc[1], acc[2],
                            s_pu,      s_pv,      s_pw,      acc[3], acc[4], acc[5],
                            acc[6],    acc[7],    acc[8],    acc[9], acc[10], acc[11],
                            acc[12]};
#pragma unroll
          for (int i = 0; i < kGrad; ++i) {
#pragma unroll
            for (int s = 16; s > 0; s >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], s);
          }
          if (lane == 0) {
#pragma unroll
            for (int i = 0; i < kGrad; ++i) part[i] = v[i];
          }
        } else if (lane < kGrad) {
          part[lane] = 0.0f;
        }
      }
      __syncthreads();

      // 16 records x 20 floats: consecutive rows of the packed array.
      if (tid < kSub * kRow) {
        const int kk = tid / kRow;
        const int comp = tid % kRow;
        const int k_rec = sub * kSub + kk;
        const int jj = c0 + k_rec;
        float v;
        if (comp < kGrad) {
          v = 0.0f;
#pragma unroll
          for (int wi = 0; wi < kWarps; ++wi) v += spart[(kk * kWarps + wi) * kGrad + comp];
        } else {
          v = jj < count ? srec[21][k_rec] : 0.0f;
        }
        if (off + (jj / group) * group + group <= pack_cap)
          dpack[(size_t)(off + jj) * kRow + comp] = v;
      }
      __syncthreads();  // spart is rewritten by the next 16 records
    }
  }
}

}  // namespace

// rec3 (tiles, nch, capk) f32 channel-major record lists, nch >= 22;
// counts, offs (tiles,) i32; out, dout (tiles, 16, 16, 128) f32;
// dpack (pack_cap, 20) f32. group = min(256, capk) divides capk, is a
// multiple of 64, and divides every offset and pack_cap.
extern "C" int blend_backward_launch(const float* rec3, const int* counts, const int* offs,
                                     const float* out, const float* dout, float* dpack,
                                     int tiles, int nch, int capk, int nty, int group,
                                     int pack_cap, int device, void* stream) {
  if (nch < kRecRead || nty <= 0 || group <= 0 || group % kChunk != 0 || capk % group != 0 ||
      pack_cap % group != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(blend_backward_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (tiles > 0) {
    blend_backward_kernel<<<tiles, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
        rec3, counts, offs, out, dout, dpack, nch, capk, nty, group, pack_cap);
  }
  return (int)cudaGetLastError();
}
