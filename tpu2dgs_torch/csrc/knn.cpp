// Morton-ordered approximate 3-nearest-neighbor mean squared distance.
//
// Native replacement for the reference's simple-knn CUDA extension
// (SURVEY.md §2.11 [RECON]: Morton-code sort + box-based approximate 3-NN,
// used once at init to seed splat scales). The blocked exact KNN in
// model/knn.py is O(N^2) and fine to ~100K points; COLMAP clouds reach
// millions, where this O(N log N) multithreaded pass takes milliseconds.
//
// Algorithm: normalize points into [0, 2^21)^3, interleave to 63-bit Morton
// codes, sort, then for each point scan a +/-WINDOW neighborhood in Morton
// order keeping the 3 smallest squared distances. Morton locality makes the
// window an excellent 3-NN approximation (and the consumer only needs a
// scale estimate: log(sqrt(mean d^2)), clamped).
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline uint64_t expand_bits(uint64_t v) {
  // spread 21 bits to every third bit position
  v &= 0x1fffff;
  v = (v | (v << 32)) & 0x1f00000000ffffULL;
  v = (v | (v << 16)) & 0x1f0000ff0000ffULL;
  v = (v | (v << 8)) & 0x100f00f00f00f00fULL;
  v = (v | (v << 4)) & 0x10c30c30c30c30c3ULL;
  v = (v | (v << 2)) & 0x1249249249249249ULL;
  return v;
}

inline uint64_t morton3(float x, float y, float z) {
  auto q = [](float t) {
    t = t < 0.f ? 0.f : (t > 1.f ? 1.f : t);
    return (uint64_t)(t * 2097151.0f);  // 2^21 - 1
  };
  return expand_bits(q(x)) | (expand_bits(q(y)) << 1) | (expand_bits(q(z)) << 2);
}

struct Best3 {
  float d0 = 1e30f, d1 = 1e30f, d2 = 1e30f;
  int64_t i0 = -1, i1 = -1, i2 = -1;
  inline void add(float d, int64_t id) {
    if (id == i0 || id == i1 || id == i2) return;  // cross-pass dedup
    if (d < d2) {
      if (d < d1) {
        d2 = d1; i2 = i1;
        if (d < d0) { d1 = d0; i1 = i0; d0 = d; i0 = id; }
        else { d1 = d; i1 = id; }
      } else {
        d2 = d; i2 = id;
      }
    }
  }
};

}  // namespace

extern "C" {

// points: (n, 3) float32; out: (n,) float32 mean squared distance to the 3
// approximate nearest neighbors. window: Morton neighborhood half-width
// (the reference's box pass is comparable to ~16). threads <= 0: hardware.
void knn_mean_dist2(const float* points, int64_t n, float* out,
                    int window, int threads) {
  if (n <= 1) {
    for (int64_t i = 0; i < n; ++i) out[i] = 1e-7f;
    return;
  }
  if (window <= 0) window = 16;

  float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
  for (int64_t i = 0; i < n; ++i) {
    for (int k = 0; k < 3; ++k) {
      float v = points[3 * i + k];
      lo[k] = std::min(lo[k], v);
      hi[k] = std::max(hi[k], v);
    }
  }
  float inv[3];
  for (int k = 0; k < 3; ++k) {
    float d = hi[k] - lo[k];
    inv[k] = d > 0.f ? 1.0f / d : 0.f;
  }

  int nthreads = threads > 0 ? threads
                             : (int)std::thread::hardware_concurrency();
  nthreads = std::max(1, std::min(nthreads, 64));

  auto parallel_for = [&](int64_t total, auto&& fn) {
    std::vector<std::thread> pool;
    std::atomic<int64_t> next(0);
    const int64_t grain = std::max<int64_t>(1024, total / (nthreads * 8));
    for (int t = 0; t < nthreads; ++t) {
      pool.emplace_back([&]() {
        while (true) {
          int64_t start = next.fetch_add(grain);
          if (start >= total) break;
          int64_t end = std::min(total, start + grain);
          fn(start, end);
        }
      });
    }
    for (auto& th : pool) th.join();
  };

  std::vector<Best3> best(n);
  std::vector<std::pair<uint64_t, int64_t>> order(n);

  // Two Morton passes with shifted quantization origins: a discontinuity in
  // one curve is usually continuous in the other, so per-point minima over
  // both passes recover neighbors straddling curve jumps.
  const float shifts[2] = {0.0f, 0.5f / 2097151.0f * 65536.0f};
  for (int pass = 0; pass < 2; ++pass) {
    const float sh = shifts[pass];
    parallel_for(n, [&](int64_t s, int64_t e) {
      for (int64_t i = s; i < e; ++i) {
        const float* p = points + 3 * i;
        order[i] = {morton3((p[0] - lo[0]) * inv[0] + sh,
                            (p[1] - lo[1]) * inv[1] + sh,
                            (p[2] - lo[2]) * inv[2] + sh),
                    i};
      }
    });
    std::sort(order.begin(), order.end());

    parallel_for(n, [&](int64_t s, int64_t e) {
      for (int64_t i = s; i < e; ++i) {
        const int64_t pi = order[i].second;
        const float* p = points + 3 * pi;
        Best3& b = best[pi];
        const int64_t j0 = std::max<int64_t>(0, i - window);
        const int64_t j1 = std::min<int64_t>(n - 1, i + window);
        for (int64_t j = j0; j <= j1; ++j) {
          if (j == i) continue;
          const int64_t qi = order[j].second;
          const float* q = points + 3 * qi;
          const float dx = p[0] - q[0], dy = p[1] - q[1], dz = p[2] - q[2];
          b.add(dx * dx + dy * dy + dz * dz, qi);
        }
      }
    });
  }
  parallel_for(n, [&](int64_t s, int64_t e) {
    for (int64_t i = s; i < e; ++i) {
      out[i] = (best[i].d0 + best[i].d1 + best[i].d2) / 3.0f;
    }
  });
}

}  // extern "C"
