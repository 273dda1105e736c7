// Native host-side point-cloud packer.
//
// The reference's only native code is a CUDA scatter kernel; its host data
// path is Python. Here the host side gets this C++ core: the per-frame point
// pipeline
// (lidar+radar concat -> range filter -> timestamp normalization ->
// intensity scaling -> capacity subsample -> BDA rotation -> fixed-shape
// pad + mask) fused into two passes over the data, replacing ~7 separate
// numpy traversals in the loader hot loop
// (dataset/src/data_loader.py:313-337 + aimotive_dataset.py:123-133).
//
// The PyTorch port's copy of mm_training_tpu/data/csrc/pointpack.cpp,
// unchanged in its arithmetic and its RNG (the batches must equal the JAX
// package's byte for byte). Compiled via g++ -O3 -shared -fPIC at first use
// (ops/build.py::load_host); loaded with ctypes (data/native.py).
// All layouts are row-major float32.

#include <algorithm>
#include <cstdint>
#include <cstring>

namespace {

// xorshift128+ — deterministic, seedable, fast; used only for the
// capacity subsample (augmentation randomness, no numpy parity required)
struct Rng {
  uint64_t s0, s1;
  explicit Rng(uint64_t seed) {
    s0 = seed * 0x9E3779B97F4A7C15ULL + 1;
    s1 = (seed ^ 0xDEADBEEFCAFEBABEULL) * 0xBF58476D1CE4E5B9ULL + 1;
    for (int i = 0; i < 8; ++i) next();
  }
  uint64_t next() {
    uint64_t x = s0, y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  // uniform integer in [0, n)
  uint32_t below(uint32_t n) { return static_cast<uint32_t>(next() % n); }
};

}  // namespace

extern "C" {

// Concat radar + lidar rows into the 8-feature layout
//   [x, y, z, is_radar, speed, power, intensity, ts]
// with the x/y range filter applied (data_loader.py:324-337).
// lidar rows: [x, y, z, intensity, ts] (stride >= 5)
// radar rows: [x, y, z, speed, power] (stride >= 5)
// out must hold (n_lidar + n_radar) * 8 floats. Returns rows written.
int concat_filter(const float* lidar, int n_lidar, int lidar_stride,
                  const float* radar, int n_radar, int radar_stride,
                  float x0, float y0, float x1, float y1, float cam_ts,
                  float* out) {
  int m = 0;
  for (int i = 0; i < n_radar; ++i) {
    const float* r = radar + static_cast<int64_t>(i) * radar_stride;
    if (!(r[0] > x0 && r[0] < x1 && r[1] > y0 && r[1] < y1)) continue;
    float* o = out + static_cast<int64_t>(m) * 8;
    o[0] = r[0]; o[1] = r[1]; o[2] = r[2];
    o[3] = 1.0f; o[4] = r[3]; o[5] = r[4];
    o[6] = 0.0f; o[7] = cam_ts;
    ++m;
  }
  for (int i = 0; i < n_lidar; ++i) {
    const float* l = lidar + static_cast<int64_t>(i) * lidar_stride;
    if (!(l[0] > x0 && l[0] < x1 && l[1] > y0 && l[1] < y1)) continue;
    float* o = out + static_cast<int64_t>(m) * 8;
    o[0] = l[0]; o[1] = l[1]; o[2] = l[2];
    o[3] = 0.0f; o[4] = 0.0f; o[5] = 0.0f;
    o[6] = l[3]; o[7] = l[4];
    ++m;
  }
  return m;
}

// Fused finalize: timestamp normalization to [0,1] (data_loader.py:100-103),
// intensity /255 (:313), capacity subsample (:313-322), BDA rotation of xyz
// (aimotive_dataset.py:123-133), fixed-shape pad + mask.
//   pts:   [n, n_feat] rows in the 8-feature (or 5-feature) layout
//   bda:   row-major [3, 3] or nullptr
//   out:   [cap, n_feat] zero-padded output
//   mask:  [cap] uint8 validity
// Returns the number of valid rows; cam_ts_out receives the normalized
// camera timestamp.
int pack_points(float* pts, int n, int n_feat, const float* bda,
                float cam_ts, float* cam_ts_out, float* out, uint8_t* mask,
                int cap, uint64_t seed) {
  const int ts = n_feat - 1;    // timestamp feature
  const int inten = n_feat - 2; // intensity feature
  float tmin = 3.4e38f, tmax = -3.4e38f;
  for (int i = 0; i < n; ++i) {
    float t = pts[static_cast<int64_t>(i) * n_feat + ts];
    tmin = std::min(tmin, t);
    tmax = std::max(tmax, t);
  }
  if (n == 0) { tmin = 0.0f; tmax = 1.0f; }
  float denom = (tmax - tmin);
  if (denom == 0.0f) denom = 1.0f;
  *cam_ts_out = (cam_ts - tmin) / denom;

  // capacity subsample: partial Fisher-Yates over row indices
  int keep = std::min(n, cap);
  Rng rng(seed);
  // write directly into out while walking a virtual shuffled prefix
  // (swap bookkeeping kept small: only when subsampling)
  if (n > cap) {
    for (int i = 0; i < keep; ++i) {
      uint32_t j = i + rng.below(static_cast<uint32_t>(n - i));
      // swap rows i and j in-place in pts
      if (j != static_cast<uint32_t>(i)) {
        float* a = pts + static_cast<int64_t>(i) * n_feat;
        float* b = pts + static_cast<int64_t>(j) * n_feat;
        for (int f = 0; f < n_feat; ++f) std::swap(a[f], b[f]);
      }
    }
  }

  const bool ident = (bda == nullptr);
  for (int i = 0; i < keep; ++i) {
    const float* p = pts + static_cast<int64_t>(i) * n_feat;
    float* o = out + static_cast<int64_t>(i) * n_feat;
    float x = p[0], y = p[1], z = p[2];
    if (!ident) {
      o[0] = bda[0] * x + bda[1] * y + bda[2] * z;
      o[1] = bda[3] * x + bda[4] * y + bda[5] * z;
      o[2] = bda[6] * x + bda[7] * y + bda[8] * z;
    } else {
      o[0] = x; o[1] = y; o[2] = z;
    }
    for (int f = 3; f < n_feat; ++f) o[f] = p[f];
    o[inten] = p[inten] / 255.0f;
    o[ts] = (p[ts] - tmin) / denom;
    mask[i] = 1;
  }
  std::memset(out + static_cast<int64_t>(keep) * n_feat, 0,
              sizeof(float) * n_feat * (cap - keep));
  std::memset(mask + keep, 0, cap - keep);
  return keep;
}

}  // extern "C"
