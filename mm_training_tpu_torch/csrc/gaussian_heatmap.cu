// Kernel K2: gaussian heatmap targets, each map cell written once.
//
//   out[b, m, y, x] = max over valid objects k of
//                     exp(-((x - cx)^2 + (y - cy)^2) / (2 sigma^2)),
//   sigma = (2 r + 1) / 6, drawn only inside the (2r+1)^2 window around the
//   centre, clipped to the map; 0 where no window reaches.
//
// Replaces the JAX package's device formulation
// mm_training_tpu/ops/gaussian.py::draw_heatmap (a lax.scan over chunks of 32
// objects, each chunk rendered over the whole map and max-combined), called
// once per class from models/centerpoint_head.py::get_targets. Here one launch
// draws every (sample, class map) of a batch.
//
// Bound: device-memory bytes of the maps written (B x M x H x W fp32), plus
// the operations of the windows actually drawn, which for CenterPoint's radii
// (>= 2 cells) are a small share of the map. A gather, not a scatter: one
// block per (sample, map, band of kBand = 1024 cells: two rows of a 512-wide
// map). The block stages the sample's object slots in rounds of kChunk = 512
// (any K; every load of a round issued before any is used), keeps those
// that are valid for its map, have r >= 0 and whose clipped window meets
// the band (warp ballot plus a prefix over the warps), and each thread takes
// the max over that list for its 4 cells in registers, then writes them once
// with a 16-byte store. No zero fill, no atomics, no block without work; the
// max is exact, so the result is deterministic. Its time is the latency of
// that one chain.
//
// Rounding follows the JAX order, each step rounded on its own (no FMA
// contraction): sigma = (2r + 1) / 6, den = 2 * (sigma * sigma),
// e = -(dx*dx + dy*dy) / den, g = expf(e). At a centre e = -0 and g = 1.0
// exactly, which the focal loss reads as its positives (target == 1).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 2;                       // object slots a thread stages a round
constexpr int kBand = kThreads * 4;             // cells a block, 4 a thread
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads * kSlots;       // object slots a round

__global__ void __launch_bounds__(kThreads) heatmap_kernel(
    const int* __restrict__ centers,   // [B, K, 2] (x, y)
    const int* __restrict__ radii,     // [B, K]
    const bool* __restrict__ valid,    // [B, M, K]
    float* __restrict__ out,           // [B, M, H, W]
    int k, int m, int h, int w, int64_t bands) {
  __shared__ int s_cx[kChunk], s_cy[kChunk];
  __shared__ int s_x0[kChunk], s_x1[kChunk], s_y0[kChunk], s_y1[kChunk];
  __shared__ float s_den[kChunk];
  __shared__ int s_warp[kSlots][kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t band = blockIdx.x % bands, bm = blockIdx.x / bands, b = bm / m;
  const int64_t hw = (int64_t)h * w, s = band * kBand;
  const int64_t n = hw - s < kBand ? hw - s : kBand;
  const int64_t ylo = s / w, yhi = (s + n - 1) / w;    // rows the band touches

  // this thread's 4 consecutive cells
  const int64_t e = 4 * (int64_t)tid;
  int xs[4], ys[4];
  float acc[4];
  {
    int64_t y = (s + e) / w, x = s + e - y * w;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = e + j < n;
      xs[j] = in ? (int)x : 0;
      ys[j] = in ? (int)y : -1;    // in no window
      acc[j] = 0.f;
      if (++x == w) {
        x = 0;
        ++y;
      }
    }
  }

  for (int k0 = 0; k0 < k; k0 += kChunk) {
    // stage a round of slots, every load issued before any is used; keep
    // the windows that meet the band
    bool vld[kSlots];
    int2 cc[kSlots];
    int rr[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int slot = k0 + j * kThreads + tid;
      const int64_t sl = slot < k ? slot : 0;
      vld[j] = slot < k && valid[bm * k + sl];
      cc[j] = reinterpret_cast<const int2*>(centers)[b * k + sl];
      rr[j] = radii[b * k + sl];
    }
    bool keep[kSlots];
    int x0[kSlots], x1[kSlots], y0[kSlots], y1[kSlots];
    unsigned ballot[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int cx = cc[j].x, cy = cc[j].y, r = rr[j];
      // window [cx - r, cx + r] x [cy - r, cy + r], clipped to the map
      // (64-bit: a radius from a huge box must not wrap)
      const int64_t lx = (int64_t)cx - r, hx = (int64_t)cx + r;
      const int64_t ly = (int64_t)cy - r, hy = (int64_t)cy + r;
      const int64_t wx0 = lx < 0 ? 0 : lx, wx1 = hx > w - 1 ? w - 1 : hx;
      const int64_t wy0 = ly < 0 ? 0 : ly, wy1 = hy > h - 1 ? h - 1 : hy;
      keep[j] = vld[j] && r >= 0 && wx0 <= wx1 && wy0 <= wy1 && wy0 <= yhi && wy1 >= ylo;
      x0[j] = (int)wx0;
      x1[j] = (int)wx1;
      y0[j] = (int)wy0;
      y1[j] = (int)wy1;
      ballot[j] = __ballot_sync(0xffffffffu, keep[j]);
      if (lane == 0) s_warp[j][warp] = __popc(ballot[j]);
    }
    __syncthreads();
    // the list in (slot round, warp, lane) order
    int total = 0;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      int base = total;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) {
        const int c = s_warp[j][i];
        base += i < warp ? c : 0;
        total += c;
      }
      if (keep[j]) {
        const int at = base + __popc(ballot[j] & ((1u << lane) - 1u));
        const float sigma = __fdiv_rn(__fadd_rn(__fmul_rn(2.f, (float)rr[j]), 1.f), 6.f);
        s_cx[at] = cc[j].x;
        s_cy[at] = cc[j].y;
        s_x0[at] = x0[j];
        s_x1[at] = x1[j];
        s_y0[at] = y0[j];
        s_y1[at] = y1[j];
        s_den[at] = __fmul_rn(2.f, __fmul_rn(sigma, sigma));
      }
    }
    __syncthreads();
    for (int o = 0; o < total; ++o) {
      const int ox0 = s_x0[o], ox1 = s_x1[o], oy0 = s_y0[o], oy1 = s_y1[o];
      const int64_t ocx = s_cx[o], ocy = s_cy[o];
      const float oden = s_den[o];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (xs[i] >= ox0 && xs[i] <= ox1 && ys[i] >= oy0 && ys[i] <= oy1) {
          const float dx = (float)(xs[i] - ocx), dy = (float)(ys[i] - ocy);
          const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
          acc[i] = fmaxf(acc[i], expf(__fdiv_rn(-d2, oden)));
        }
      }
    }
    __syncthreads();   // the next chunk reuses the list
  }

  float* dst = out + bm * hw + s;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0 && e + 4 <= n) {
    *reinterpret_cast<float4*>(dst + e) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (e + j < n) dst[e + j] = acc[j];
  }
}

}  // namespace

// centers [B, K, 2] int32, radii [B, K] int32, valid [B, M, K] bool, out
// [B, M, H, W] float32 (every value written). Returns the cudaError_t of
// the launch.
extern "C" int draw_heatmap(const int* centers, const int* radii, const bool* valid,
                            float* out, int b, int k, int m, int h, int w, void* stream) {
  const int64_t hw = (int64_t)h * w;
  if (b == 0 || m == 0 || hw == 0) return 0;
  const int64_t bands = (hw + kBand - 1) / kBand;
  const int64_t blocks = (int64_t)b * m * bands;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  heatmap_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      centers, radii, valid, out, k, m, h, w, bands);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
