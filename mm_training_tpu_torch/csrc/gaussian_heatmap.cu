// Kernel K2: gaussian heatmap targets, one block per (sample, map, object).
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
// draws every (sample, class map, object) window of a batch.
//
// Bound: device-memory bytes of the maps written (B x M x H x W fp32, zeroed
// by the caller), plus the operations of the windows actually drawn, which
// for CenterPoint's radii (>= 2 cells) are a small share of the map. Design
// for that: a block touches only its object's clipped window, invalid
// objects exit at once, and windows are combined with atomicMax on the int
// bits of the values (non-negative floats order as their bit patterns).
//
// Rounding follows the JAX order, each step rounded on its own (no FMA
// contraction): sigma = (2r + 1) / 6, den = 2 * (sigma * sigma),
// e = -(dx*dx + dy*dy) / den, g = expf(e). At a centre e = -0 and g = 1.0
// exactly, which the focal loss reads as its positives (target == 1).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void draw_heatmap_kernel(const int* __restrict__ centers,   // [B, K, 2] (x, y)
                                    const int* __restrict__ radii,     // [B, K]
                                    const bool* __restrict__ valid,    // [B, M, K]
                                    float* __restrict__ out,           // [B, M, H, W]
                                    int k, int m, int h, int w) {
  const int obj = blockIdx.x, map = blockIdx.y, b = blockIdx.z;
  if (!valid[((int64_t)b * m + map) * k + obj]) return;
  const int64_t ok = (int64_t)b * k + obj;
  const int cx = centers[2 * ok], cy = centers[2 * ok + 1], r = radii[ok];
  // window [cx - r, cx + r] x [cy - r, cy + r], clipped to the map (64-bit:
  // a radius from a huge box must not wrap)
  const int64_t lx = (int64_t)cx - r, hx = (int64_t)cx + r;
  const int64_t ly = (int64_t)cy - r, hy = (int64_t)cy + r;
  const int64_t x0 = lx < 0 ? 0 : lx, x1 = hx > w - 1 ? w - 1 : hx;
  const int64_t y0 = ly < 0 ? 0 : ly, y1 = hy > h - 1 ? h - 1 : hy;
  if (r < 0 || x0 > x1 || y0 > y1) return;
  const float sigma = __fdiv_rn(__fadd_rn(__fmul_rn(2.f, (float)r), 1.f), 6.f);
  const float den = __fmul_rn(2.f, __fmul_rn(sigma, sigma));
  int* dst = reinterpret_cast<int*>(out + ((int64_t)b * m + map) * h * w);
  const int64_t ww = x1 - x0 + 1;
  const int64_t n = ww * (y1 - y0 + 1);
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
    const int64_t y = y0 + i / ww, x = x0 + i % ww;
    const float dx = (float)(x - cx), dy = (float)(y - cy);
    const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    const float g = expf(__fdiv_rn(-d2, den));
    atomicMax(dst + y * w + x, __float_as_int(g));
  }
}

}  // namespace

// centers [B, K, 2] int32, radii [B, K] int32, valid [B, M, K] bool, out
// [B, M, H, W] float32 zero-filled by the caller. Returns the cudaError_t of
// the launch.
extern "C" int draw_heatmap(const int* centers, const int* radii, const bool* valid,
                            float* out, int b, int k, int m, int h, int w, void* stream) {
  if (b == 0 || k == 0 || m == 0) return 0;
  if (m > 65535 || b > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)k, (unsigned)m, (unsigned)b);
  draw_heatmap_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      centers, radii, valid, out, k, m, h, w);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
