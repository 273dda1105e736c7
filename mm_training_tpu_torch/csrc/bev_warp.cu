// Kernel K7: the affine BEV warp of the camera BEV (the BEV augmentation).
//
//   dst[b, y, x, :] = bilinear sample of src[b] at minv[b] @ (x, y, 1),
//                     zero outside the map
//
// Replaces the JAX package's device formulation
// mm_training_tpu/ops/warp.py::warp_affine_nhwc (via bda_bev_warp) and its
// _bilinear_sample: the pixel map q @ minv^T with a true homogeneous
// divide, floor, four taps with zero padding, the blend in fp32 and one
// rounding to the map's dtype.
//
// Bound: device-memory bytes (the map read once, the warped map written
// once: 2.6 MB at B=1 for a 32 x 256 x 80 bf16 BEV). One thread per (pixel,
// 16-byte channel vector): a warp's taps read contiguous 16-byte pieces of
// rows. The products and sums are __fmul_rn / __fadd_rn in the JAX order
// (no FMA contraction), as the plain version computes them, so both agree
// bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> tap(const T* src, int64_t b, int yi, int xi, int h,
                                          int w, int c, int j) {
  Pack<T, V> r;
  if (yi >= 0 && yi < h && xi >= 0 && xi < w) {
    r = *reinterpret_cast<const Pack<T, V>*>(src + ((b * h + yi) * w + xi) * c +
                                             (int64_t)j * V);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) r.v[e] = from_float<T>(0.f);
  }
  return r;
}

template <typename T, int V>
__global__ void bev_warp_kernel(const T* __restrict__ src, const float* __restrict__ minv,
                                T* __restrict__ dst, int64_t n_items, int h, int w, int c) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_items) return;
  const int nvec = c / V;
  const int j = (int)(i % nvec);
  const int64_t pix = i / nvec;
  const int64_t hw = (int64_t)h * w;
  const int64_t b = pix / hw;
  const int q = (int)(pix - b * hw);
  const float yf = (float)(q / w), xf = (float)(q - (q / w) * w);
  const float* m = minv + b * 9;
  // p = (x, y, 1) @ minv^T, left to right
  const float p0 = __fadd_rn(__fadd_rn(__fmul_rn(xf, m[0]), __fmul_rn(yf, m[1])), m[2]);
  const float p1 = __fadd_rn(__fadd_rn(__fmul_rn(xf, m[3]), __fmul_rn(yf, m[4])), m[5]);
  const float p2 = __fadd_rn(__fadd_rn(__fmul_rn(xf, m[6]), __fmul_rn(yf, m[7])), m[8]);
  const float sx = __fdiv_rn(p0, p2), sy = __fdiv_rn(p1, p2);
  const float x0 = floorf(sx), y0 = floorf(sy);
  const float wx = __fsub_rn(sx, x0), wy = __fsub_rn(sy, y0);
  const float omx = __fsub_rn(1.f, wx), omy = __fsub_rn(1.f, wy);
  const int x0i = (int)x0, y0i = (int)y0;
  const Pack<T, V> v00 = tap<T, V>(src, b, y0i, x0i, h, w, c, j);
  const Pack<T, V> v01 = tap<T, V>(src, b, y0i, x0i + 1, h, w, c, j);
  const Pack<T, V> v10 = tap<T, V>(src, b, y0i + 1, x0i, h, w, c, j);
  const Pack<T, V> v11 = tap<T, V>(src, b, y0i + 1, x0i + 1, h, w, c, j);
  Pack<T, V> out;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float top = __fadd_rn(__fmul_rn(to_float(v00.v[e]), omx),
                                __fmul_rn(to_float(v01.v[e]), wx));
    const float bot = __fadd_rn(__fmul_rn(to_float(v10.v[e]), omx),
                                __fmul_rn(to_float(v11.v[e]), wx));
    out.v[e] = from_float<T>(__fadd_rn(__fmul_rn(top, omy), __fmul_rn(bot, wy)));
  }
  *reinterpret_cast<Pack<T, V>*>(dst + pix * c + (int64_t)j * V) = out;
}

template <typename T, int V>
void launch(const void* src, const float* minv, void* dst, int64_t pixels, int h, int w, int c,
            cudaStream_t st) {
  const int64_t n_items = pixels * (c / V);
  const int threads = 256;
  bev_warp_kernel<T, V><<<(unsigned)((n_items + threads - 1) / threads), threads, 0, st>>>(
      static_cast<const T*>(src), minv, static_cast<T*>(dst), n_items, h, w, c);
}

}  // namespace

// src, dst [B, H, W, C] (dtype 0 = float32, 1 = bfloat16), minv [B, 3, 3]
// fp32 row-major (dst pixel -> src pixel). vec = 1: src and dst 16-byte
// aligned and C a multiple of 16 bytes' worth. Returns the cudaError_t.
extern "C" int bev_warp(int dtype, const void* src, const float* minv, void* dst, long long b,
                        int h, int w, int c, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t pixels = b * (int64_t)h * w;
  if (pixels == 0 || c == 0) return 0;
  if (dtype == 0) {
    if (vec) launch<float, 4>(src, minv, dst, pixels, h, w, c, st);
    else launch<float, 1>(src, minv, dst, pixels, h, w, c, st);
  } else if (dtype == 1) {
    if (vec) launch<__nv_bfloat16, 8>(src, minv, dst, pixels, h, w, c, st);
    else launch<__nv_bfloat16, 1>(src, minv, dst, pixels, h, w, c, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
