// Kernel K5: the bilinear sampling of the deformable 3x3 conv (DCNv1, one
// deform group).
//
//   cols[b, p, t, :] = sum over the 4 corners k of x[b, corner_k] * w_k
//
// for pixel p = (y, x), tap t = (ty, tx) of the 3x3 window, at the sampling
// point (y + ty - 1 + dy_t, x + tx - 1 + dx_t) with (dy_t, dx_t) the offsets
// the offset conv predicted. Corners outside the image weigh 0 (against a
// clipped row). The grouped product of the columns with the kernel, the
// cast and the bias stay a batched matrix product in PyTorch
// (models/depth_net.py), as the JAX package leaves its einsum to XLA.
//
// Replaces the JAX package's device formulation
// mm_training_tpu/models/depth_net.py::DeformConv2d.__call__ (:56-90): four
// flat row gathers from the [H*W, C] map, each weighted and added on flat
// rows in the input dtype.
//
// Bound: device-memory bytes. It writes the columns, 9 x the input's bytes
// (130 MB a frame of four 44 x 80 x 512 bf16 maps); the input is read from
// L2 36 times over. Design: one thread per (pixel, tap, 16-byte channel
// vector), so a warp reads and writes contiguous 16-byte pieces of rows;
// the coordinates are recomputed per thread (a few flops against 16 bytes).
// An implicit-GEMM kernel that never writes the columns is later work.
//
// Rounding: as the JAX package and the plain PyTorch version do it, the
// coordinates and corner weights are fp32; each corner weight is rounded to
// the input dtype, each product and each running sum is rounded to the
// input dtype (__fmul_rn / __fadd_rn: no FMA contraction), so kernel and
// plain version agree bit for bit.
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

// v rounded to T's precision, kept as a float
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__global__ void deform_sample_kernel(const T* __restrict__ x, const float* __restrict__ off,
                                     T* __restrict__ cols, int64_t n_items, int h, int w,
                                     int c) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_items) return;
  const int nvec = c / V;
  const int j = (int)(i % nvec);
  const int64_t row = i / nvec;          // (b * H*W + p) * 9 + t
  const int t = (int)(row % 9);
  const int64_t bp = row / 9;            // b * H*W + p
  const int64_t hw = (int64_t)h * w;
  const int64_t b = bp / hw;
  const int p = (int)(bp - b * hw);
  const int py_i = p / w, px_i = p - (p / w) * w;

  // (iota + base tap) + offset, in fp32, in the JAX order
  const float* o = off + bp * 18 + 2 * t;
  const float py = __fadd_rn(__fadd_rn((float)py_i, (float)(t / 3 - 1)), o[0]);
  const float px = __fadd_rn(__fadd_rn((float)px_i, (float)(t % 3 - 1)), o[1]);
  const float y0 = floorf(py), x0 = floorf(px);
  const float wy = __fsub_rn(py, y0), wx = __fsub_rn(px, x0);
  const int y0i = (int)y0, x0i = (int)x0;
  const float omy = __fsub_rn(1.f, wy), omx = __fsub_rn(1.f, wx);
  const float cw[4] = {__fmul_rn(omy, omx), __fmul_rn(omy, wx), __fmul_rn(wy, omx),
                       __fmul_rn(wy, wx)};

  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int yi = y0i + (k >> 1), xi = x0i + (k & 1);
    const bool inb = yi >= 0 && yi < h && xi >= 0 && xi < w;
    const int yc = min(max(yi, 0), h - 1), xc = min(max(xi, 0), w - 1);
    const float cwm = round_to<T>(inb ? cw[k] : 0.f);
    const Pack<T, V> r = *reinterpret_cast<const Pack<T, V>*>(
        x + (b * hw + (int64_t)yc * w + xc) * c + (int64_t)j * V);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float prod = round_to<T>(__fmul_rn(to_float(r.v[e]), cwm));
      acc[e] = round_to<T>(__fadd_rn(acc[e], prod));
    }
  }
  Pack<T, V> out;
#pragma unroll
  for (int e = 0; e < V; ++e) out.v[e] = from_float<T>(acc[e]);
  *reinterpret_cast<Pack<T, V>*>(cols + row * c + (int64_t)j * V) = out;
}

template <typename T, int V>
void launch(const void* x, const float* off, void* cols, int64_t rows, int h, int w, int c,
            cudaStream_t st) {
  const int64_t n_items = rows * (c / V);
  const int threads = 256;
  deform_sample_kernel<T, V><<<(unsigned)((n_items + threads - 1) / threads), threads, 0, st>>>(
      static_cast<const T*>(x), off, static_cast<T*>(cols), n_items, h, w, c);
}

}  // namespace

// x [B, H, W, C] (dtype 0 = float32, 1 = bfloat16), off [B, H, W, 18] fp32
// (dy, dx per tap), cols [B, H*W, 9, C] of x's dtype. vec = 1: x and cols
// are 16-byte aligned and C is a multiple of 16 bytes' worth of elements.
// Returns the cudaError_t of the launch.
extern "C" int deform_sample(int dtype, const void* x, const float* off, void* cols,
                             long long b, int h, int w, int c, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t rows = b * (int64_t)h * w * 9;
  if (rows == 0 || c == 0) return 0;
  if (dtype == 0) {
    if (vec) launch<float, 4>(x, off, cols, rows, h, w, c, st);
    else launch<float, 1>(x, off, cols, rows, h, w, c, st);
  } else if (dtype == 1) {
    if (vec) launch<__nv_bfloat16, 8>(x, off, cols, rows, h, w, c, st);
    else launch<__nv_bfloat16, 1>(x, off, cols, rows, h, w, c, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
