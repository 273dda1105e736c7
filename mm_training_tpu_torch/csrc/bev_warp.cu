// Kernel K7: the affine BEV warp of the camera BEV (the BEV augmentation).
//
//   dst[b, y, x, :] = bilinear sample of src[b] at inv(M[b]) @ (x, y, 1),
//                     zero outside the map
//
// Replaces the JAX package's device formulation
// mm_training_tpu/ops/warp.py::bda_bev_warp and warp_affine_nhwc with its
// _bilinear_sample: the pixel matrix about the centre pixel, its inverse,
// the pixel map q @ minv^T with a true homogeneous divide, floor, four taps
// with zero padding, the blend in fp32 and one rounding to the map's dtype.
//
// One launch a call, from the matrix the caller holds to the warped map:
//   * a general src->dst pixel matrix M [B, 3, 3] (warp_affine_nhwc), or
//   * the BEV augmentation's matrix [B, n, n] (n = 3 or 4, bda_bev_warp):
//     the kernel forms M = [lin | c - lin c; 0 0 1] from its xy block about
//     the centre pixel c = ((W-1)/2, (H-1)/2), in the JAX order
//     t = c - (lin[:, 0] cx + lin[:, 1] cy).
// Thread 0 of each block inverts M in closed form (the adjugate over the
// determinant, ~40 flops and 9 divisions) into shared memory; a block
// covers one batch entry (blockIdx.y), so one inverse serves all of it.
//
// Bound: device-memory bytes (the map read once, the warped map written
// once: 2.6 MB at B=1 for a 32 x 256 x 80 bf16 BEV). One thread per (pixel,
// 16-byte channel vector): a warp's taps read contiguous 16-byte pieces of
// rows. Every product, sum and quotient is __fmul_rn / __fadd_rn /
// __fsub_rn / __fdiv_rn in one fixed order (no FMA contraction), the order
// the plain version's separate torch ops take, so both agree bit for bit.
//
// The backward (bev_warp_backward), kernel K7': the transposed bilinear
// sample, d src[p] = sum over the dst pixels q whose source point falls in
// p's 2 x 2 neighbourhood of w(q -> p) g[q], written as a gather: one
// launch, no fill, no scratch, no atomics. One thread per (src pixel p,
// channel vector). The dst pixels whose sample point lies in [px - 1,
// px + 1) x [py - 1, py + 1) lie in the image of that square under the
// forward pixel matrix M (q = M s); the thread takes the bounding box of
// the image of its four corners (the whole map where a corner's
// homogeneous w is not positive), widened by half a pixel on each side for
// rounding, and walks its dst pixels in row order. For each it recomputes
// the sample point with the forward's own sample_point (the same inverse,
// coordinates, floor and weights, bit for bit), and where p is one of that
// point's four corners it adds the forward's weight on it times g[q], as
// JAX's autodiff of the blend takes it ((g (1 - wy)) (1 - wx) and so on),
// in float32 registers; then it rounds once to the map's dtype. The box
// holds 9-16 candidates under the BEV augmentation's rotations of +-5 deg
// and scales of 0.95-1.05. Every output is written once, its terms summed
// in a fixed order: a second call gives the same bits. The matrix is data:
// it gets no gradient. Bound: device-memory bytes (g read once, the
// gradient written once; g's rows are gathered again from L1 and L2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
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

__device__ __forceinline__ float diff_of_products(float a, float b, float c, float d) {
  return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d));   // a b - c d
}

// m row-major [a b c; d e f; g h i] -> its inverse, row-major: each entry of
// the adjugate over det = (a A + b B) + c C, expanded along the first row
__device__ void inverse3(const float* m, float* inv) {
  float adj[9];
  adj[0] = diff_of_products(m[4], m[8], m[5], m[7]);   // e i - f h
  adj[1] = diff_of_products(m[2], m[7], m[1], m[8]);   // c h - b i
  adj[2] = diff_of_products(m[1], m[5], m[2], m[4]);   // b f - c e
  adj[3] = diff_of_products(m[5], m[6], m[3], m[8]);   // f g - d i
  adj[4] = diff_of_products(m[0], m[8], m[2], m[6]);   // a i - c g
  adj[5] = diff_of_products(m[2], m[3], m[0], m[5]);   // c d - a f
  adj[6] = diff_of_products(m[3], m[7], m[4], m[6]);   // d h - e g
  adj[7] = diff_of_products(m[1], m[6], m[0], m[7]);   // b g - a h
  adj[8] = diff_of_products(m[0], m[4], m[1], m[3]);   // a e - b d
  const float det = __fadd_rn(__fadd_rn(__fmul_rn(m[0], adj[0]), __fmul_rn(m[1], adj[3])),
                              __fmul_rn(m[2], adj[6]));
#pragma unroll
  for (int e = 0; e < 9; ++e) inv[e] = __fdiv_rn(adj[e], det);
}

// the src->dst pixel matrix of batch entry b: mat [B, 3, 3] as it is
// (bda_n = 0), or from the BEV augmentation's [B, n, n] (bda_n = n)
__device__ void pixel_matrix(const float* mat, int bda_n, int64_t b, int h, int w, float* m) {
  if (bda_n == 0) {
    const float* a = mat + b * 9;
#pragma unroll
    for (int e = 0; e < 9; ++e) m[e] = a[e];
    return;
  }
  const float* r = mat + b * bda_n * bda_n;
  const float cx = (float)(w - 1) * 0.5f, cy = (float)(h - 1) * 0.5f;   // exact
  const float l00 = r[0], l01 = r[1], l10 = r[bda_n], l11 = r[bda_n + 1];
  m[0] = l00;
  m[1] = l01;
  m[2] = __fsub_rn(cx, __fadd_rn(__fmul_rn(l00, cx), __fmul_rn(l01, cy)));
  m[3] = l10;
  m[4] = l11;
  m[5] = __fsub_rn(cy, __fadd_rn(__fmul_rn(l10, cx), __fmul_rn(l11, cy)));
  m[6] = 0.f;
  m[7] = 0.f;
  m[8] = 1.f;
}

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> tap(const T* src, int yi, int xi, int h, int w, int c,
                                          int j) {
  Pack<T, V> r;
  if (yi >= 0 && yi < h && xi >= 0 && xi < w) {
    r = *reinterpret_cast<const Pack<T, V>*>(src + ((int64_t)yi * w + xi) * c +
                                             (int64_t)j * V);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) r.v[e] = from_float<T>(0.f);
  }
  return r;
}

// the source point of dst pixel q = y * w + x: (x, y, 1) @ minv^T left to
// right, the homogeneous divide, floor, and the fractional weights
struct SamplePoint {
  int x0i, y0i;
  float wx, wy, omx, omy;
};

__device__ __forceinline__ SamplePoint sample_point(const float* minv, int q, int w) {
  const float yf = (float)(q / w), xf = (float)(q - (q / w) * w);
  const float p0 = __fadd_rn(__fadd_rn(__fmul_rn(xf, minv[0]), __fmul_rn(yf, minv[1])), minv[2]);
  const float p1 = __fadd_rn(__fadd_rn(__fmul_rn(xf, minv[3]), __fmul_rn(yf, minv[4])), minv[5]);
  const float p2 = __fadd_rn(__fadd_rn(__fmul_rn(xf, minv[6]), __fmul_rn(yf, minv[7])), minv[8]);
  const float sx = __fdiv_rn(p0, p2), sy = __fdiv_rn(p1, p2);
  const float x0 = floorf(sx), y0 = floorf(sy);
  SamplePoint s;
  s.wx = __fsub_rn(sx, x0);
  s.wy = __fsub_rn(sy, y0);
  s.omx = __fsub_rn(1.f, s.wx);
  s.omy = __fsub_rn(1.f, s.wy);
  s.x0i = (int)x0;
  s.y0i = (int)y0;
  return s;
}

// thread 0 forms batch entry b's pixel matrix and its inverse in shared memory
__device__ __forceinline__ void block_matrices(const float* mat, int bda_n, int64_t b, int h,
                                               int w, float* m, float* minv) {
  if (threadIdx.x == 0) {
    pixel_matrix(mat, bda_n, b, h, w, m);
    inverse3(m, minv);
  }
  __syncthreads();
}

template <typename T, int V>
__global__ void bev_warp_kernel(const T* __restrict__ src, const float* __restrict__ mat,
                                int bda_n, T* __restrict__ dst, int h, int w, int c) {
  __shared__ float m[9], minv[9];
  const int64_t b = blockIdx.y;
  block_matrices(mat, bda_n, b, h, w, m, minv);

  const int nvec = c / V;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)h * w * nvec) return;
  const int j = (int)(i % nvec);
  const int q = (int)(i / nvec);
  const SamplePoint s = sample_point(minv, q, w);
  const T* img = src + b * h * w * c;
  const Pack<T, V> v00 = tap<T, V>(img, s.y0i, s.x0i, h, w, c, j);
  const Pack<T, V> v01 = tap<T, V>(img, s.y0i, s.x0i + 1, h, w, c, j);
  const Pack<T, V> v10 = tap<T, V>(img, s.y0i + 1, s.x0i, h, w, c, j);
  const Pack<T, V> v11 = tap<T, V>(img, s.y0i + 1, s.x0i + 1, h, w, c, j);
  Pack<T, V> out;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float top = __fadd_rn(__fmul_rn(to_float(v00.v[e]), s.omx),
                                __fmul_rn(to_float(v01.v[e]), s.wx));
    const float bot = __fadd_rn(__fmul_rn(to_float(v10.v[e]), s.omx),
                                __fmul_rn(to_float(v11.v[e]), s.wx));
    out.v[e] = from_float<T>(__fadd_rn(__fmul_rn(top, s.omy), __fmul_rn(bot, s.wy)));
  }
  *reinterpret_cast<Pack<T, V>*>(dst + (b * h * w + q) * c + (int64_t)j * V) = out;
}

template <typename T, int V>
__global__ void bev_warp_bwd_kernel(const T* __restrict__ grad, const float* __restrict__ mat,
                                    int bda_n, T* __restrict__ d_src, int h, int w, int c) {
  __shared__ float m[9], minv[9];
  const int64_t b = blockIdx.y;
  block_matrices(mat, bda_n, b, h, w, m, minv);

  const int nvec = c / V;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)h * w * nvec) return;
  const int j = (int)(i % nvec);
  const int p = (int)(i / nvec);
  const int py = p / w, px = p - py * w;
  // the dst pixels whose sample point can have p as a corner: the box of
  // M [px - 1, px + 1] x [py - 1, py + 1], half a pixel wider each side
  int qx0 = 0, qx1 = w - 1, qy0 = 0, qy1 = h - 1;
  float xlo = CUDART_INF_F, xhi = -CUDART_INF_F, ylo = CUDART_INF_F, yhi = -CUDART_INF_F;
  bool bounded = true;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float cx = (float)(px + ((k & 1) ? 1 : -1)), cy = (float)(py + ((k & 2) ? 1 : -1));
    const float zw = m[6] * cx + m[7] * cy + m[8];
    const float qx = (m[0] * cx + m[1] * cy + m[2]) / zw;
    const float qy = (m[3] * cx + m[4] * cy + m[5]) / zw;
    bounded = bounded && zw > 0.f && isfinite(qx) && isfinite(qy);
    xlo = fminf(xlo, qx);
    xhi = fmaxf(xhi, qx);
    ylo = fminf(ylo, qy);
    yhi = fmaxf(yhi, qy);
  }
  if (bounded) {
    qx0 = (int)fmaxf(ceilf(xlo - 0.5f), 0.f);
    qx1 = (int)fminf(floorf(xhi + 0.5f), (float)(w - 1));
    qy0 = (int)fmaxf(ceilf(ylo - 0.5f), 0.f);
    qy1 = (int)fminf(floorf(yhi + 0.5f), (float)(h - 1));
  }
  const T* g_img = grad + b * h * w * c + (int64_t)j * V;
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
  for (int qy = qy0; qy <= qy1; ++qy) {
    for (int qx = qx0; qx <= qx1; ++qx) {
      const int q = qy * w + qx;
      const SamplePoint s = sample_point(minv, q, w);
      const unsigned dx = (unsigned)px - (unsigned)s.x0i, dy = (unsigned)py - (unsigned)s.y0i;
      if (dx > 1u || dy > 1u) continue;
      // the forward's weight on corner (y0 + dy, x0 + dx), g times the row
      // weight first, as the blend's autodiff takes it
      const float wy = dy ? s.wy : s.omy, wx = dx ? s.wx : s.omx;
      const Pack<T, V> gp = *reinterpret_cast<const Pack<T, V>*>(g_img + (int64_t)q * c);
#pragma unroll
      for (int e = 0; e < V; ++e)
        acc[e] = __fadd_rn(acc[e], __fmul_rn(__fmul_rn(to_float(gp.v[e]), wy), wx));
    }
  }
  Pack<T, V> out;
#pragma unroll
  for (int e = 0; e < V; ++e) out.v[e] = from_float<T>(acc[e]);
  *reinterpret_cast<Pack<T, V>*>(d_src + (b * h * w + p) * c + (int64_t)j * V) = out;
}

template <typename T, int V>
void launch(const void* src, const float* mat, int bda_n, void* dst, int b, int h, int w, int c,
            cudaStream_t st) {
  const int64_t n_items = (int64_t)h * w * (c / V);
  const int threads = 256;
  const dim3 grid((unsigned)((n_items + threads - 1) / threads), (unsigned)b);
  bev_warp_kernel<T, V><<<grid, threads, 0, st>>>(static_cast<const T*>(src), mat, bda_n,
                                                  static_cast<T*>(dst), h, w, c);
}

template <typename T, int V>
void launch_backward(const void* grad, const float* mat, int bda_n, void* d_src, int b, int h,
                     int w, int c, cudaStream_t st) {
  const int64_t n_items = (int64_t)h * w * (c / V);
  const int threads = 256;
  const dim3 grid((unsigned)((n_items + threads - 1) / threads), (unsigned)b);
  bev_warp_bwd_kernel<T, V><<<grid, threads, 0, st>>>(static_cast<const T*>(grad), mat, bda_n,
                                                      static_cast<T*>(d_src), h, w, c);
}

}  // namespace

// src, dst [B, H, W, C] (dtype 0 = float32, 1 = bfloat16). mat: fp32,
// contiguous, [B, 3, 3] src->dst pixel matrices (bda_n = 0) or [B, n, n]
// BEV augmentation matrices (bda_n = n, 3 or 4). vec = 1: src and dst
// 16-byte aligned and C a multiple of 16 bytes' worth. B <= 65535. Returns
// the cudaError_t.
extern "C" int bev_warp(int dtype, const void* src, const float* mat, int bda_n, void* dst, int b,
                        int h, int w, int c, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b == 0 || h == 0 || w == 0 || c == 0) return 0;
  if (b > 65535 || (bda_n != 0 && bda_n != 3 && bda_n != 4)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (vec) launch<float, 4>(src, mat, bda_n, dst, b, h, w, c, st);
    else launch<float, 1>(src, mat, bda_n, dst, b, h, w, c, st);
  } else if (dtype == 1) {
    if (vec) launch<__nv_bfloat16, 8>(src, mat, bda_n, dst, b, h, w, c, st);
    else launch<__nv_bfloat16, 1>(src, mat, bda_n, dst, b, h, w, c, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The gradient of bev_warp for the output gradient grad [B, H, W, C] (the
// map's dtype): d src [B, H, W, C] of the same dtype, each entry written
// once. mat and bda_n as bev_warp takes them; vec = 1: grad and d_src
// 16-byte aligned and C a multiple of 16 bytes' worth. Returns the
// cudaError_t.
extern "C" int bev_warp_backward(int dtype, const void* grad, const float* mat, int bda_n,
                                 void* d_src, int b, int h, int w, int c, int vec,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b == 0 || h == 0 || w == 0 || c == 0) return 0;
  if (b > 65535 || (bda_n != 0 && bda_n != 3 && bda_n != 4)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (vec) launch_backward<float, 4>(grad, mat, bda_n, d_src, b, h, w, c, st);
    else launch_backward<float, 1>(grad, mat, bda_n, d_src, b, h, w, c, st);
  } else if (dtype == 1) {
    if (vec) launch_backward<__nv_bfloat16, 8>(grad, mat, bda_n, d_src, b, h, w, c, st);
    else launch_backward<__nv_bfloat16, 1>(grad, mat, bda_n, d_src, b, h, w, c, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
