// Kernel A': the backward of kernel A over a channels-last tensor.
//
//   z = x * s[c] + t[c] (+ r),  y = act(z),  given g = dL/dy:
//   m = g * [z > 0] (ReLU) or g (identity)
//   dx = m * s[c]   (x's type),   dr = m   (r's type)
//   ds[c] = sum over (N, H, W) of m * x,   dt[c] = sum of m   (float32)
//
// Kernel A replaces the TPU kernel scripts/bn_elementwise_probe.py::
// _pallas_affine, which has no backward kernel: JAX differentiates the XLA
// formulation around it. Training needs one, because every train-mode
// BatchNorm applies its batch statistics through kernel A, so this is the
// gradient of that kernel, reached through a torch.autograd.Function.
//
// Bound: device-memory bytes. It reads g, x and, with a residual, r (the
// mask needs z) and writes dx and, with a residual, dr, at a few operations
// per element. Design for that: 16-byte
// vectors per thread on neighbouring addresses, fp32 math, one rounding at
// each store. z is recomputed with the forward's rounding (__fmul_rn then
// __fadd_rn, no FMA contraction), so the ReLU mask is exactly the forward's.
//
// The per-channel sums are deterministic: each thread owns one channel group
// (VEC channels) and walks rows of the tensor in a fixed order; a block then
// adds its rows' partials in shared memory in a fixed order and writes one
// partial per channel; a second launch adds the blocks' partials in block
// order. The grid depends only on the shape, so two runs give the same bits.
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

// VEC values of T, moved as one 16-byte access when VEC * sizeof(T) == 16
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

constexpr int kMaxBlocks = 1024;
constexpr int kThreads = 256;

// blockDim.x = groups * rows, groups = c / VEC channel groups per pixel.
// part: [gridDim.x, 2, c] float32 (ds partials, then dt partials).
template <typename T, int VEC, bool RES, bool RELU>
__global__ void affine_act_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x,
                                      const T* __restrict__ r, const float* __restrict__ s,
                                      const float* __restrict__ t, T* __restrict__ dx,
                                      T* __restrict__ dr, float* __restrict__ part,
                                      int64_t npix, int c) {
  extern __shared__ float red[];  // [2][rows][c]
  const int groups = c / VEC;
  const int rows = blockDim.x / groups;
  const int lane = threadIdx.x % groups;
  const int row = threadIdx.x / groups;
  const int c0 = lane * VEC;
  float sv[VEC], tv[VEC], ds[VEC], dt[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    sv[j] = s[c0 + j];
    tv[j] = t[c0 + j];
    ds[j] = 0.f;
    dt[j] = 0.f;
  }
  using P = Pack<T, VEC>;
  for (int64_t p = (int64_t)blockIdx.x * rows + row; p < npix;
       p += (int64_t)gridDim.x * rows) {
    const int64_t off = (p * c + c0) / VEC;  // in packs
    const P gv = reinterpret_cast<const P*>(g)[off];
    const P xv = reinterpret_cast<const P*>(x)[off];
    P rv = xv;
    if (RES) rv = reinterpret_cast<const P*>(r)[off];
    P dxv, drv;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float xf = to_float(xv.v[j]);
      float m = to_float(gv.v[j]);
      if (RELU) {
        float z = __fadd_rn(__fmul_rn(xf, sv[j]), tv[j]);
        if (RES) z = __fadd_rn(z, to_float(rv.v[j]));
        m = (z > 0.f) ? m : 0.f;
      }
      dxv.v[j] = from_float<T>(__fmul_rn(m, sv[j]));
      if (RES) drv.v[j] = from_float<T>(m);
      ds[j] = __fadd_rn(ds[j], __fmul_rn(m, xf));
      dt[j] = __fadd_rn(dt[j], m);
    }
    reinterpret_cast<P*>(dx)[off] = dxv;
    if (RES) reinterpret_cast<P*>(dr)[off] = drv;
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    red[row * c + c0 + j] = ds[j];
    red[(rows + row) * c + c0 + j] = dt[j];
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int i = 0; i < rows; ++i) {
      a = __fadd_rn(a, red[i * c + ch]);
      b = __fadd_rn(b, red[(rows + i) * c + ch]);
    }
    part[(int64_t)blockIdx.x * 2 * c + ch] = a;
    part[(int64_t)blockIdx.x * 2 * c + c + ch] = b;
  }
}

// ds[i] (i < c) or dt[i - c]: the sum of the blocks' partials in block order.
__global__ void reduce_partials_kernel(const float* __restrict__ part, int nblocks, int c,
                                       float* __restrict__ ds, float* __restrict__ dt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * c) return;
  float acc = 0.f;
  for (int b = 0; b < nblocks; ++b) acc = __fadd_rn(acc, part[(int64_t)b * 2 * c + i]);
  if (i < c) ds[i] = acc;
  else dt[i - c] = acc;
}

template <typename T, int VEC, bool RES, bool RELU>
int launch(const void* g, const void* x, const void* r, const float* s, const float* t,
           void* dx, void* dr, float* ds, float* dt, float* part, int64_t npix, int c,
           cudaStream_t stream) {
  const int groups = c / VEC;
  const int rows = groups >= kThreads ? 1 : kThreads / groups;
  const int threads = groups * rows;
  int64_t blocks = (npix + rows - 1) / rows;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  const size_t smem = sizeof(float) * 2 * (size_t)rows * c;
  affine_act_bwd_kernel<T, VEC, RES, RELU><<<(unsigned)blocks, threads, smem, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), static_cast<const T*>(r), s, t,
      static_cast<T*>(dx), static_cast<T*>(dr), part, npix, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<(2 * c + 255) / 256, 256, 0, stream>>>(part, (int)blocks, c, ds, dt);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int dispatch(const void* g, const void* x, const void* r, const float* s, const float* t,
             void* dx, void* dr, float* ds, float* dt, float* part, int64_t npix, int c,
             int relu, cudaStream_t st) {
  if (r != nullptr) {
    if (relu) return launch<T, VEC, true, true>(g, x, r, s, t, dx, dr, ds, dt, part, npix, c, st);
    return launch<T, VEC, true, false>(g, x, r, s, t, dx, dr, ds, dt, part, npix, c, st);
  }
  if (relu) return launch<T, VEC, false, true>(g, x, r, s, t, dx, dr, ds, dt, part, npix, c, st);
  return launch<T, VEC, false, false>(g, x, r, s, t, dx, dr, ds, dt, part, npix, c, st);
}

}  // namespace

// The number of blocks the kernel takes for npix pixels of c channels; the
// caller sizes the partials buffer [blocks, 2, c] float32 from it.
extern "C" int affine_act_backward_blocks(int dtype, long long npix, int c, int vector) {
  const int vec = vector ? (dtype == 0 ? 4 : 8) : 1;
  const int groups = c / vec;
  const int rows = groups >= kThreads ? 1 : kThreads / groups;
  long long blocks = (npix + rows - 1) / rows;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return blocks < 1 ? 1 : (int)blocks;
}

// dtype: 0 = float32, 1 = bfloat16. r (and dr) may be null. vector: 1 when
// every pointer is 16-byte aligned and c is a multiple of 16 bytes' worth of
// values (then each thread moves 16-byte packs), 0 for one value a thread.
// c <= 1024. Returns the cudaError_t of the launches.
extern "C" int affine_act_backward(int dtype, const void* g, const void* x, const void* r,
                                   const float* s, const float* t, void* dx, void* dr,
                                   float* ds, float* dt, float* part, long long npix, int c,
                                   int relu, int vector, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c < 1 || c > 1024) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (vector) return dispatch<float, 4>(g, x, r, s, t, dx, dr, ds, dt, part, npix, c, relu, st);
    return dispatch<float, 1>(g, x, r, s, t, dx, dr, ds, dt, part, npix, c, relu, st);
  }
  if (dtype == 1) {
    if (vector)
      return dispatch<__nv_bfloat16, 8>(g, x, r, s, t, dx, dr, ds, dt, part, npix, c, relu, st);
    return dispatch<__nv_bfloat16, 1>(g, x, r, s, t, dx, dr, ds, dt, part, npix, c, relu, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
