// Kernel K4: the row-factorized lift-splat of the camera branch.
//
//   A[m, d, w, c] = sum_h depth[m, d, h, w] * zvalid[m, d, h, w] * ctx[m, h, w, c]
//   out[m, g, c]  = sum of A[m, d, w, c] over the (d, w) with idx[m, d, w] == g
//
// Replaces the JAX package's device formulation
// mm_training_tpu/ops/voxel_pooling.py::lift_splat_factorized: an fp32
// einsum over the fH image rows into an [M, D, fW, C] slab, then a
// segment-sum of its M*D*fW rows into n_cells + 1 BEV cells (the last one
// the trash bin, dropped), cast to the compute dtype.
//
// Two launches:
//   1. splat: one block per (camera m, image column w). The block holds
//      ctx[m, :, w, :] (fH x C, fp32) and a tile of the masked depth
//      [D tile, fH] in shared memory; a thread per (d, c) of the tile forms
//      the fp32 sum over h in row order and atomically adds it into the
//      zeroed fp32 accumulator [M, n_cells, C]. Rows bound for the trash bin
//      are skipped. The [M, D, fW, C] slab (42 MB a frame in fp32 at
//      D = 409, fW = 80, C = 80) is never written.
//   2. cast: the accumulator to the compute dtype.
//
// Bound: device-memory bytes (depth, zvalid, ctx and the indices read once,
// the BEV written once: ~25 MB a frame in bf16); the contraction is 0.9
// GFLOP a frame, which the tensor cores would do in about a microsecond.
// This first kernel does it on the fp32 pipes, and reads depth and zvalid
// with a stride of fW elements (each 32-byte sector serves 16 or 32
// neighbouring columns' blocks, from L2). Float atomics add in no fixed
// order: the sums agree with the plain version to fp32 rounding.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDTile = 32;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void splat_kernel(const T* __restrict__ depth, const T* __restrict__ ctx,
                             const int* __restrict__ idx, const bool* __restrict__ zvalid,
                             int d_bins, int fh, int fw, int c, int n_cells,
                             float* __restrict__ acc) {
  extern __shared__ float smem[];
  float* ctx_s = smem;               // [fh][c]
  float* dep_s = smem + fh * c;      // [kDTile][fh]
  const int w = blockIdx.x;
  const int64_t m = blockIdx.y;
  for (int i = threadIdx.x; i < fh * c; i += blockDim.x) {
    const int h = i / c, ch = i - (i / c) * c;
    ctx_s[i] = to_float(ctx[((m * fh + h) * fw + w) * c + ch]);
  }
  for (int d0 = 0; d0 < d_bins; d0 += kDTile) {
    const int nd = min(kDTile, d_bins - d0);
    __syncthreads();                 // ctx_s written / the last tile consumed
    for (int i = threadIdx.x; i < nd * fh; i += blockDim.x) {
      const int dd = i / fh, h = i - (i / fh) * fh;
      const int64_t at = ((m * d_bins + d0 + dd) * fh + h) * fw + w;
      dep_s[i] = zvalid[at] ? to_float(depth[at]) : 0.f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nd * c; i += blockDim.x) {
      const int dd = i / c, ch = i - (i / c) * c;
      const int cell = idx[(m * d_bins + d0 + dd) * fw + w];
      if (cell < 0 || cell >= n_cells) continue;     // the trash bin
      float a = 0.f;
      for (int h = 0; h < fh; ++h) a = fmaf(dep_s[dd * fh + h], ctx_s[h * c + ch], a);
      atomicAdd(acc + (m * n_cells + cell) * c + ch, a);
    }
  }
}

template <typename T>
__global__ void cast_kernel(const float* __restrict__ acc, T* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = from_float<T>(acc[i]);
}

template <typename T>
int launch(const void* depth, const void* ctx, const int* idx, const bool* zvalid, int m,
           int d_bins, int fh, int fw, int c, int n_cells, float* acc, void* out,
           cudaStream_t st) {
  const size_t smem = sizeof(float) * ((size_t)fh * c + (size_t)kDTile * fh);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        splat_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  splat_kernel<T><<<dim3(fw, m), 256, smem, st>>>(
      static_cast<const T*>(depth), static_cast<const T*>(ctx), idx, zvalid, d_bins, fh, fw,
      c, n_cells, acc);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t n = (int64_t)m * n_cells * c;
  const int threads = 256;
  cast_kernel<T><<<(unsigned)((n + threads - 1) / threads), threads, 0, st>>>(
      acc, static_cast<T*>(out), n);
  return (int)cudaGetLastError();
}

}  // namespace

// depth [M, D, fh, fw] and ctx [M, fh, fw, C] (dtype 0 = float32, 1 =
// bfloat16), idx [M, D, fw] int32 in [0, n_cells] (n_cells = trash),
// zvalid [M, D, fh, fw] bool, acc [M, n_cells, C] fp32 zeroed, out
// [M, n_cells, C] of the inputs' dtype. Returns the cudaError_t.
extern "C" int lift_splat(int dtype, const void* depth, const void* ctx, const int* idx,
                          const bool* zvalid, int m, int d_bins, int fh, int fw, int c,
                          int n_cells, float* acc, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m == 0 || fw == 0 || c == 0 || n_cells == 0) return 0;
  if (dtype == 0)
    return launch<float>(depth, ctx, idx, zvalid, m, d_bins, fh, fw, c, n_cells, acc, out, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(depth, ctx, idx, zvalid, m, d_bins, fh, fw, c, n_cells, acc,
                                 out, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
