// Kernel K4': the backward of the row-factorized lift-splat (kernel K4).
//
// For the gradient g [M, n_cells, C] of the splat's output, with
// G[m, d, w, :] = g[m, cell(m, d, w), :] (zero for the trash cell n_cells):
//
//   d depth[m, d, h, w] = zvalid[m, d, h, w] * sum_c ctx[m, h, w, c] * G[m, d, w, c]
//   d ctx[m, h, w, c]   = sum_d zvalid[m, d, h, w] * depth[m, d, h, w] * G[m, d, w, c]
//
// Replaces the JAX package's autodiff of its device formulation
// mm_training_tpu/ops/voxel_pooling.py::lift_splat_factorized (:127-169):
// the segment-sum's transpose (a gather of g by cell, zero for the trash
// cell that the forward drops) and the two transposes of the fp32 einsum
// over the image rows. The JAX package has no TPU kernel here; XLA
// differentiates its formulation.
//
// Bound: device-memory bytes (depth and zvalid read once, d depth written
// once, ctx, d ctx and the gathered g rows once a column: ~130 MB at the
// B=4 train step in bf16); the two contractions are 2 x 2 x M*D*fH*fW*C,
// 7.4 GFLOP at B=4, which this first kernel runs as fp32 FMAs on the CUDA
// cores, not the tensor cores.
//
// One launch a call, no atomics, deterministic: a block owns one image
// column (m, w) of one camera and walks the depth bins in tiles of kBD.
//   * It keeps the column's ctx [fH][C] in shared memory (fp32) for the
//     whole walk, and its d ctx [fH][C] in registers (4 rows x 8 channels a
//     thread); every d ctx element is written once, at the end.
//   * Per tile it gathers the kBD rows of g the tile's cells point at (the
//     trash cell reads as zero) and the masked depth [kBD][fH] and zvalid
//     (reading along whichever of bins and rows is innermost in memory),
//     then computes the tile's d depth [kBD][fH] (G ctx^T, 2 x 4 outputs a
//     thread, staged in shared memory and written along the innermost
//     dimension) and adds masked^T G into the d ctx registers.
// Sums are fp32 in a fixed order (bins in order for d ctx, channels in order
// for d depth), rounded once to the output's dtype: no bf16 accumulation.
// The wrapper passes every tensor's strides (elements); nothing is copied.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBD = 32;          // depth bins a tile
constexpr int kMaxH = 64;        // fH up to 64
constexpr int kMaxC = 128;       // C up to 128
constexpr int kCS = kMaxC + 1;   // a ctx / g row's stride in shared memory (odd: no conflicts)
constexpr int kHS = kMaxH + 1;   // a (bin) row's stride of the depth tiles

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Params {
  const void* g;
  long long sgm, sgg, sgc;               // g [M, n_cells, C] strides
  const void* depth;
  long long sdm, sdd, sdh, sdw;          // depth [M, D, fH, fW] strides
  const void* ctx;
  long long scm, sch, scw, scc;          // ctx [M, fH, fW, C] strides
  const int* idx;                        // [M, D, fW] contiguous
  const bool* zvalid;                    // [M, D, fH, fW] contiguous
  void* d_depth;
  long long sem, sed, seh, sew;          // d depth strides
  void* d_ctx;
  long long sfm, sfh, sfw, sfc;          // d ctx strides
  int m, d_bins, fh, fw, c, n_cells;
};

constexpr size_t kSmemFloats = (size_t)kMaxH * kCS + (size_t)kBD * kCS + 3 * (size_t)kBD * kHS;

template <typename T>
__global__ void __launch_bounds__(kThreads) lift_splat_bwd_kernel(const Params p) {
  extern __shared__ float sm[];
  float* ctx_s = sm;                        // [kMaxH][kCS] ctx of the column, zero padded
  float* g_s = ctx_s + kMaxH * kCS;         // [kBD][kCS] gathered g rows of the tile
  float* dep_s = g_s + kBD * kCS;           // [kBD][kHS] masked depth of the tile
  float* z_s = dep_s + kBD * kHS;           // [kBD][kHS] zvalid (0 or 1)
  float* o_s = z_s + kBD * kHS;             // [kBD][kHS] the tile's d depth, staged
  const int w = blockIdx.x, m = blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int fh = p.fh, c = p.c;
  const T* ctx = static_cast<const T*>(p.ctx) + (int64_t)m * p.scm + (int64_t)w * p.scw;
  const T* depth = static_cast<const T*>(p.depth) + (int64_t)m * p.sdm + (int64_t)w * p.sdw;
  const T* g = static_cast<const T*>(p.g) + (int64_t)m * p.sgm;
  T* d_depth = static_cast<T*>(p.d_depth) + (int64_t)m * p.sem + (int64_t)w * p.sew;
  const int* idx = p.idx + (int64_t)m * p.d_bins * p.fw + w;
  const bool* zv = p.zvalid + (int64_t)m * p.d_bins * fh * p.fw + w;

  for (int e = tid; e < kMaxH * kCS; e += kThreads) {
    const int h = e / kCS, ch = e - h * kCS;
    ctx_s[e] = (h < fh && ch < c) ? to_float(ctx[(int64_t)h * p.sch + (int64_t)ch * p.scc]) : 0.f;
  }
  // the depth tiles are read and d depth written along bins when bins are
  // innermost in memory (the channels-last softmax), else along rows
  const bool bins_fast = p.sdd <= p.sdh;
  const bool out_bins_fast = p.sed <= p.seh;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int d0 = 0; d0 < p.d_bins; d0 += kBD) {
    const int nd = min(kBD, p.d_bins - d0);
    __syncthreads();   // the previous tile's readers are done
    for (int e = tid; e < kBD * c; e += kThreads) {
      const int dd = e / c, ch = e - dd * c;
      const int cell = dd < nd ? __ldg(idx + (int64_t)(d0 + dd) * p.fw) : p.n_cells;
      g_s[dd * kCS + ch] = cell < p.n_cells
          ? to_float(g[(int64_t)cell * p.sgg + (int64_t)ch * p.sgc]) : 0.f;
    }
    for (int e = tid; e < kBD * fh; e += kThreads) {
      const int dd = bins_fast ? e % kBD : e / fh;
      const int h = bins_fast ? e / kBD : e % fh;
      float v = 0.f, z = 0.f;
      if (dd < nd) {
        const int64_t di = d0 + dd;
        if (__ldg(reinterpret_cast<const unsigned char*>(zv) + (di * fh + h) * p.fw)) {
          z = 1.f;
          v = to_float(depth[di * p.sdd + (int64_t)h * p.sdh]);   // masked = depth * 1
        }
      }
      dep_s[dd * kHS + h] = v;
      z_s[dd * kHS + h] = z;
    }
    __syncthreads();

    // d depth of the tile: bins ty, ty + 16; rows tx + 16 b
    float s[2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
    for (int ch = 0; ch < c; ++ch) {
      float gv[2], cv[4];
#pragma unroll
      for (int a = 0; a < 2; ++a) gv[a] = g_s[(ty + 16 * a) * kCS + ch];
#pragma unroll
      for (int b = 0; b < 4; ++b) cv[b] = ctx_s[(tx + 16 * b) * kCS + ch];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) s[a][b] = fmaf(gv[a], cv[b], s[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int dd = ty + 16 * a, h = tx + 16 * b;
        if (h < kMaxH) o_s[dd * kHS + h] = s[a][b] * z_s[dd * kHS + h];
      }

    // d ctx += masked^T G: rows ty + 16 i, channels tx + 16 j
    for (int dd = 0; dd < nd; ++dd) {
      float dv[4], gv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) dv[i] = dep_s[dd * kHS + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) gv[j] = g_s[dd * kCS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(dv[i], gv[j], acc[i][j]);
    }
    __syncthreads();
    for (int e = tid; e < nd * fh; e += kThreads) {
      const int dd = out_bins_fast ? e % nd : e / fh;
      const int h = out_bins_fast ? e / nd : e % fh;
      d_depth[(int64_t)(d0 + dd) * p.sed + (int64_t)h * p.seh] = from_float<T>(o_s[dd * kHS + h]);
    }
  }

  T* d_ctx = static_cast<T*>(p.d_ctx) + (int64_t)m * p.sfm + (int64_t)w * p.sfw;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int h = ty + 16 * i;
    if (h >= fh) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ch = tx + 16 * j;
      if (ch < c) d_ctx[(int64_t)h * p.sfh + (int64_t)ch * p.sfc] = from_float<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const Params& p, cudaStream_t st) {
  const size_t smem = kSmemFloats * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(lift_splat_bwd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  lift_splat_bwd_kernel<T><<<dim3(p.fw, p.m), kThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// g [M, n_cells, C], depth [M, D, fh, fw], ctx [M, fh, fw, C], d_depth like
// depth and d_ctx like ctx, each with its strides (elements; dtype 0 =
// float32, 1 = bfloat16, the same for all five); idx [M, D, fw] int32 in
// [0, n_cells] (n_cells = trash) and zvalid [M, D, fh, fw] bool, both
// contiguous. C up to 128, fh up to 64, M up to 65535. Writes every element
// of d_depth and d_ctx once. Returns the cudaError_t.
extern "C" int lift_splat_backward(
    int dtype, const void* g, long long sgm, long long sgg, long long sgc, const void* depth,
    long long sdm, long long sdd, long long sdh, long long sdw, const void* ctx, long long scm,
    long long sch, long long scw, long long scc, const int* idx, const bool* zvalid,
    void* d_depth, long long sem, long long sed, long long seh, long long sew, void* d_ctx,
    long long sfm, long long sfh, long long sfw, long long sfc, int m, int d_bins, int fh,
    int fw, int c, int n_cells, void* stream) {
  if (m == 0 || d_bins == 0 || fh == 0 || fw == 0 || c == 0) return 0;
  if (c > kMaxC || fh > kMaxH || m > 65535 || n_cells < 1) return (int)cudaErrorInvalidValue;
  Params p{g, sgm, sgg, sgc, depth, sdm, sdd, sdh, sdw, ctx, scm, sch, scw, scc, idx, zvalid,
           d_depth, sem, sed, seh, sew, d_ctx, sfm, sfh, sfw, sfc, m, d_bins, fh, fw, c,
           n_cells};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, st);
  if (dtype == 1) return launch<__nv_bfloat16>(p, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
