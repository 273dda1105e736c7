// Kernel K6: depth labels from the LiDAR, the depth oracle of the lift.
//
// Replaces the JAX package's device formulation
// mm_training_tpu/ops/depth_labels.py::depth_labels_single_cam (vmapped
// over the cameras by depth_labels) and depth_grid_to_onehot: project each
// point into each camera in fp32, keep those with depth > 1 strictly inside
// a 1-pixel border, take the minimum depth in each (H/16, W/16) cell, bin
// it and write the one-hot [cell, D] labels (empty cells -> bin 0).
//
// Three launches, in one call:
//   1. fill: the [M, fH*fW] min-depth grid to 1e5 (the JAX "empty" value);
//   2. project_min: one thread per (camera, point). The projection's dot
//      products are written out in a fixed order with __fmul_rn / __fadd_rn
//      (no FMA), as the plain version computes them, so both give the same
//      bits; the divisions are true divisions; the int casts truncate. A
//      kept point does atomicMin on the int bits of its depth (> 1, so a
//      positive float, whose bits order as its value).
//   3. onehot: one thread per output value, bin = int((g - (d0 - step)) /
//      step), out-of-range -> 0. depth_grid_to_onehot's CUDA path is this
//      launch alone, on a precomputed grid.
//
// Bound: device-memory bytes, the one-hot labels written ([M, fH, fW, D]
// fp32: 23 MB a frame of four 44 x 80 maps at D = 409); the points are read
// once per camera (from L2 after the first) and the grid stays in L2. The
// minimum is exact, so the result does not depend on the atomics' order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void fill_kernel(float* __restrict__ grid, int64_t n, float v) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) grid[i] = v;
}

// r-th row of a row-major 4x4 matrix times (a, b, c, d), left to right
__device__ __forceinline__ float dot4(const float* m, int r, float a, float b, float c,
                                      float d) {
  float s = __fadd_rn(__fmul_rn(a, m[r * 4 + 0]), __fmul_rn(b, m[r * 4 + 1]));
  s = __fadd_rn(s, __fmul_rn(c, m[r * 4 + 2]));
  return __fadd_rn(s, __fmul_rn(d, m[r * 4 + 3]));
}

__global__ void project_min_kernel(const float* __restrict__ pts, const bool* __restrict__ mask,
                                   const float* __restrict__ extr,
                                   const float* __restrict__ intr, int64_t p, int f_total,
                                   int n_cams, int64_t total, int img_h, int img_w, int ds,
                                   int fh, int fw, int* __restrict__ grid_bits) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t m = i / p;              // camera b * N + n
  const int64_t pi = i - m * p;
  const int64_t bi = m / n_cams;
  if (!mask[bi * p + pi]) return;
  const float* q = pts + (bi * p + pi) * f_total;
  const float* e = extr + m * 16;
  const float* k = intr + m * 16;
  const float x = q[0], y = q[1], z = q[2];
  // cam = [x, y, z, 1] @ extrinsic^T; the last term is e[r][3] * 1
  const float c0 = dot4(e, 0, x, y, z, 1.f), c1 = dot4(e, 1, x, y, z, 1.f);
  const float c2 = dot4(e, 2, x, y, z, 1.f), c3 = dot4(e, 3, x, y, z, 1.f);
  const float p0 = dot4(k, 0, c0, c1, c2, c3), p1 = dot4(k, 1, c0, c1, c2, c3);
  const float p2 = dot4(k, 2, c0, c1, c2, c3);
  const float den = (p2 == 0.f) ? 1e-9f : p2;
  const float u = __fdiv_rn(p0, den), v = __fdiv_rn(p1, den);
  // written so that NaN fails every test
  if (!(c2 > 1.f && u > 1.f && u < (float)(img_w - 1) && v > 1.f &&
        v < (float)(img_h - 1)))
    return;
  const int seg = ((int)v / ds) * fw + (int)u / ds;
  if (seg >= fh * fw) return;           // the JAX segment ops drop it too
  atomicMin(grid_bits + m * fh * fw + seg, __float_as_int(c2));
}

__global__ void onehot_kernel(const float* __restrict__ grid, float* __restrict__ out,
                              int64_t n_out, int d, float lo, float step) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  const int64_t cell = i / d;
  float idx = __fdiv_rn(__fsub_rn(grid[cell], lo), step);
  if (!(idx < (float)d && idx >= 0.f)) idx = 0.f;
  out[i] = ((int)idx == (int)(i - cell * d)) ? 1.f : 0.f;
}

int onehot(const float* grid, float* out, long long cells, int d, float lo, float step,
           cudaStream_t st) {
  const int threads = 256;
  const int64_t n_out = cells * (int64_t)d;
  if (n_out > 0)
    onehot_kernel<<<(unsigned)((n_out + threads - 1) / threads), threads, 0, st>>>(
        grid, out, n_out, d, lo, step);
  return (int)cudaGetLastError();
}

}  // namespace

// pts [B, P, f_total] fp32, mask [B, P] bool, extr/intr [B, N, 4, 4] fp32
// (row-major), grid [B*N, fh*fw] fp32 scratch, out [B*N, fh, fw, d] fp32.
// lo = d0 - step. Returns the cudaError_t of the launches.
extern "C" int depth_labels(const float* pts, const bool* mask, const float* extr,
                            const float* intr, long long b, long long p, int f_total,
                            int n_cams, int img_h, int img_w, int ds, int fh, int fw, int d,
                            float lo, float step, float* grid, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const int64_t cells = b * n_cams * (int64_t)fh * fw;
  if (cells == 0) return 0;
  fill_kernel<<<(unsigned)((cells + threads - 1) / threads), threads, 0, st>>>(grid, cells,
                                                                               1e5f);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t total = b * n_cams * p;
  if (total > 0) {
    project_min_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, st>>>(
        pts, mask, extr, intr, p, f_total, n_cams, total, img_h, img_w, ds, fh, fw,
        reinterpret_cast<int*>(grid));
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return onehot(grid, out, cells, d, lo, step, st);
}

// The binning alone, on a precomputed min-depth grid [cells] fp32.
extern "C" int depth_onehot(const float* grid, float* out, long long cells, int d, float lo,
                            float step, void* stream) {
  return onehot(grid, out, cells, d, lo, step, static_cast<cudaStream_t>(stream));
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
