// Kernel K1: pillar scatter-mean.
//
// Replaces the JAX package's device formulation
// mm_training_tpu/ops/voxelize.py::voxelize_pillars_dense (one segment-sum
// of [feats * w, w] rows into the dense pillar grid, then sum / max(count, 1)).
//
// Two launches:
//   1. pillar_scatter: one thread per (batch, point). It floor-quantizes the
//      point as voxelize.py does (x, y and the z-range check), and atomically
//      adds the (F+1)-wide fp32 row [feats, 1] into a zeroed [B, G, F+1]
//      accumulator. An invalid point has weight 0: where the JAX version adds
//      its zero row to a dump segment G, this kernel skips it, so the
//      padding does not serialise atomics on one address.
//   2. pillar_mean: one thread per output value, mean = sum / max(count, 1)
//      into [B, ny, nx, F].
//
// Bound: device-memory bytes (points and mask read once, the mean grid
// written once; a few flops per byte). The accumulator adds a zero-fill and
// one read of (F+1)/F x the output's bytes. Float atomics add in no fixed
// order, so sums agree with the plain version to rounding, not bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void pillar_scatter(const float* __restrict__ pts, const bool* __restrict__ mask,
                               int64_t n_points, int64_t p, int f_total, int nf,
                               float x0, float y0, float z0, float vx, float vy, float vz,
                               int nx, int ny, int nz, float* __restrict__ acc) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_points || !mask[i]) return;
  const float* q = pts + i * f_total;
  // same rounding steps as the JAX version: (q - x0) then / v, then floor
  const float fx = floorf((q[0] - x0) / vx);
  const float fy = floorf((q[1] - y0) / vy);
  const float fz = floorf((q[2] - z0) / vz);
  // compared as floats: also rejects NaN and values beyond the int range
  if (!(fx >= 0.f && fx < (float)nx && fy >= 0.f && fy < (float)ny &&
        fz >= 0.f && fz < (float)nz))
    return;
  const int64_t g = (int64_t)nx * ny;
  const int64_t row = (i / p) * g + (int64_t)fy * nx + (int64_t)fx;
  float* a = acc + row * (nf + 1);
  for (int f = 0; f < nf; ++f) atomicAdd(a + f, q[f]);
  atomicAdd(a + nf, 1.f);
}

__global__ void pillar_mean(const float* __restrict__ acc, float* __restrict__ out,
                            int64_t n_out, int nf) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  const int64_t cell = i / nf;
  const float* a = acc + cell * (nf + 1);
  out[i] = a[i - cell * nf] / fmaxf(a[nf], 1.f);
}

}  // namespace

// pts [B, P, f_total] fp32, mask [B, P] bool, acc [B, ny*nx, nf+1] fp32 zeroed,
// out [B, ny, nx, nf] fp32. Returns the cudaError_t of the launches.
extern "C" int pillar_scatter_mean(const float* pts, const bool* mask, long long b,
                                   long long p, int f_total, int nf, float x0, float y0,
                                   float z0, float vx, float vy, float vz, int nx, int ny,
                                   int nz, float* acc, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const int64_t n_points = b * p;
  if (n_points > 0) {
    pillar_scatter<<<(unsigned)((n_points + threads - 1) / threads), threads, 0, st>>>(
        pts, mask, n_points, p, f_total, nf, x0, y0, z0, vx, vy, vz, nx, ny, nz, acc);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t n_out = b * (int64_t)nx * ny * nf;
  if (n_out > 0) {
    pillar_mean<<<(unsigned)((n_out + threads - 1) / threads), threads, 0, st>>>(
        acc, out, n_out, nf);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
