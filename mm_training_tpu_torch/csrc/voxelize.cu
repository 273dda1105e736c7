// Kernel K1: pillar scatter-mean, written straight into the encoder's input.
//
// Replaces the JAX package's device formulation
// mm_training_tpu/ops/voxelize.py::voxelize_pillars_dense (one segment-sum
// of [feats * w, w] rows into the dense pillar grid, then sum / max(count,
// 1)) together with what mm_training_tpu/models/lidar_encoder.py:54-65 does
// to it before the first conv: the cast to the compute dtype and the 2x2
// space-to-depth of mm_training_tpu/models/resnet.py::space_to_depth_2x2
// (channel groups in (row-offset, col-offset) order, the feature minor).
//
// Bound: device-memory bytes (the mask, the averaged features of the
// masked-in points, the output: ~7.3 MB at a 100k-point B=1 request into
// the 256 x 2048 grid, bf16 space-to-depth out). One cooperative launch a
// call, a persistent grid of co-resident blocks (four an SM: fewer arrivals
// at each grid barrier), three phases with a grid barrier between them:
//   0. zero the per-device fp32 accumulator of rw-float rows (the nf
//      features, the count, zeros to a multiple of 4: 8 floats for nf = 5;
//      16.8 MB at B=1, which stays in the 50 MB L2; 67 MB at B=4). Zeroing
//      each cell as the last phase reads it instead, to skip this pass,
//      was slower at B=4 (PERF.md, section 6);
//   1. each masked-in point inside the grid floor-quantizes as voxelize.py
//      does and adds its row [feats, 1, 0, ...] with rw / 4 16-byte
//      atomicAdds (two for nf = 5) in place of nf + 1 scalar ones; an
//      invalid point is skipped (the JAX version adds its zero row to a dump
//      segment);
//   2. each thread takes one output pixel: the 2x2 quad of cells under it
//      (one cell without space-to-depth), read from L2, each mean = sum /
//      max(count, 1) rounded once to the output dtype, then zeros up to
//      `channels`; a block stages its 256 pixels in shared memory and writes
//      them out as 16-byte stores.
// Float atomics add in no fixed order, so the means agree with the plain
// version to fp32 rounding (then one bf16 rounding), not bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 4;   // the grid: fewer arrivals at each barrier
constexpr int kMaxF = 8;          // features averaged
constexpr int kMaxRow = 12;       // accumulator row: kMaxF + the count, to a multiple of 4
constexpr int kMaxC = 32;         // output channels a pixel

struct Params {
  const float* pts;               // [B, P, f_total]
  const bool* mask;               // [B, P]
  long long b, p;
  int f_total, nf, rw;
  float x0, y0, z0, vx, vy, vz;
  int nx, ny, nz;
  int s2d, channels;              // output [B, ny/2, nx/2, channels] or [B, ny, nx, channels]
  float* acc;                     // [B, ny * nx, rw] float32 scratch
  unsigned* barrier;              // [2], zero before the first call
  void* out;
};

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// All blocks of the (cooperative, co-resident) grid meet here; what any
// block wrote before is visible to every block after.
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned seen = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == seen) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads) pillar_kernel(const Params p) {
  __shared__ __align__(16) unsigned char stage_bytes[kThreads * kMaxC * sizeof(T)];
  T* stage = reinterpret_cast<T*>(stage_bytes);
  const int tid = threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t cells = (int64_t)p.nx * p.ny;

  // --- 0: zero the accumulator
  const int64_t n4 = p.b * cells * p.rw / 4;
  float4* acc4 = reinterpret_cast<float4*>(p.acc);
  for (int64_t i = (int64_t)blockIdx.x * kThreads + tid; i < n4; i += stride)
    acc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  grid_barrier(p.barrier);

  // --- 1: scatter, one row of rw / 4 16-byte adds a point
  for (int64_t i = (int64_t)blockIdx.x * kThreads + tid; i < p.b * p.p; i += stride) {
    if (!p.mask[i]) continue;
    const float* q = p.pts + i * p.f_total;
    // same rounding steps as the JAX version: (q - x0) then / v, then floor
    const float fx = floorf((q[0] - p.x0) / p.vx);
    const float fy = floorf((q[1] - p.y0) / p.vy);
    const float fz = floorf((q[2] - p.z0) / p.vz);
    // compared as floats: also rejects NaN and values beyond the int range
    if (!(fx >= 0.f && fx < (float)p.nx && fy >= 0.f && fy < (float)p.ny && fz >= 0.f &&
          fz < (float)p.nz))
      continue;
    float4* a = reinterpret_cast<float4*>(
        p.acc + ((i / p.p) * cells + (int64_t)fy * p.nx + (int64_t)fx) * p.rw);
    for (int j = 0; j < p.rw / 4; ++j) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = 4 * j + e;
        v[e] = f < p.nf ? q[f] : (f == p.nf ? 1.f : 0.f);
      }
      atomicAdd(a + j, make_float4(v[0], v[1], v[2], v[3]));
    }
  }
  grid_barrier(p.barrier);

  // --- 2: means, one rounding, space-to-depth and zero channels, staged
  // in shared memory a block of pixels at a time
  const int oy_n = p.s2d ? p.ny / 2 : p.ny, ox_n = p.s2d ? p.nx / 2 : p.nx;
  const int64_t n_px = p.b * oy_n * ox_n;
  const int quads = p.s2d ? 4 : 1;
  const int row_bytes = p.channels * (int)sizeof(T);
  for (int64_t base = (int64_t)blockIdx.x * kThreads; base < n_px; base += stride) {
    const int64_t o = base + tid;
    if (o < n_px) {
      const int64_t bi = o / ((int64_t)oy_n * ox_n);
      const int r = (int)(o - bi * oy_n * ox_n);
      const int oy = r / ox_n, ox = r % ox_n;
      T* dst = stage + tid * p.channels;
      for (int qd = 0; qd < quads; ++qd) {
        const int cy = p.s2d ? 2 * oy + (qd >> 1) : oy, cx = p.s2d ? 2 * ox + (qd & 1) : ox;
        // the sums come from L2: read past L1
        const float4* a = reinterpret_cast<const float4*>(
            p.acc + (bi * cells + (int64_t)cy * p.nx + cx) * p.rw);
        float cell[kMaxRow];
#pragma unroll
        for (int j = 0; j < kMaxRow / 4; ++j) {
          const float4 v = 4 * j < p.rw ? __ldcg(a + j) : make_float4(0.f, 0.f, 0.f, 0.f);
          cell[4 * j] = v.x;
          cell[4 * j + 1] = v.y;
          cell[4 * j + 2] = v.z;
          cell[4 * j + 3] = v.w;
        }
        float count = 0.f;
#pragma unroll
        for (int f = 0; f < kMaxRow; ++f)
          if (f == p.nf) count = cell[f];
        const float den = fmaxf(count, 1.f);
#pragma unroll
        for (int f = 0; f < kMaxF; ++f)
          if (f < p.nf) dst[qd * p.nf + f] = from_float<T>(cell[f] / den);
      }
      for (int ch = quads * p.nf; ch < p.channels; ++ch) dst[ch] = from_float<T>(0.f);
    }
    __syncthreads();
    // the block's pixels are consecutive in the output: one contiguous run
    const long long n = min((long long)kThreads, (long long)(n_px - base));
    const int64_t bytes = n * row_bytes;
    unsigned char* out = static_cast<unsigned char*>(p.out) + base * row_bytes;
    const unsigned char* src = reinterpret_cast<const unsigned char*>(stage);
    for (int64_t k = tid; k < bytes / 16; k += kThreads)
      reinterpret_cast<uint4*>(out)[k] = reinterpret_cast<const uint4*>(src)[k];
    for (int64_t k = bytes / 16 * 8 + tid; k < bytes / 2; k += kThreads)
      reinterpret_cast<unsigned short*>(out)[k] = reinterpret_cast<const unsigned short*>(src)[k];
    __syncthreads();
  }
}

template <typename T>
int launch(Params p, cudaStream_t st) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, pillar_kernel<T>, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  occ = min(occ, kBlocksPerSM);
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(pillar_kernel<T>),
                                          dim3(occ * sms), dim3(kThreads), args, 0, st);
}

}  // namespace

// pts [B, P, f_total] fp32, mask [B, P] bool; nf features averaged (1..8);
// acc float32 scratch of B * ny * nx * rw values, rw = nf + 1 rounded up to
// a multiple of 4; barrier two uint32 that are zero before the first call
// (every call leaves them so); out [B, ny/2, nx/2, channels] (s2d = 1, ny
// and nx even, channels >= 4 nf) or [B, ny, nx, channels] (channels >= nf)
// of dtype 0 = float32 or 1 = bfloat16, channels up to 32, contiguous.
// Returns the cudaError_t.
extern "C" int pillar_encoder_input(const float* pts, const bool* mask, long long b,
                                    long long p, int f_total, int nf, float x0, float y0,
                                    float z0, float vx, float vy, float vz, int nx, int ny,
                                    int nz, int dtype, int s2d, int channels, float* acc,
                                    unsigned* barrier, void* out, void* stream) {
  const int rw = (nf + 1 + 3) / 4 * 4;
  if (nf < 1 || nf > kMaxF || f_total < nf || channels > kMaxC ||
      channels < (s2d ? 4 : 1) * nf || (s2d && (nx % 2 || ny % 2)) || b < 0 || p < 0)
    return (int)cudaErrorInvalidValue;
  if (b * (long long)nx * ny == 0) return 0;
  Params prm{pts, mask, b, p, f_total, nf, rw, x0, y0, z0, vx, vy, vz, nx, ny, nz, s2d,
             channels, acc, barrier, out};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(prm, st);
  if (dtype == 1) return launch<__nv_bfloat16>(prm, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
