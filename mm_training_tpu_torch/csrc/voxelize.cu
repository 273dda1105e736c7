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
//
// The sparse-input mode (entry sparse_encoder_input, kernel sparse_kernel)
// replaces what mm_training_tpu/models/sparse_encoder.py:136-150 runs in
// front of the sparse-import encoder: voxelize_pillars_dense(...,
// max_points_per_voxel=K, return_count=True) with mmdet3d's first-K cap
// (mm_training_tpu/ops/voxelize.py:81-90, a stable sort by pillar), the
// cast of the mean grid to the compute dtype and the occupancy count > 0.
// It writes the means at full resolution [B, ny, nx, channels] (zeros after
// the features, one rounding) and the occupancy, one byte a pillar, in the
// [B, 1, ny, nx] layout of kernel A's mask operand. A pillar keeps its K
// smallest point indices (its first K points in input order), and its mean
// is their sum in ascending input order, in fp32, by one owner: no float
// atomics, so the grid is the same bits on every call. Bound: device-memory
// bytes (the mask, the xyz of each masked-in point, the other features of
// each kept one, the output and the occupancy: ~19 MB a B=1 frame into the
// 256 x 2048 grid at 16 bf16 channels). Per-pillar state is an int32 count
// and an int32 interval offset, not a dense float accumulator. One
// cooperative launch, four phases, three grid barriers:
//   1. each point in the grid takes its pillar's arrival ordinal a from an
//      integer atomicAdd on the pillar's count (one atomic for the lanes of
//      a warp that share a pillar, __match_any_sync), keeps (pillar, a), and
//      the first four arrivals also write their index beside the count;
//   2. a streaming pass over every pillar: its occupancy byte; a zero row
//      for an empty one; a pillar of n > 4 points claims an interval of
//      n - 4 slots and a place in the warp or the block queue (one 64-bit
//      atomicAdd a warp); then a pass over the points: the first arrival of
//      a pillar of n <= 4 points finishes it (the four indices sorted in
//      registers, the first min(n, K) summed in order);
//   3. each point with a >= 4 writes its index into slot a - 4 of its
//      pillar's interval: a CSR by pillar with no sort and no scan; each
//      first arrival sets its pillar's count back to zero, so the scratch
//      is zero for the next call;
//   4. the queued pillars: for K <= 16 a warp each (each lane keeps the 16
//      smallest of its share of the indices in registers, then K rounds of
//      warp-min; pillars of more than 1024 points take a block, whose warps
//      merge the same way), for K > 16 a block each (a pillar of up to 4096
//      points sorted in shared memory; a larger one by a radix select of
//      its K-th index and a walk over the points in input order); the owner
//      sums the kept points' features in ascending index order and writes
//      the row.
// The cost is linear in a pillar's points (n / 32 loads a lane, n / 256 a
// thread in a block), not quadratic.
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

// ----------------------------------------------------------- the sparse-input mode

constexpr int kInline = 4;        // a pillar's first arrivals kept beside its count
constexpr int kLane = 16;         // indices a lane keeps in the warp selection (K <= kLane)
constexpr int kWarpMax = 1024;    // the most points a pillar a warp selects from
constexpr int kSort = 4096;       // the most kept points a block sorts in shared memory
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7fffffff; // pads a list of point indices (all below 2^31 - 1)

struct SparseParams {
  const float* pts;               // [B, P, f_total]
  const bool* mask;               // [B, P]
  long long b, p;
  int f_total, nf;
  float x0, y0, z0, vx, vy, vz;
  int nx, ny, nz;
  int cap;                        // K >= 1
  int channels;                   // output [B, ny, nx, channels]
  int* cnt;                       // [B * ny * nx] zero before a call; the kernel leaves it so
  int* off;                       // [B * ny * nx] interval offsets (pillars of more than 4)
  int4* inl;                      // [B * ny * nx] a pillar's first kInline arrivals
  int2* slot;                     // [B * P] (pillar or -1, arrival ordinal)
  int* idx;                       // [B * P] interval entries
  int4* wlist;                    // warp queue: (pillar, offset, n, 0)
  int4* blist;                    // block queue
  unsigned long long* claim;      // [1] interval slots taken | warp-queue length << 32
  unsigned* nblock;               // [1] block-queue length
  unsigned* barrier;              // [2], zero before the first call
  void* out;
  unsigned char* occ;             // [B, ny, nx]
  unsigned char* kept;            // [B, P] or null
};

// all blocks' shared memory of the sparse kernel (~26 KB)
struct SparseShared {
  int s[kSort];                   // a block's sorted kept indices, or one chunk of them
  float fb[kThreads * kMaxF];     // one chunk's features
  int hist[256];                  // the radix select's digit counts
  int sel[kWarps * kLane];        // each warp's smallest indices
  int wcount[kWarps];
  int scal[3];                    // the smallest candidate, a rank, a digit
  float sum[kMaxF];
};

template <typename T> __device__ __forceinline__ unsigned raw_bits(float v);
template <> __device__ __forceinline__ unsigned raw_bits<float>(float v) {
  return __float_as_uint(v);
}
template <> __device__ __forceinline__ unsigned raw_bits<__nv_bfloat16>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float feature(const float (&sum)[kMaxF], int e, float den, int nf) {
  return e < nf ? sum[e < kMaxF ? e : 0] / den : 0.f;
}

// pillar o's output row: sum[f] / den for f < nf, rounded once to T, then
// zero channels; 16-byte stores when a row is a multiple of 16 bytes
template <typename T>
__device__ void write_row(const SparseParams& p, int64_t o, const float (&sum)[kMaxF],
                          float den) {
  const int rb = p.channels * (int)sizeof(T);
  unsigned char* row = static_cast<unsigned char*>(p.out) + o * rb;
  constexpr int per = 16 / (int)sizeof(T), epw = 4 / (int)sizeof(T);
  if (rb % 16 == 0) {
#pragma unroll
    for (int q = 0; q < kMaxC * (int)sizeof(T) / 16; ++q) {
      if (q * 16 < rb) {
        unsigned w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          w[k] = 0;
#pragma unroll
          for (int j = 0; j < epw; ++j)
            w[k] |= raw_bits<T>(feature(sum, q * per + k * epw + j, den, p.nf)) << (16 * j);
        }
        reinterpret_cast<uint4*>(row)[q] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < kMaxC; ++e)
      if (e < p.channels) reinterpret_cast<T*>(row)[e] = from_float<T>(feature(sum, e, den, p.nf));
  }
}

template <typename T>
__device__ __forceinline__ void zero_row(const SparseParams& p, int64_t o) {
  const int rb = p.channels * (int)sizeof(T);
  unsigned char* row = static_cast<unsigned char*>(p.out) + o * rb;
  if (rb % 16 == 0) {
#pragma unroll
    for (int q = 0; q < kMaxC * (int)sizeof(T) / 16; ++q)
      if (q * 16 < rb) reinterpret_cast<uint4*>(row)[q] = make_uint4(0u, 0u, 0u, 0u);
  } else {
#pragma unroll
    for (int k = 0; k < kMaxC * (int)sizeof(T) / 2; ++k)
      if (2 * k < rb) reinterpret_cast<unsigned short*>(row)[k] = 0;
  }
}

// point i's pillar (batch entry included), or -1: masked out or outside
__device__ __forceinline__ int pillar_of(const SparseParams& p, int64_t i) {
  if (!p.mask[i]) return -1;
  const float* q = p.pts + i * p.f_total;
  // same rounding steps as the JAX version: (q - x0) then / v, then floor
  const float fx = floorf((q[0] - p.x0) / p.vx);
  const float fy = floorf((q[1] - p.y0) / p.vy);
  const float fz = floorf((q[2] - p.z0) / p.vz);
  // compared as floats: also rejects NaN and values beyond the int range
  if (!(fx >= 0.f && fx < (float)p.nx && fy >= 0.f && fy < (float)p.ny && fz >= 0.f &&
        fz < (float)p.nz))
    return -1;
  return (int)((i / p.p) * ((int64_t)p.nx * p.ny) + (int64_t)fy * p.nx + (int64_t)fx);
}

// candidate j of a pillar: its first kInline arrivals, then its interval
__device__ __forceinline__ int candidate(const SparseParams& p, int cell, int off, int j) {
  return j < kInline ? __ldcg(reinterpret_cast<const int*>(p.inl + cell) + j)
                     : __ldcg(p.idx + off + j - kInline);
}

// fn(candidate j) for j = j0, j0 + step, ... < n, four loads in flight
template <typename F>
__device__ __forceinline__ void for_candidates(const SparseParams& p, int cell, int off, int n,
                                               int j0, int step, F fn) {
  int j = j0;
  for (; j + 3 * step < n; j += 4 * step) {
    int v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = candidate(p, cell, off, j + u * step);
#pragma unroll
    for (int u = 0; u < 4; ++u) fn(v[u]);
  }
  for (; j < n; j += step) fn(candidate(p, cell, off, j));
}

// the pillar's kept bytes: 1 for its indices up to the K-th, t
__device__ __forceinline__ void mark_kept(const SparseParams& p, int cell, int off, int n,
                                          int t, int j0, int step) {
  if (p.kept != nullptr)
    for_candidates(p, cell, off, n, j0, step, [&](int v) { p.kept[v] = v <= t; });
}

__device__ __forceinline__ void sort2(int& a, int& b) {
  const int lo = min(a, b);
  b = max(a, b);
  a = lo;
}

// v into the ascending list l of a lane's kLane smallest
__device__ __forceinline__ void lane_insert(int (&l)[kLane], int v) {
#pragma unroll
  for (int j = 0; j < kLane; ++j) sort2(l[j], v);
}

// m <= kLane rounds of warp-min over the lanes' lists: lane r < m gets the
// r-th smallest index of the warp
__device__ __forceinline__ int warp_merge(int (&l)[kLane], int m, int lane) {
  int mine = kNone;
  for (int r = 0; r < m; ++r) {
    const int v = __reduce_min_sync(kFull, l[0]);
    if (l[0] == v) {
#pragma unroll
      for (int j = 0; j < kLane - 1; ++j) l[j] = l[j + 1];
      l[kLane - 1] = kNone;
    }
    if (lane == r) mine = v;
  }
  return mine;
}

// a warp: lane r < m holds the r-th smallest kept index; the features
// summed in ascending index order (shuffled to every lane), the row written
// by lane 0
template <typename T>
__device__ void warp_sum(const SparseParams& p, int cell, int m, int mine, int lane) {
  float x[kMaxF], sum[kMaxF];
#pragma unroll
  for (int f = 0; f < kMaxF; ++f) {
    x[f] = lane < m && f < p.nf ? __ldg(p.pts + (int64_t)mine * p.f_total + f) : 0.f;
    sum[f] = 0.f;
  }
  for (int r = 0; r < m; ++r) {
#pragma unroll
    for (int f = 0; f < kMaxF; ++f)
      if (f < p.nf) sum[f] += __shfl_sync(kFull, x[f], r);
  }
  if (lane == 0) write_row<T>(p, cell, sum, (float)m);
}

// a pillar of up to kWarpMax points and K <= kLane: one warp
template <typename T>
__device__ void warp_pillar(const SparseParams& p, int4 e, int lane) {
  int l[kLane];
#pragma unroll
  for (int j = 0; j < kLane; ++j) l[j] = kNone;
  for_candidates(p, e.x, e.y, e.z, lane, 32, [&](int v) {
    lane_insert(l, v);
    if (p.kept != nullptr) p.kept[v] = 0;
  });
  const int m = min(e.z, p.cap);
  const int mine = warp_merge(l, m, lane);
  __syncwarp();   // every 0 before the kept points' 1
  if (p.kept != nullptr && lane < m) p.kept[mine] = 1;
  warp_sum<T>(p, e.x, m, mine, lane);
}

// a larger pillar and K <= kLane: one block, each warp as warp_pillar over
// its share, then warp 0 merges the warps' smallest
template <typename T>
__device__ void block_select(const SparseParams& p, int4 e, SparseShared& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = min(e.z, p.cap);
  int l[kLane];
#pragma unroll
  for (int j = 0; j < kLane; ++j) l[j] = kNone;
  for_candidates(p, e.x, e.y, e.z, tid, kThreads, [&](int v) {
    lane_insert(l, v);
    if (p.kept != nullptr) p.kept[v] = 0;
  });
  const int mine = warp_merge(l, m, lane);
  if (lane < kLane) sh.sel[warp * kLane + lane] = mine;
  __syncthreads();   // also every 0 before the kept points' 1
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < kLane; ++j) l[j] = kNone;
    for (int k = lane; k < kWarps * kLane; k += 32) lane_insert(l, sh.sel[k]);
    const int top = warp_merge(l, m, lane);
    if (p.kept != nullptr && lane < m) p.kept[top] = 1;
    warp_sum<T>(p, e.x, m, top, lane);
  }
  __syncthreads();
}

// ascending sort of s[0, n2) in shared memory, n2 a power of two
__device__ void block_sort(int* s, int n2) {
  for (int k = 2; k <= n2; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n2; i += kThreads) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const int a = s[i], b = s[ixj];
          if ((a > b) == ((i & k) == 0)) {
            s[i] = b;
            s[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
}

__device__ __forceinline__ int pow2_at_least(int n) {
  return n <= 1 ? 1 : 1 << (32 - __clz(n - 1));
}

// the candidate of rank `rank` (0 = the smallest), by 8-bit digits from the
// top; sh.scal[0] gets the smallest candidate
__device__ int radix_select(const SparseParams& p, int cell, int off, int n, int rank,
                            SparseShared& sh) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int bits = 32 - __clz((int)max(p.b * p.p - 1, 1LL));
  unsigned prefix = 0, pmask = 0;
  if (tid == 0) sh.scal[0] = kNone;
  for (int shift = (bits - 1) / 8 * 8; shift >= 0; shift -= 8) {
    sh.hist[tid] = 0;
    __syncthreads();
    int lo = kNone;
    for_candidates(p, cell, off, n, tid, kThreads, [&](int v) {
      lo = min(lo, v);
      if (((unsigned)v & pmask) == prefix) atomicAdd(&sh.hist[((unsigned)v >> shift) & 255], 1);
    });
    lo = __reduce_min_sync(kFull, lo);
    if (lane == 0) atomicMin(&sh.scal[0], lo);
    __syncthreads();
    if (tid < 32) {   // lane l counts bins [8 l, 8 l + 8)
      int c[8], s = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        c[k] = sh.hist[8 * lane + k];
        s += c[k];
      }
      int inc = s;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, inc, d);
        if (lane >= d) inc += y;
      }
      if (inc - s <= rank && rank < inc) {
        int r = rank - (inc - s), d = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (d == k && r >= c[k]) {
            r -= c[k];
            d = k + 1;
          }
        sh.scal[1] = r;
        sh.scal[2] = 8 * lane + d;
      }
    }
    __syncthreads();
    rank = sh.scal[1];
    prefix |= (unsigned)sh.scal[2] << shift;
    pmask |= 255u << shift;
    __syncthreads();
  }
  return (int)prefix;
}

// one chunk of c kept indices (ascending, in shared memory): the block
// gathers their features, thread f < nf adds feature f in order to acc
__device__ void chunk_sum(const SparseParams& p, const int* list, int c, SparseShared& sh,
                          float& acc) {
  const int tid = threadIdx.x;
  for (int k = tid; k < c * p.nf; k += kThreads)
    sh.fb[k] = __ldg(p.pts + (int64_t)list[k / p.nf] * p.f_total + k % p.nf);
  __syncthreads();
  if (tid < p.nf)
    for (int j = 0; j < c; ++j) acc += sh.fb[j * p.nf + tid];
  __syncthreads();
}

// K > kLane: one block. A pillar of at most kSort points sorted in shared
// memory; a larger one by a radix select of its K-th index and a walk over
// the batch's points in input order from its smallest index to the K-th.
template <typename T>
__device__ void block_general(const SparseParams& p, int4 e, SparseShared& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cell = e.x, off = e.y, n = e.z, m = min(n, p.cap);
  const bool sorted = n <= kSort;
  int t;
  if (sorted) {
    const int n2 = pow2_at_least(n);
    for (int j = tid; j < n2; j += kThreads) sh.s[j] = j < n ? candidate(p, cell, off, j) : kNone;
    __syncthreads();
    block_sort(sh.s, n2);
    t = sh.s[m - 1];
  } else {
    t = radix_select(p, cell, off, n, m - 1, sh);
  }
  mark_kept(p, cell, off, n, t, tid, kThreads);
  float acc = 0.f;
  if (sorted) {
    for (int c0 = 0; c0 < m; c0 += kThreads) chunk_sum(p, sh.s + c0, min(kThreads, m - c0), sh, acc);
  } else {
    const int* cells = reinterpret_cast<const int*>(p.slot);   // (pillar, ordinal) pairs
    for (int64_t base = sh.scal[0]; base <= t; base += kThreads) {
      const int64_t i = base + tid;
      const bool member = i <= t && __ldcg(cells + 2 * i) == cell;
      const unsigned bal = __ballot_sync(kFull, member);
      if (lane == 0) sh.wcount[warp] = __popc(bal);
      __syncthreads();
      int before = 0, c = 0;
      for (int w = 0; w < kWarps; ++w) {
        before += w < warp ? sh.wcount[w] : 0;
        c += sh.wcount[w];
      }
      if (member) sh.s[before + __popc(bal & ((1u << lane) - 1))] = (int)i;
      __syncthreads();
      chunk_sum(p, sh.s, c, sh, acc);
    }
  }
  if (tid < p.nf) sh.sum[tid] = acc;
  __syncthreads();
  if (tid == 0) {
    float sum[kMaxF];
#pragma unroll
    for (int f = 0; f < kMaxF; ++f) sum[f] = f < p.nf ? sh.sum[f] : 0.f;
    write_row<T>(p, cell, sum, (float)m);
  }
  __syncthreads();
}

// a pillar of 1 <= n <= kInline points: one thread, its indices sorted in
// registers, the first min(n, K) summed in order
template <typename T>
__device__ void small_pillar(const SparseParams& p, int cell, int n) {
  const int4 e = __ldcg(p.inl + cell);
  int v[kInline] = {e.x, n > 1 ? e.y : kNone, n > 2 ? e.z : kNone, n > 3 ? e.w : kNone};
  sort2(v[0], v[1]);
  sort2(v[2], v[3]);
  sort2(v[0], v[2]);
  sort2(v[1], v[3]);
  sort2(v[1], v[2]);
  const int m = min(n, p.cap);
  float sum[kMaxF];
#pragma unroll
  for (int f = 0; f < kMaxF; ++f) sum[f] = 0.f;
#pragma unroll
  for (int j = 0; j < kInline; ++j)
    if (j < m) {
      const float* q = p.pts + (int64_t)v[j] * p.f_total;
#pragma unroll
      for (int f = 0; f < kMaxF; ++f)
        if (f < p.nf) sum[f] += __ldg(q + f);
    }
  write_row<T>(p, cell, sum, (float)m);
  if (p.kept != nullptr) {
#pragma unroll
    for (int j = 0; j < kInline; ++j)
      if (j < n) p.kept[v[j]] = j < m;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) sparse_kernel(const SparseParams p) {
  __shared__ SparseShared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t first = (int64_t)blockIdx.x * kThreads + tid;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t n_pts = p.b * p.p, n_cells = p.b * (int64_t)p.nx * p.ny;
  const unsigned below = (1u << lane) - 1;

  // --- 1: count; each point's pillar and arrival ordinal
  if (first == 0) {
    *p.claim = 0ull;
    *p.nblock = 0u;
  }
  for (int64_t base = first - lane; base < n_pts; base += stride) {
    const int64_t i = base + lane;
    const int cell = i < n_pts ? pillar_of(p, i) : -1;
    const unsigned peers = __match_any_sync(kFull, cell);
    const int leader = __ffs(peers) - 1;
    int a = 0;
    if (lane == leader && cell >= 0) a = atomicAdd(p.cnt + cell, __popc(peers));
    a = __shfl_sync(kFull, a, leader) + __popc(peers & below);
    if (i < n_pts) {
      p.slot[i] = make_int2(cell, a);
      if (cell >= 0 && a < kInline) reinterpret_cast<int*>(p.inl + cell)[a] = (int)i;
      if (p.kept != nullptr && cell < 0) p.kept[i] = 0;
    }
  }
  grid_barrier(p.barrier);

  // --- 2: every pillar's occupancy, a zero row for each empty one, an
  // interval and a queue entry for each of more than kInline points; then
  // each pillar of at most kInline points finished by its first arrival's
  // thread (a loop over the points, so that few lanes idle)
  for (int64_t base = first - lane; base < n_cells; base += stride) {
    const int64_t o = base + lane;
    const int n = o < n_cells ? __ldcg(p.cnt + o) : 0;
    if (o < n_cells) {
      p.occ[o] = n > 0;
      if (n == 0) zero_row<T>(p, o);
    }
    const bool big = n > kInline;
    if (__ballot_sync(kFull, big)) {
      const bool to_warp = p.cap <= kLane && n <= kWarpMax;
      const unsigned long long mine =
          big ? ((unsigned long long)to_warp << 32) | (unsigned)(n - kInline) : 0ull;
      unsigned long long inc = mine;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned long long y = __shfl_up_sync(kFull, inc, d);
        if (lane >= d) inc += y;
      }
      unsigned long long start = 0;
      if (lane == 31) start = atomicAdd(p.claim, inc);
      start = __shfl_sync(kFull, start, 31) + inc - mine;
      if (big) {
        const int at = (int)(start & 0xffffffffull);
        p.off[o] = at;
        const int4 e = make_int4((int)o, at, n, 0);
        if (to_warp) p.wlist[start >> 32] = e;
        else p.blist[atomicAdd(p.nblock, 1u)] = e;
      }
    }
  }
  for (int64_t i = first; i < n_pts; i += stride) {
    const int2 sl = __ldcg(p.slot + i);
    if (sl.x >= 0 && sl.y == 0) {
      const int n = __ldcg(p.cnt + sl.x);
      if (n <= kInline) small_pillar<T>(p, sl.x, n);
    }
  }
  grid_barrier(p.barrier);

  // --- 3: each later arrival's index into its pillar's interval; the
  // first arrival sets the count back to zero, so the scratch is zero for
  // the next call
  for (int64_t i = first; i < n_pts; i += stride) {
    const int2 sl = __ldcg(p.slot + i);
    if (sl.x >= 0) {
      if (sl.y >= kInline) p.idx[__ldcg(p.off + sl.x) + sl.y - kInline] = (int)i;
      else if (sl.y == 0) p.cnt[sl.x] = 0;
    }
  }
  grid_barrier(p.barrier);

  // --- 4: the queued pillars: a block each, then a warp each
  const int n_block = (int)__ldcg(p.nblock);
  const int64_t n_warp = (int64_t)(__ldcg(p.claim) >> 32);
  for (int q = blockIdx.x; q < n_block; q += gridDim.x) {
    const int4 e = __ldcg(p.blist + q);
    if (p.cap <= kLane) block_select<T>(p, e, sh);
    else block_general<T>(p, e, sh);
  }
  for (int64_t q = (int64_t)blockIdx.x * kWarps + warp; q < n_warp;
       q += (int64_t)gridDim.x * kWarps)
    warp_pillar<T>(p, __ldcg(p.wlist + q), lane);
}

template <typename T>
int launch_sparse(SparseParams p, cudaStream_t st) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, sparse_kernel<T>, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  occ = min(occ, kBlocksPerSM);
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(sparse_kernel<T>),
                                          dim3(occ * sms), dim3(kThreads), args, 0, st);
}

// int32 words of the sparse mode's scratch, 16-byte aligned pieces: the
// claim words, off, inl, slot, idx and the two queues (a queued pillar holds
// at least five points)
struct SparseLayout {
  long long claim, off, inl, slot, idx, wlist, blist, words;
  SparseLayout(long long b, long long p, long long cells) {
    const long long n = b * p, queue = 4 * (n / (kInline + 1) + 1);
    claim = 0;
    off = claim + 4;
    inl = off + (b * cells + 3) / 4 * 4;
    slot = inl + 4 * b * cells;
    idx = slot + 2 * n;
    wlist = idx + (n + 3) / 4 * 4;
    blist = wlist + queue;
    words = blist + queue;
  }
};

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

// The sparse-input mode's scratch: *words int32 words whose contents are
// free, and *zeroed int32 words that are zero before the first call (every
// call leaves them so): the grid barrier's two, two spare, then the counts.
extern "C" void sparse_encoder_input_workspace(long long b, long long p, int nx, int ny,
                                               long long* words, long long* zeroed) {
  *words = SparseLayout(b, p, (long long)nx * ny).words;
  *zeroed = 4 + b * (long long)nx * ny;
}

// The sparse-input mode. pts [B, P, f_total] fp32, mask [B, P] bool; nf
// features averaged (1..8); cap = K >= 1 (the first K points of a pillar in
// input order); scratch and zeroed as sparse_encoder_input_workspace sizes
// them, 16-byte aligned; out [B, ny, nx, channels] of dtype 0 = float32 or
// 1 = bfloat16, nf <= channels <= 32; occ [B, ny, nx] bytes; kept null or
// [B, P] bytes (1 where the point was averaged). B * ny * nx and B * P below
// 2^31. Returns the cudaError_t.
extern "C" int sparse_encoder_input(const float* pts, const bool* mask, long long b,
                                    long long p, int f_total, int nf, float x0, float y0,
                                    float z0, float vx, float vy, float vz, int nx, int ny,
                                    int nz, int cap, int dtype, int channels, int* scratch,
                                    int* zeroed, void* out, unsigned char* occ,
                                    unsigned char* kept, void* stream) {
  if (nf < 1 || nf > kMaxF || f_total < nf || channels > kMaxC || channels < nf || cap < 1 ||
      b < 0 || p < 0 || nx < 0 || ny < 0 || b * (long long)nx * ny >= (1LL << 31) ||
      b * p >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (b * (long long)nx * ny == 0) return 0;
  const SparseLayout at(b, p, (long long)nx * ny);
  SparseParams prm{pts, mask, b, p, f_total, nf, x0, y0, z0, vx, vy, vz, nx, ny, nz, cap,
                   channels, zeroed + 4, scratch + at.off,
                   reinterpret_cast<int4*>(scratch + at.inl),
                   reinterpret_cast<int2*>(scratch + at.slot), scratch + at.idx,
                   reinterpret_cast<int4*>(scratch + at.wlist),
                   reinterpret_cast<int4*>(scratch + at.blist),
                   reinterpret_cast<unsigned long long*>(scratch + at.claim),
                   reinterpret_cast<unsigned*>(scratch + at.claim + 2),
                   reinterpret_cast<unsigned*>(zeroed), out, occ, kept};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_sparse<float>(prm, st);
  if (dtype == 1) return launch_sparse<__nv_bfloat16>(prm, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
