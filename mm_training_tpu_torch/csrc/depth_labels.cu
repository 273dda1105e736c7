// Kernel K6: depth labels from the LiDAR, the depth oracle of the lift.
//
// Replaces the JAX package's device formulation
// mm_training_tpu/ops/depth_labels.py::depth_labels_single_cam (vmapped
// over the cameras by depth_labels) and depth_grid_to_onehot: project each
// point into each camera in fp32, keep those with depth > 1 strictly inside
// a 1-pixel border, take the minimum depth in each (H/16, W/16) cell, bin
// it and write the one-hot [cell, D] labels (empty cells -> bin 0).
//
// One launch a call, one thread-block cluster a camera (16 CTAs where the
// card schedules them, else 8). The camera's min-depth grid lives in the
// cluster's shared memory, set to 1e5 (the JAX "empty" value) by the CTAs
// themselves, so there is no fill launch and no grid in device memory. Each
// CTA owns a contiguous range of the cells.
//   1. project: each CTA projects its share of the sample's points. The
//      dot products are written out in a fixed order with __fmul_rn /
//      __fadd_rn (no FMA), as the plain version computes them; the
//      divisions are true divisions; the int casts truncate. A kept point
//      does atomicMin on the int bits of its depth in the CTA's own copy
//      of the whole grid (14 KB at 44 x 80 cells).
//   2. after cluster.sync(), each CTA takes the minimum of its own cells
//      over the cluster's copies (distributed shared memory reads, no
//      remote atomics: those cost more than the projection on the card),
//      bins each cell once, bin = int((g - (d0 - step)) / step), out of
//      [0, D) -> 0, and writes its cells' contiguous range of the labels
//      with 16-byte stores (a row of D floats need not be 16-byte aligned:
//      the range is vectorised as a whole, with a scalar head and tail).
// A grid too large for one CTA's shared memory is split over the cluster
// instead, each CTA holding its own cells only, and a kept point does its
// atomicMin in the owner CTA's memory (cluster.map_shared_rank).
// depth_grid_to_onehot's CUDA path is the write phase alone on a
// precomputed grid: no cluster, blocks over chunks of cells.
//
// The minimum is order-free: a kept depth is > 1, a positive float, and
// positive floats order as the int values of their bits, so atomicMin on
// the bits gives the exact minimum whatever order the atomics land in; the
// labels equal the plain version's bit for bit.
//
// Bound: device-memory bytes, the one-hot labels written ([M, fH, fW, D]
// fp32: 23 MB a frame of four 44 x 80 maps at D = 409); the points are read
// once per camera (from L2 after the first camera of a sample).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;        // a CTA of the cluster kernel
constexpr int kOnehotThreads = 256;   // a block of the grid -> labels kernel
constexpr int kChunkCells = 64;       // cells a block bins at a time there
constexpr float kEmpty = 1e5f;

// r-th row of a row-major 4x4 matrix times (a, b, c, d), left to right
__device__ __forceinline__ float dot4(const float* m, int r, float a, float b, float c,
                                      float d) {
  float s = __fadd_rn(__fmul_rn(a, m[r * 4 + 0]), __fmul_rn(b, m[r * 4 + 1]));
  s = __fadd_rn(s, __fmul_rn(c, m[r * 4 + 2]));
  return __fadd_rn(s, __fmul_rn(d, m[r * 4 + 3]));
}

__device__ __forceinline__ int bin_of(float g, int d, float lo, float step) {
  float idx = __fdiv_rn(__fsub_rn(g, lo), step);
  if (!(idx < (float)d && idx >= 0.f)) idx = 0.f;
  return (int)idx;
}

// n / d for 0 <= n < 2^31 and 1 <= d < 2^31: a multiply and a shift
// (Granlund and Montgomery's division by an invariant integer). The
// projection divides by the downsample twice a kept point, and a division
// by a value known only at run time there made the B=1 call slower on an
// H100 (PERF.md, section 6).
struct FastDiv {
  unsigned m, s;
  explicit FastDiv(unsigned d) : m(0), s(0) {
    while ((1ull << s) < d) ++s;
    m = (unsigned)((((1ull << 32) * ((1ull << s) - d)) / d) + 1);
  }
  __device__ __forceinline__ unsigned div(unsigned n) const { return (__umulhi(n, m) + n) >> s; }
};

// The one-hot rows of n cells, whose bins are bins[0, n), to out[g0, g0 +
// n * d); out is 16-byte aligned. kT threads take consecutive 16-byte
// stores; a thread walks (cell, position) forward by kT * 4 floats a step
// (no division in the loop) and finds the ones among its 4 floats from the
// bins of the one or few cells they span.
template <int kT>
__device__ __forceinline__ void write_onehot(float* __restrict__ out, int64_t g0, int n,
                                             int d, const int* __restrict__ bins) {
  const int tid = threadIdx.x;
  const int64_t len = (int64_t)n * d;
  int64_t head = (4 - (g0 & 3)) & 3;
  if (head > len) head = len;
  if (tid < head) {
    const int cell = tid / d;
    out[g0 + tid] = bins[cell] == tid - cell * d ? 1.f : 0.f;
  }
  const int64_t nvec = (len - head) >> 2;
  float4* vec = reinterpret_cast<float4*>(out + g0 + head);
  const int64_t j0 = head + 4 * (int64_t)tid;
  int cell = (int)(j0 / d), pos = (int)(j0 - (int64_t)cell * d);
  const int64_t step = 4LL * kT;
  const int step_cells = (int)(step / d), step_pos = (int)(step - (int64_t)step_cells * d);
  for (int64_t q = tid; q < nvec; q += kT) {
    // cell c's one lies bins[c] - pos floats past the group's first float,
    // cell c + 1's d floats further
    unsigned ones = 0;
    for (int c = cell, off = -pos; off < 4 && c < n; ++c, off += d) {
      const int at = off + bins[c];
      if (at >= 0 && at < 4) ones |= 1u << at;
    }
    vec[q] = make_float4(ones & 1u ? 1.f : 0.f, ones & 2u ? 1.f : 0.f, ones & 4u ? 1.f : 0.f,
                         ones & 8u ? 1.f : 0.f);
    cell += step_cells;
    pos += step_pos;
    if (pos >= d) {
      pos -= d;
      ++cell;
    }
  }
  const int64_t t0 = head + 4 * nvec;
  if (tid < len - t0) {
    const int64_t j = t0 + tid;
    const int64_t c = j / d;
    out[g0 + j] = bins[c] == (int)(j - c * d) ? 1.f : 0.f;
  }
}

struct Params {
  const float* pts;              // [B, P, F]: x, y, z contiguous, strides in floats
  int64_t pts_b, pts_p;
  const bool* mask;              // [B, P] contiguous
  const float* extr;             // [B, N, 4, 4], each 4 x 4 row-major, strides in floats
  int64_t extr_b, extr_n;
  const float* intr;
  int64_t intr_b, intr_n;
  int64_t p;
  int n_cams, img_h, img_w, ds, fh, fw, d;
  int per;                       // cells a CTA owns
  bool whole;                    // each CTA holds the whole grid
  FastDiv by_ds;
  float lo, step;                // d0 - step, step
  float* out;                    // [B * N, fH, fW, D] fp32
};

__global__ void __launch_bounds__(kThreads, 1) depth_labels_kernel(const Params p) {
  // the camera's grid (p.whole), else this CTA's cells; min-depth bits, then
  // this CTA's cells' bins
  extern __shared__ int grid[];
  __shared__ float mats[32];          // the camera's extrinsic, then intrinsic
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cs = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  const int64_t cam = blockIdx.x / cs;
  const int64_t bi = cam / p.n_cams, ni = cam - bi * p.n_cams;
  const int cells = p.fh * p.fw;
  const int c0 = min(rank * p.per, cells);
  const int n_own = min(c0 + p.per, cells) - c0;
  int* own = p.whole ? grid + c0 : grid;      // this CTA's cells
  for (int i = tid; i < (p.whole ? cells : n_own); i += kThreads)
    grid[i] = __float_as_int(kEmpty);
  if (tid < 16)
    mats[tid] = p.extr[bi * p.extr_b + ni * p.extr_n + tid];
  else if (tid < 32)
    mats[tid] = p.intr[bi * p.intr_b + ni * p.intr_n + tid - 16];
  if (p.whole)
    __syncthreads();
  else
    cluster.sync();   // every owner's cells are set before any remote atomicMin

  // --- 1: project this CTA's share of the points
  const float* e = mats;
  const float* k = mats + 16;
  const float umax = (float)(p.img_w - 1), vmax = (float)(p.img_h - 1);
  for (int64_t pi = (int64_t)rank * kThreads + tid; pi < p.p; pi += (int64_t)cs * kThreads) {
    if (!p.mask[bi * p.p + pi]) continue;
    const float* q = p.pts + bi * p.pts_b + pi * p.pts_p;
    const float x = q[0], y = q[1], z = q[2];
    // cam = [x, y, z, 1] @ extrinsic^T; the last term is e[r][3] * 1
    const float c0v = dot4(e, 0, x, y, z, 1.f), c1v = dot4(e, 1, x, y, z, 1.f);
    const float c2v = dot4(e, 2, x, y, z, 1.f), c3v = dot4(e, 3, x, y, z, 1.f);
    const float p0 = dot4(k, 0, c0v, c1v, c2v, c3v), p1 = dot4(k, 1, c0v, c1v, c2v, c3v);
    const float p2 = dot4(k, 2, c0v, c1v, c2v, c3v);
    const float den = (p2 == 0.f) ? 1e-9f : p2;
    const float u = __fdiv_rn(p0, den), v = __fdiv_rn(p1, den);
    // written so that NaN fails every test
    if (!(c2v > 1.f && u > 1.f && u < umax && v > 1.f && v < vmax)) continue;
    // u, v > 1: the truncating casts and the divisions are of positive ints
    const int seg = (int)(p.by_ds.div((unsigned)(int)v) * p.fw + p.by_ds.div((unsigned)(int)u));
    if (seg >= cells) continue;           // the JAX segment ops drop it too
    if (p.whole) {
      atomicMin(grid + seg, __float_as_int(c2v));
    } else {
      const int owner = seg / p.per;
      atomicMin(cluster.map_shared_rank(grid, owner) + (seg - owner * p.per),
                __float_as_int(c2v));
    }
  }
  cluster.sync();     // every atomicMin has landed

  // --- 2: the minimum of this CTA's cells over the cluster's copies
  if (p.whole) {
    for (int i = tid; i < n_own * cs; i += kThreads) {
      const int r = i / n_own, c = c0 + i - r * n_own;
      if (r != rank) atomicMin(grid + c, cluster.map_shared_rank(grid, r)[c]);
    }
  }
  // no CTA reads another's memory after this; the arrival releases those
  // reads, the wait before the exit keeps each CTA's memory until then
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  __syncthreads();
  for (int i = tid; i < n_own; i += kThreads)
    own[i] = bin_of(__int_as_float(own[i]), p.d, p.lo, p.step);
  __syncthreads();
  write_onehot<kThreads>(p.out, (cam * cells + c0) * (int64_t)p.d, n_own, p.d, own);
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__global__ void __launch_bounds__(kOnehotThreads) depth_onehot_kernel(
    const float* __restrict__ grid, float* __restrict__ out, int64_t cells, int d, float lo,
    float step) {
  __shared__ int bins[kChunkCells];
  for (int64_t c0 = (int64_t)blockIdx.x * kChunkCells; c0 < cells;
       c0 += (int64_t)gridDim.x * kChunkCells) {
    const int n = (int)min((int64_t)kChunkCells, cells - c0);
    __syncthreads();  // the previous chunk's writes have read bins
    if (threadIdx.x < n) bins[threadIdx.x] = bin_of(grid[c0 + threadIdx.x], d, lo, step);
    __syncthreads();
    write_onehot<kOnehotThreads>(out, c0 * d, n, d, bins);
  }
}

// Largest dynamic shared memory a CTA may ask for on the current device.
int max_smem_bytes() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return optin - (int)sizeof(float) * 32;   // less the static matrices
}

// 16 if the card schedules a 16-CTA cluster of the kernel with `smem`
// dynamic bytes a CTA, else 8 (the portable size); the answer is kept for
// the last (device, smem) asked.
int cluster_ctas(size_t smem) {
  static int last_dev = -1, last_cs = 0;
  static size_t last_smem = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev == last_dev && smem == last_smem) return last_cs;
  cudaFuncSetAttribute(depth_labels_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaFuncSetAttribute(depth_labels_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       max_smem_bytes());
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(16);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 16;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  const bool ok = cudaOccupancyMaxActiveClusters(&clusters, depth_labels_kernel, &cfg) ==
                      cudaSuccess && clusters > 0;
  cudaGetLastError();   // a refusal is an answer, not an error of the next launch
  last_dev = dev;
  last_smem = smem;
  last_cs = ok ? 16 : 8;
  return last_cs;
}

int per_cta(int cells, int cs) { return (cells + cs - 1) / cs; }

size_t smem_bytes(int cells, int per, bool whole) {
  return sizeof(int) * (size_t)(whole ? cells : per);
}

}  // namespace

// Cells of one camera's grid that fit in one cluster's shared memory.
extern "C" long long depth_labels_max_cells() {
  const int smem = max_smem_bytes() & ~3;
  return (long long)cluster_ctas((size_t)smem) * (smem / (int)sizeof(int));
}

// pts [B, P, F] fp32 with strides (pts_b, pts_p, 1) in floats (x, y, z
// read), mask [B, P] bool contiguous, extr/intr [B, N, 4, 4] fp32 with
// strides (.._b, .._n, 4, 1), out [B*N, fh, fw, d] fp32 contiguous and
// 16-byte aligned. lo = d0 - step. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a grid that fits no cluster).
extern "C" int depth_labels(const float* pts, long long pts_b, long long pts_p,
                            const bool* mask, const float* extr, long long extr_b,
                            long long extr_n, const float* intr, long long intr_b,
                            long long intr_n, long long b, long long p, int n_cams,
                            int img_h, int img_w, int ds, int fh, int fw, int d, float lo,
                            float step, float* out, void* stream) {
  const int cells = fh * fw;
  if (b * n_cams == 0 || cells == 0 || d == 0) return 0;
  const bool whole = (int64_t)cells * (int64_t)sizeof(int) <= max_smem_bytes();
  const int cs = cluster_ctas(smem_bytes(cells, per_cta(cells, 16), whole));
  const int per = per_cta(cells, cs);
  if ((int64_t)per * (int64_t)sizeof(int) > max_smem_bytes() ||
      b * n_cams * cs > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Params prm{pts,    pts_b, pts_p, mask, extr, extr_b, extr_n, intr,  intr_b,
             intr_n, p,     n_cams, img_h, img_w, ds, fh,  fw,    d,
             per,    whole, FastDiv((unsigned)ds), lo, step, out};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(b * n_cams * cs));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(cells, per, whole);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, depth_labels_kernel, prm);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The binning alone, on a precomputed min-depth grid [cells] fp32; out
// [cells, d] fp32, 16-byte aligned.
extern "C" int depth_onehot(const float* grid, float* out, long long cells, int d, float lo,
                            float step, void* stream) {
  if (cells == 0 || d == 0) return 0;
  const int64_t chunks = (cells + kChunkCells - 1) / kChunkCells;
  const unsigned blocks = (unsigned)(chunks < 65536 ? chunks : 65536);
  depth_onehot_kernel<<<blocks, kOnehotThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      grid, out, cells, d, lo, step);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
