// Kernels K8 and K8': the raw-rig (non-factorized) lift-splat of the camera
// branch and its backward.
//
//   out[m, g, c] = sum over (d, p) with idx[m, d, p] == g of
//                  round_T(depth[m, d, p] * ctx[m, p, c])
//
// accumulated in float32 and returned in ctx's dtype T, the trash cell
// idx == n_cells (a frustum point off the grid) dropped. Replaces the JAX
// package's device formulation mm_training_tpu/ops/voxel_pooling.py::
// lift_splat: per camera the [D*P, C] slab of products depth * ctx in the
// compute dtype ("the slab stays bf16": each product rounded to bf16), then
// a float32 segment-sum of its rows into n_cells + 1 cells, cast back.
//
// K8, one cooperative launch a call (a persistent grid of co-resident
// blocks, three phases with a grid barrier between them):
//   0. Zero the float32 accumulator [M, n_cells, C].
//   1. Splat. A group of C / 8 lanes of one warp owns one (camera, pixel);
//      each lane keeps 8 of the pixel's ctx channels in registers and walks
//      the D bins in order, loading 8 bins' cells and depths at a time. It
//      skips trash rows (most bins of the side cameras: the grid is only
//      +-25.6 m wide), rounds each product to T as the JAX package does,
//      and adds it in float32 to a run's partial sum while the bins fall
//      into one cell (0.5 m bins, 1.6 m cells: a few bins a run); when the
//      cell changes it issues one 16-byte float32 atomic add per 4
//      channels. The slab is never written.
//   2. Cast the accumulator to T.
// Bound: device-memory bytes (depth, the int32 indices and ctx read once,
// the BEV written once: ~42 MB at the B=1 request in bf16, the indices
// half of it). The atomics add in no fixed order: the sums agree with the
// plain version to float32 rounding. Given a counter, a launch also counts
// its adds: the scalar adds of kept (bin, pixel, channel) products the runs
// stand for, and the 16-byte adds it issues.
//
// K8' (lift_splat_raw_backward), for the output gradient g [M, n_cells, C]:
//   d depth[m, d, p] = sum_c round_T(ctx[m, p, c] g[m, idx, c])   (0 for trash)
//   d ctx[m, p, c]   = sum_d round_T(depth[m, d, p] g[m, idx, c])
// the products rounded to T as autograd through the plain version rounds
// them, the sums in float32. Both are row gathers, no atomics: the same
// group of lanes owns a pixel, gathers g's rows by cell over its bins
// (8 bins' rows in flight; a bin that no pixel of the warp keeps costs a
// vote and a zero), sums d depth over its lanes by a segmented shuffle
// scan in a fixed order and writes it once, and keeps d ctx in float32
// registers over all bins, written once at the end. bf16 products are
// packed HMUL2s, each rounded once from the exact product. Every output
// is written once in a fixed order: a second call gives the same bits.
// Bound: device-memory bytes (g, depth, ctx and the indices read once, d
// depth and d ctx written once); the gathered rows come from L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCh = 8;       // channels a lane
constexpr int kBins = 8;     // bins a lane loads together
constexpr int kMaxC = 32 * kCh;   // a pixel's lanes within one warp

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
struct alignas(sizeof(T) * kCh) Row {
  T v[kCh];
};

template <typename T>
__device__ __forceinline__ Row<T> splat_row(T a) {
  Row<T> r;
#pragma unroll
  for (int k = 0; k < kCh; ++k) r.v[k] = a;
  return r;
}

// out[k] = a[k] * b[k] rounded to T, as floats. bf16: packed HMUL2, one
// rounding of the exact product (the float32 product of two bf16 values is
// exact), as the plain version's bf16 multiply rounds it
__device__ __forceinline__ void mul_rows(const Row<float>& a, const Row<float>& b, float* out) {
#pragma unroll
  for (int k = 0; k < kCh; ++k) out[k] = __fmul_rn(a.v[k], b.v[k]);
}

__device__ __forceinline__ void mul_rows(const Row<__nv_bfloat16>& a,
                                         const Row<__nv_bfloat16>& b, float* out) {
  const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(a.v);
  const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(b.v);
#pragma unroll
  for (int k = 0; k < kCh / 2; ++k) {
    const float2 f = __bfloat1622float2(__hmul2(a2[k], b2[k]));
    out[2 * k] = f.x;
    out[2 * k + 1] = f.y;
  }
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

// a lane's place: the pixel group of its warp and its channel block
struct Lanes {
  int lanes, per_warp, grp, lig;
  __device__ __forceinline__ explicit Lanes(int c) {
    lanes = c / kCh;
    per_warp = 32 / lanes;
    const int lane = threadIdx.x & 31;
    grp = lane / lanes;
    lig = lane - grp * lanes;
  }
};

struct Params {
  const void* depth;
  long long sdm, sdd, sdp;        // depth [M, D, P] strides, elements
  const void* ctx;
  long long scm, scp, scc;        // ctx [M, P, C] strides, elements
  const int* idx;                 // [M, D, P] contiguous
  int m, d_bins, p, c, n_cells;
  float* acc;                     // [M, n_cells, C] float32 scratch
  unsigned* barrier;              // [2], zero before the first call
  void* out;                      // [M, n_cells, C] contiguous
  unsigned long long* adds;       // [2] or null: += (kept products, 16-byte adds)
};

template <typename T>
__global__ void __launch_bounds__(kThreads) lift_splat_raw_kernel(const Params p) {
  const int tid = threadIdx.x;
  const int64_t n4 = (int64_t)p.m * p.n_cells * p.c / 4;
  float4* acc4 = reinterpret_cast<float4*>(p.acc);

  // --- 0: zero the accumulator
  for (int64_t i = (int64_t)blockIdx.x * kThreads + tid; i < n4; i += (int64_t)gridDim.x * kThreads)
    acc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  grid_barrier(p.barrier);

  // --- 1: splat, a group of lanes a pixel
  const Lanes ln(p.c);
  const T* depth = static_cast<const T*>(p.depth);
  const T* ctx = static_cast<const T*>(p.ctx);
  const int64_t npix = (int64_t)p.m * p.p;
  const int64_t warps = (int64_t)gridDim.x * (kThreads / 32);
  const int64_t warp = (int64_t)blockIdx.x * (kThreads / 32) + (tid >> 5);
  unsigned long long kept = 0, issued = 0;   // this lane's adds, when counted
  if (ln.grp < ln.per_warp) {
    for (int64_t pix = warp * ln.per_warp + ln.grp; pix < npix; pix += warps * ln.per_warp) {
      const int mi = (int)(pix / p.p), pi = (int)(pix - (int64_t)mi * p.p);
      const int ch0 = ln.lig * kCh;
      Row<T> cr;
      const T* cp = ctx + mi * p.scm + pi * p.scp + ch0 * p.scc;
#pragma unroll
      for (int k = 0; k < kCh; ++k) cr.v[k] = cp[k * p.scc];
      const T* dp = depth + mi * p.sdm + pi * p.sdp;
      const int* ip = p.idx + (int64_t)mi * p.d_bins * p.p + pi;
      float* acc_m = p.acc + (int64_t)mi * p.n_cells * p.c + ch0;
      int cur = -1;
      float run[kCh];
#pragma unroll
      for (int k = 0; k < kCh; ++k) run[k] = 0.f;
      for (int d0 = 0; d0 < p.d_bins; d0 += kBins) {
        int cell[kBins];
        T dv[kBins];
#pragma unroll
        for (int u = 0; u < kBins; ++u) {
          const int d = d0 + u;
          cell[u] = d < p.d_bins ? ip[(int64_t)d * p.p] : p.n_cells;
          dv[u] = d < p.d_bins ? dp[d * p.sdd] : from_float<T>(0.f);
        }
#pragma unroll
        for (int u = 0; u < kBins; ++u) {
          const int g = cell[u];
          if (g < 0 || g >= p.n_cells) continue;   // trash: no product, the run goes on
          if (g != cur) {
            if (cur >= 0) {
              float4* a = reinterpret_cast<float4*>(acc_m + (int64_t)cur * p.c);
              atomicAdd(a, make_float4(run[0], run[1], run[2], run[3]));
              atomicAdd(a + 1, make_float4(run[4], run[5], run[6], run[7]));
              issued += 2;
            }
            cur = g;
#pragma unroll
            for (int k = 0; k < kCh; ++k) run[k] = 0.f;
          }
          float prod[kCh];
          mul_rows(splat_row(dv[u]), cr, prod);
#pragma unroll
          for (int k = 0; k < kCh; ++k) run[k] = __fadd_rn(run[k], prod[k]);
          kept += kCh;
        }
      }
      if (cur >= 0) {
        float4* a = reinterpret_cast<float4*>(acc_m + (int64_t)cur * p.c);
        atomicAdd(a, make_float4(run[0], run[1], run[2], run[3]));
        atomicAdd(a + 1, make_float4(run[4], run[5], run[6], run[7]));
        issued += 2;
      }
    }
  }
  if (p.adds && issued) {
    atomicAdd(p.adds, kept);
    atomicAdd(p.adds + 1, issued);
  }
  grid_barrier(p.barrier);

  // --- 2: cast (the sums come from L2: read past L1)
  for (int64_t i = (int64_t)blockIdx.x * kThreads + tid; i < n4; i += (int64_t)gridDim.x * kThreads) {
    const float4 v = __ldcg(acc4 + i);
    if constexpr (sizeof(T) == 4) {
      reinterpret_cast<float4*>(p.out)[i] = v;
    } else {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      uint2 pk;
      pk.x = *reinterpret_cast<const unsigned*>(&lo);
      pk.y = *reinterpret_cast<const unsigned*>(&hi);
      reinterpret_cast<uint2*>(p.out)[i] = pk;
    }
  }
}

template <typename T>
int launch(Params p, cudaStream_t st) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, lift_splat_raw_kernel<T>, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(lift_splat_raw_kernel<T>),
                                          dim3(occ * sms), dim3(kThreads), args, 0, st);
}

struct BwdParams {
  const void* g;
  long long sgm, sgg;             // g [M, n_cells, C] strides, channels contiguous
  int g_vec;                      // g's 8-channel rows 16-byte aligned
  const void* depth;
  long long sdm, sdd, sdp;
  const void* ctx;
  long long scm, scp, scc;
  const int* idx;                 // [M, D, P] contiguous
  void* d_depth;
  long long sem, sed, sep;        // d depth strides
  void* d_ctx;
  long long sfm, sfp, sfc;        // d ctx strides
  int m, d_bins, p, c, n_cells;
};

template <typename T>
__device__ __forceinline__ Row<T> load_row(const T* src, bool vec) {
  if (vec) return *reinterpret_cast<const Row<T>*>(src);
  Row<T> r;
#pragma unroll
  for (int k = 0; k < kCh; ++k) r.v[k] = src[k];
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) lift_splat_raw_bwd_kernel(const BwdParams p) {
  const Lanes ln(p.c);
  const int64_t npix = (int64_t)p.m * p.p;
  const int64_t pix = ((int64_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * ln.per_warp
                      + ln.grp;
  // every lane of the warp runs the loop (the votes and the scan
  // shuffles); a lane without a pixel carries zeros
  const bool live = ln.grp < ln.per_warp && pix < npix;
  const bool writer = live && ln.lig == ln.lanes - 1;
  const int mi = live ? (int)(pix / p.p) : 0;
  const int pi = live ? (int)(pix - (int64_t)mi * p.p) : 0;
  const int ch0 = ln.lig * kCh;
  const T* g = static_cast<const T*>(p.g) + mi * p.sgm + ch0;
  const T* dp = static_cast<const T*>(p.depth) + mi * p.sdm + pi * p.sdp;
  const int* ip = p.idx + (int64_t)mi * p.d_bins * p.p + pi;
  T* dd = static_cast<T*>(p.d_depth) + mi * p.sem + pi * p.sep;
  const bool vec = p.g_vec;
  const T zero = from_float<T>(0.f);
  Row<T> cr = splat_row(zero);
  float dc[kCh];
  const T* cp = static_cast<const T*>(p.ctx) + mi * p.scm + pi * p.scp + ch0 * p.scc;
#pragma unroll
  for (int k = 0; k < kCh; ++k) {
    if (live) cr.v[k] = cp[k * p.scc];
    dc[k] = 0.f;
  }
  for (int d0 = 0; d0 < p.d_bins; d0 += kBins) {
    int cell[kBins];
    T dv[kBins];
    unsigned kept = 0;
#pragma unroll
    for (int u = 0; u < kBins; ++u) {
      const int d = d0 + u;
      const bool in = live && d < p.d_bins;
      cell[u] = in ? ip[(int64_t)d * p.p] : p.n_cells;
      dv[u] = in ? dp[d * p.sdd] : zero;
      kept |= (unsigned)(cell[u] >= 0 && cell[u] < p.n_cells) << u;
    }
    // the bins some pixel of the warp keeps (warp-uniform): trash rows
    // gather nothing and their d depth is zero
    const unsigned any = __reduce_or_sync(0xffffffffu, kept);
    Row<T> gr[kBins];   // the bins' g rows, loaded together
#pragma unroll
    for (int u = 0; u < kBins; ++u)
      gr[u] = ((kept >> u) & 1u) ? load_row(g + (int64_t)cell[u] * p.sgg, vec) : splat_row(zero);
#pragma unroll
    for (int u = 0; u < kBins; ++u) {
      const int d = d0 + u;
      if (!((any >> u) & 1u)) {
        if (writer && d < p.d_bins) dd[d * p.sed] = zero;
        continue;
      }
      float pc[kCh], pd[kCh];
      mul_rows(cr, gr[u], pc);
      mul_rows(splat_row(dv[u]), gr[u], pd);
      float part = 0.f;
#pragma unroll
      for (int k = 0; k < kCh; ++k) {
        dc[k] = __fadd_rn(dc[k], pd[k]);
        part = __fadd_rn(part, pc[k]);
      }
      // inclusive scan over the pixel's lanes: the last one holds the sum
      for (int off = 1; off < ln.lanes; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, part, off);
        if (ln.lig >= off) part = __fadd_rn(part, t);
      }
      if (writer && d < p.d_bins) dd[d * p.sed] = from_float<T>(part);
    }
  }
  if (live) {
    T* fc = static_cast<T*>(p.d_ctx) + mi * p.sfm + pi * p.sfp + ch0 * p.sfc;
#pragma unroll
    for (int k = 0; k < kCh; ++k) fc[k * p.sfc] = from_float<T>(dc[k]);
  }
}

template <typename T>
int launch_backward(const BwdParams& p, cudaStream_t st) {
  const int per_block = (kThreads / 32) * (32 / (p.c / kCh));
  const int64_t blocks = ((int64_t)p.m * p.p + per_block - 1) / per_block;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  lift_splat_raw_bwd_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// K8. depth [M, D, P] with strides sd*, ctx [M, P, C] with strides sc*
// (elements; dtype 0 = float32, 1 = bfloat16), idx [M, D, P] int32 in
// [0, n_cells] (n_cells = trash), contiguous; acc float32 scratch of
// M * n_cells * C values; barrier two uint32 that are zero before the first
// call (every call leaves them so); out [M, n_cells, C] contiguous, of the
// inputs' dtype; adds null, or two uint64 that the launch adds its counts to
// (see the top of this file). C a multiple of 8 up to 256. Returns the
// cudaError_t.
extern "C" int lift_splat_raw(int dtype, const void* depth, long long sdm, long long sdd,
                              long long sdp, const void* ctx, long long scm, long long scp,
                              long long scc, const int* idx, int m, int d_bins, int p, int c,
                              int n_cells, float* acc, unsigned* barrier, void* out,
                              unsigned long long* adds, void* stream) {
  if (c % kCh != 0 || c < kCh || c > kMaxC || m < 1 || d_bins < 1 || p < 1 || n_cells < 1)
    return (int)cudaErrorInvalidValue;
  Params prm{depth, sdm, sdd, sdp, ctx, scm, scp, scc, idx, m, d_bins, p, c, n_cells,
             acc, barrier, out, adds};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(prm, st);
  if (dtype == 1) return launch<__nv_bfloat16>(prm, st);
  return (int)cudaErrorInvalidValue;
}

// K8'. g [M, n_cells, C] with strides (sgm, sgg, 1) (g_vec = 1: its
// 8-channel rows 16-byte aligned), depth, ctx and idx as lift_splat_raw
// takes them; d_depth [M, D, P] and d_ctx [M, P, C] with strides se* and
// sf*, of the inputs' dtype. Each output written once. Returns the
// cudaError_t.
extern "C" int lift_splat_raw_backward(int dtype, const void* g, long long sgm, long long sgg,
                                       int g_vec, const void* depth, long long sdm,
                                       long long sdd, long long sdp, const void* ctx,
                                       long long scm, long long scp, long long scc,
                                       const int* idx, void* d_depth, long long sem,
                                       long long sed, long long sep, void* d_ctx, long long sfm,
                                       long long sfp, long long sfc, int m, int d_bins, int p,
                                       int c, int n_cells, void* stream) {
  if (c % kCh != 0 || c < kCh || c > kMaxC || m < 1 || d_bins < 1 || p < 1 || n_cells < 1)
    return (int)cudaErrorInvalidValue;
  BwdParams prm{g, sgm, sgg, g_vec, depth, sdm, sdd, sdp, ctx, scm, scp, scc, idx,
                d_depth, sem, sed, sep, d_ctx, sfm, sfp, sfc, m, d_bins, p, c, n_cells};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_backward<float>(prm, st);
  if (dtype == 1) return launch_backward<__nv_bfloat16>(prm, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
