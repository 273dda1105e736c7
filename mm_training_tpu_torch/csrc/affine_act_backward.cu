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
// per element. Design for that: 16-byte vectors per thread on neighbouring
// addresses, several pixels' loads issued before any is used (6-8
// 16-byte loads in flight a thread), a grid sized from the SM count and the
// occupancy the kernel reaches, fp32 math and one rounding at each store.
// z is recomputed with the forward's rounding (__fmul_rn then __fadd_rn, no
// FMA contraction), so the ReLU mask is exactly the forward's.
//
// One launch a call, any channel count: the channel groups are split into
// tiles of at most kMaxTileGroups groups (grid.y), so C = 2048 and C not a
// multiple of the vector width run here too. The per-channel sums are
// deterministic: each thread owns one channel group and walks pixels in a
// fixed order; each block adds its rows' partials in a fixed order (xor
// shuffles within a warp, then shared memory) and writes them. The launch is cooperative (the grid is
// sized to be resident at once), so after one grid barrier every block adds
// a slice of its tile's sums: all blocks' partials of a slice loaded at
// once, then a pairwise tree whose pairs depend only on the grid. At a few
// hundred pixels the channel tiles narrow until one block a tile covers
// every pixel in one round of loads; it writes ds, dt itself. The grid depends
// only on the shape and the card, never on the order in which blocks
// finish, so two calls give the same bits. The barrier's two words are
// allocated zeroed once by the caller and left so by every launch.
//
// The partials' scratch has a bound that holds at every shape: partials are
// written only with more than one block a tile, and then a block has two or
// more pixel rows and the resident blocks hold at most the SMs' threads, so
// ctiles * nb * 2 * tile_c <= VEC * (threads an SM) * SMs <= 8 * 2048 * SMs
// floats. The caller allocates that once per device; a launch checks it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// pixels whose loads a thread issues together: 8 (no residual) or 6
// 16-byte loads in flight, within 128 registers (two blocks an SM)
__host__ __device__ constexpr int unroll(bool residual) { return residual ? 2 : 4; }

constexpr int kThreads = 256;
constexpr int kMaxTileGroups = 128;  // channel groups a tile: two or more pixel rows a block

// How a call is cut, a function of the shape and the card only.
struct Plan {
  int groups;       // channel groups of VEC values
  int ctiles;       // channel tiles (grid.y)
  int tile_groups;  // channel groups a tile (threads a pixel row)
  int rows;         // pixel rows a block
  int threads;      // tile_groups * rows
  int nb;           // blocks along the pixels (grid.x)
  size_t smem;      // [2][rows][tile_c] floats, then the sums' buffer
};

struct Args {
  const void* g;
  const void* x;
  const void* r;
  const float* s;
  const float* t;
  void* dx;
  void* dr;
  float* ds;
  float* dt;
  float* part;          // [ctiles][nb][2][tile_c] float32
  long long part_floats;  // part's size
  unsigned* barrier;    // [2], zero before the first call
  long long npix;
  int c;
  Plan plan;
};

// All blocks of the (cooperative, co-resident) grid meet here; what any
// block wrote before is visible to every block after.
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned seen = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x * gridDim.y - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == seen) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// ds (i < tile_c) or dt of the tile's channel i % tile_c
__device__ __forceinline__ void write_sum(const Args& a, int tile_c, int i, float v) {
  const int which = i / tile_c;
  const int ch = blockIdx.y * tile_c + (i - which * tile_c);
  if (ch < a.c) (which ? a.dt : a.ds)[ch] = v;
}

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}
__device__ __forceinline__ float part_of(float v, int) { return v; }
__device__ __forceinline__ float part_of(float4 v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// This block's share of its tile's sums, after the grid barrier: the V-wide
// pieces (V = 4: float4) q = blockIdx.x + k * nb of the tile's 2 * tile_c
// sums. Every block's partial of a piece is loaded at once into shared
// memory, then added by a pairwise tree whose pairs depend only on nb.
template <int V>
__device__ __forceinline__ void sum_partials(const Args& a, int tile_c, const float* part,
                                             void* scratch) {
  using F = typename std::conditional<V == 4, float4, float>::type;
  F* buf = static_cast<F*>(scratch);  // [pieces][nb]
  const int nb = gridDim.x, pieces = 2 * tile_c / V;
  if ((int)blockIdx.x >= pieces) return;
  const int mine = (pieces - 1 - blockIdx.x) / nb + 1;
  const int n = mine * nb;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int k = i / nb, b = i - k * nb;
    buf[i] = __ldcg(reinterpret_cast<const F*>(part + (size_t)b * 2 * tile_c) + blockIdx.x +
                    k * nb);
  }
  __syncthreads();
  for (int step = 1; step < nb; step <<= 1) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int b = i % nb;
      if ((b & (2 * step - 1)) == 0 && b + step < nb) buf[i] = add(buf[i], buf[i + step]);
    }
    __syncthreads();
  }
  for (int k = threadIdx.x; k < mine; k += blockDim.x) {
    const F v = buf[k * nb];
#pragma unroll
    for (int e = 0; e < V; ++e) write_sum(a, tile_c, (blockIdx.x + k * nb) * V + e, part_of(v, e));
  }
}

template <typename T, int VEC, bool RES, bool RELU>
__global__ void __launch_bounds__(kThreads, 2) affine_act_bwd_kernel(const Args a) {
  extern __shared__ __align__(16) float red[];  // [2][rows][tile_c], then the sums' buffer
  const Plan& p = a.plan;
  const int tile_c = p.tile_groups * VEC;
  const int lane = threadIdx.x % p.tile_groups;
  const int row = threadIdx.x / p.tile_groups;
  const int cg = blockIdx.y * p.tile_groups + lane;
  const int c0 = cg * VEC;
  float ds[VEC], dt[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) ds[j] = dt[j] = 0.f;
  if (cg < p.groups) {
    float sv[VEC], tv[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      sv[j] = a.s[c0 + j];
      tv[j] = a.t[c0 + j];
    }
    using P = Pack<T, VEC>;
    const P* gp = static_cast<const P*>(a.g);
    const P* xp = static_cast<const P*>(a.x);
    const P* rp = static_cast<const P*>(a.r);
    P* dxp = static_cast<P*>(a.dx);
    P* drp = static_cast<P*>(a.dr);
    constexpr int kUnroll = unroll(RES);
    const int64_t step = (int64_t)gridDim.x * p.rows;
    for (int64_t p0 = (int64_t)blockIdx.x * p.rows + row; p0 < a.npix; p0 += kUnroll * step) {
      P gv[kUnroll], xv[kUnroll], rv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {  // every load first
        const int64_t px = p0 + u * step;
        if (px < a.npix) {
          const int64_t off = (px * a.c + c0) / VEC;
          gv[u] = gp[off];
          xv[u] = xp[off];
          if (RES) rv[u] = rp[off];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t px = p0 + u * step;
        if (px < a.npix) {
          const int64_t off = (px * a.c + c0) / VEC;
          P dxv, drv;
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float xf = to_float(xv[u].v[j]);
            float m = to_float(gv[u].v[j]);
            if (RELU) {
              float z = __fadd_rn(__fmul_rn(xf, sv[j]), tv[j]);
              if (RES) z = __fadd_rn(z, to_float(rv[u].v[j]));
              m = (z > 0.f) ? m : 0.f;
            }
            dxv.v[j] = from_float<T>(__fmul_rn(m, sv[j]));
            if (RES) drv.v[j] = from_float<T>(m);
            ds[j] = __fadd_rn(ds[j], __fmul_rn(m, xf));
            dt[j] = __fadd_rn(dt[j], m);
          }
          dxp[off] = dxv;
          if (RES) drp[off] = drv;
        }
      }
    }
  }
  // this block's partials, added in a fixed order: where a warp holds
  // whole pixel rows (tile_groups divides 32), its rows by xor shuffles,
  // then the warps' (or else the rows') sums one after another into row 0
  int srows = p.rows, srow = row;
  if (32 % p.tile_groups == 0) {
    for (int off = p.tile_groups; off < 32; off <<= 1) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        ds[j] = __fadd_rn(ds[j], __shfl_xor_sync(0xffffffffu, ds[j], off));
        dt[j] = __fadd_rn(dt[j], __shfl_xor_sync(0xffffffffu, dt[j], off));
      }
    }
    srows = p.rows * p.tile_groups / 32;
    srow = (int)threadIdx.x / 32;
  }
  if (srow * (p.rows / srows) == row) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      red[srow * tile_c + lane * VEC + j] = ds[j];
      red[(srows + srow) * tile_c + lane * VEC + j] = dt[j];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * tile_c; i += blockDim.x) {
    const int which = i / tile_c, ch = i - which * tile_c;
    float acc = red[which * srows * tile_c + ch];
    for (int q = 1; q < srows; ++q) acc = __fadd_rn(acc, red[(which * srows + q) * tile_c + ch]);
    red[which * srows * tile_c + ch] = acc;
  }
  __syncthreads();
  if (gridDim.x == 1) {  // the block saw every pixel: its sums are the result
    for (int i = threadIdx.x; i < 2 * tile_c; i += blockDim.x)
      write_sum(a, tile_c, i, red[(i < tile_c ? 0 : srows) * tile_c + i % tile_c]);
    return;
  }
  float* part = a.part + (size_t)blockIdx.y * gridDim.x * 2 * tile_c;
  for (int i = threadIdx.x; i < 2 * tile_c; i += blockDim.x)
    part[(size_t)blockIdx.x * 2 * tile_c + i] = red[(i < tile_c ? 0 : srows) * tile_c + i % tile_c];
  grid_barrier(a.barrier);
  if (tile_c % 4 == 0) sum_partials<4>(a, tile_c, part, red);
  else sum_partials<1>(a, tile_c, part, red);
}

template <typename T, int VEC, bool RES, bool RELU>
cudaError_t make_plan(long long npix, int c, Plan* p) {
  p->groups = (c + VEC - 1) / VEC;
  const long long one_round = (npix + unroll(RES) - 1) / unroll(RES);  // pixel rows
  if (one_round <= kThreads) {
    // few pixels: narrow channel tiles, one block a tile whose rows take
    // every pixel in one round of loads (no partials, no barrier)
    int tg = 1;
    while (tg * 2 <= kThreads / (one_round > 0 ? one_round : 1) && tg * 2 <= p->groups) tg *= 2;
    p->tile_groups = tg;
    p->ctiles = (p->groups + tg - 1) / tg;
  } else {
    p->ctiles = (p->groups + kMaxTileGroups - 1) / kMaxTileGroups;
    p->tile_groups = (p->groups + p->ctiles - 1) / p->ctiles;
  }
  p->rows = kThreads / p->tile_groups;
  p->threads = p->tile_groups * p->rows;
  // shared memory: the rows' partials, then (reused) the sums' buffer of
  // pieces x blocks values; blocks are at most 2048 / threads an SM
  const int tile_c = p->tile_groups * VEC;
  const size_t piece = tile_c % 4 == 0 ? sizeof(float4) : sizeof(float);
  const int pieces = (int)(2 * tile_c * sizeof(float) / piece);
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const size_t rows_bytes = sizeof(float) * 2 * (size_t)p->threads * VEC;
  const size_t sums_bytes = piece * ((size_t)pieces + (size_t)(2048 / p->threads) * sms);
  p->smem = rows_bytes > sums_bytes ? rows_bytes : sums_bytes;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, affine_act_bwd_kernel<T, VEC, RES, RELU>,
                                                    p->threads, p->smem);
  if (e != cudaSuccess) return e;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  // one unrolled round of pixel loads a thread, at most what the SMs hold at
  // once (with more than one block a tile the launch is cooperative: every
  // block must be resident)
  const long long cap = occ * sms / p->ctiles > 1 ? occ * sms / p->ctiles : 1;
  const long long rounds = (npix + (long long)p->rows * unroll(RES) - 1) /
                           ((long long)p->rows * unroll(RES));
  p->nb = (int)(rounds < 1 ? 1 : (rounds > cap ? cap : rounds));
  return cudaSuccess;
}

// plan and launch; the partials must fit in part
template <typename T, int VEC, bool RES, bool RELU>
int launch(Args a, cudaStream_t st) {
  const cudaError_t e = make_plan<T, VEC, RES, RELU>(a.npix, a.c, &a.plan);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.plan.nb, a.plan.ctiles);
  if (a.plan.nb == 1) {  // no grid barrier, no partials
    affine_act_bwd_kernel<T, VEC, RES, RELU><<<grid, a.plan.threads, a.plan.smem, st>>>(a);
    return (int)cudaGetLastError();
  }
  if ((long long)a.plan.ctiles * a.plan.nb * 2 * a.plan.tile_groups * VEC > a.part_floats)
    return (int)cudaErrorInvalidValue;
  void* args[] = {&a};
  return (int)cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(affine_act_bwd_kernel<T, VEC, RES, RELU>), grid,
      dim3(a.plan.threads), args, a.plan.smem, st);
}

template <typename T, int VEC>
int launch_flags(int residual, int relu, const Args& a, cudaStream_t st) {
  if (residual)
    return relu ? launch<T, VEC, true, true>(a, st) : launch<T, VEC, true, false>(a, st);
  return relu ? launch<T, VEC, false, true>(a, st) : launch<T, VEC, false, false>(a, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. r (and dr) may be null. vector: 1 when
// every pointer is 16-byte aligned and c is a multiple of 16 bytes' worth of
// values (then each thread moves 16-byte packs), 0 for one value a thread.
// part: part_floats float32 values, 8 * (threads an SM) * SMs always
// suffice (see the top of this file); barrier: two uint32 that are zero
// before the first call (every call leaves them so). Returns the
// cudaError_t of the launch.
extern "C" int affine_act_backward(int dtype, const void* g, const void* x, const void* r,
                                   const float* s, const float* t, void* dx, void* dr,
                                   float* ds, float* dt, float* part, long long part_floats,
                                   unsigned* barrier, long long npix, int c, int relu,
                                   int vector, void* stream) {
  if (c < 1 || npix < 0) return (int)cudaErrorInvalidValue;
  const Args a{g, x, r, s, t, dx, dr, ds, dt, part, part_floats, barrier, npix, c, Plan{}};
  const int res = r != nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vector ? launch_flags<float, 4>(res, relu, a, st)
                  : launch_flags<float, 1>(res, relu, a, st);
  if (dtype == 1)
    return vector ? launch_flags<__nv_bfloat16, 8>(res, relu, a, st)
                  : launch_flags<__nv_bfloat16, 1>(res, relu, a, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
