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
// Bound: device-memory bytes (depth, zvalid, ctx and the indices read once,
// the BEV written once: ~25 MB a frame in bf16); the contraction is 0.9
// GFLOP a frame, about a microsecond on the tensor cores. Then the adds into
// the BEV, which land wherever the rays go: float atomics in L2.
//
// One cooperative launch a call: a persistent grid of co-resident blocks
// that runs three phases with a grid barrier between them.
//   0. Zero the fp32 accumulator [M, n_cells, C].
//   1. Splat. Each block walks tasks (camera m, kWT image columns, kDC
//      depth bins). It loads the tile's cells, its z-mask (one bit a
//      column), the columns' ctx [h][C] and then the masked depth
//      [column][h][d] into shared memory, each thread keeping kBatch loads
//      in flight, each read along whichever dimension is innermost in
//      memory, so neighbouring threads read neighbouring addresses in the
//      layouts the path hands over: depth channels-last (d innermost) under
//      the depth oracle and NCHW (w innermost) without it, ctx a
//      channels-last slice of the DepthNet output (C innermost, pixel
//      stride D + C). The wrapper passes strides; nothing is copied. Index
//      arithmetic takes shifts and carries, no division. Per column, the
//      [kDC x fH] @ [fH x C] product runs on the tensor cores (bf16
//      mma.sync m16n8k16 with fp32 sums; bf16 products are exact in fp32,
//      as on the MXU; fH is padded to 16 with zeros) into shared memory;
//      fp32 inputs take fp32 FMAs, never TF32. Then one thread per (run of
//      consecutive bins of the column bound for the same cell, 4 channels)
//      adds the run in bin order and issues one 16-byte atomicAdd: a ray
//      crosses a 1.6 m cell in about three 0.5 m bins. Rows bound for the
//      trash bin are skipped.
//   2. Cast the accumulator to the compute dtype.
// Float atomics add in no fixed order: the sums agree with the plain version
// to fp32 rounding. Given a counter, a launch also counts its adds: the
// scalar adds of kept (bin, column, channel) rows the runs stand for, and
// the 16-byte adds it issues (each thread its own, one atomic each at the
// end of the splat).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWT = 4;         // image columns a task
constexpr int kDC = 64;        // depth bins a task (four 16-row mma tiles)
constexpr int kDS = kDC + 8;   // a depth row's stride in shared memory: ldmatrix rows on distinct banks
constexpr int kBatch = 16;     // loads a thread issues together
constexpr int kZRows = 64 * kDC / kThreads;    // (bin, row) mask words a thread, fH up to 64
constexpr int kMaxC = 128;

struct Params {
  const void* depth;
  long long sdm, sdd, sdh, sdw;   // depth strides, elements
  const void* ctx;
  long long scm, sch, scw, scc;   // ctx strides, elements
  const int* idx;                 // [M, D, fW] contiguous
  const bool* zvalid;             // [M, D, fH, fW] contiguous
  int m, d_bins, fh, fw, c, n_cells;
  int kp;                         // fH padded to 16
  int zv_words;                   // zvalid rows readable as kWT-byte words
  float* acc;                     // [M, n_cells, C] float32 scratch
  unsigned* barrier;              // [2], zero before the first call
  void* out;                      // [M, n_cells, C]
  unsigned long long* adds;       // [2] or null: += (rows x channels merged, 16-byte adds)
};

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// shared memory, in this order: depth [kWT][kp * kDS + 8] T, ctx
// [kWT][kp][c + 8] T, products [kDC][c + 8] float, cells [kWT][kDC] int, z
// bits [kp][kDC]
__host__ __device__ inline size_t dep_slab(int kp) { return (size_t)kp * kDS + 8; }

template <typename T>
__host__ __device__ inline size_t smem_bytes(int kp, int c) {
  return sizeof(T) * kWT * (dep_slab(kp) + (size_t)kp * (c + 8)) +
         sizeof(float) * kDC * (c + 8) + sizeof(int) * kWT * kDC + (size_t)kp * kDC;
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// (block, row, channel) of the values a thread takes in a walk over
// [*][rows][c] of kThreads a step, advanced by carries, not divisions
struct Walk {
  int w, h, ch, dh, dch, c, rows;
  __device__ __forceinline__ Walk(int c_, int rows_ = 1 << 30) : c(c_), rows(rows_) {
    const int r = threadIdx.x / c;
    ch = threadIdx.x - r * c;
    w = r / rows;
    h = r - w * rows;
    dh = kThreads / c;
    dch = kThreads - dh * c;
  }
  __device__ __forceinline__ void next() {
    h += dh;
    ch += dch;
    if (ch >= c) {
      ch -= c;
      ++h;
    }
    while (h >= rows) {
      h -= rows;
      ++w;
    }
  }
};

// rows d0 + [0, kDC) x channels [0, c) of the column's product, into prod
// (bf16: tensor cores; warp w takes the 16-row tile w % 4 and half the
// 8-channel tiles, at most NT of them)
template <int NT>
__device__ __forceinline__ void contract(const __nv_bfloat16* dep, const __nv_bfloat16* ctxs,
                                         float* prod, int kp, int fh, int c) {
  (void)fh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt = warp & 3;
  const int ntiles = c / 8, half = (ntiles + 1) / 2;
  const int nt0 = (warp >> 2) * half;
  const int nt1 = min(ntiles, nt0 + half);
  const int cs = c + 8;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int q = lane >> 3, r = lane & 7;
  for (int k0 = 0; k0 < kp; k0 += 16) {
    // A (16 bins x 16 rows): four 8x8 blocks of the [h][d] tile, transposed
    uint32_t a[4];
    const __nv_bfloat16* pa = dep + (k0 + (q >> 1) * 8 + r) * kDS + mt * 16 + (q & 1) * 8;
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
                 : "r"(smem_addr(pa)));
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int nt = nt0 + j;
      if (nt < nt1) {
        // B (16 rows x 8 channels): two 8x8 blocks of the [h][c] tile, transposed
        uint32_t b[2];
        const __nv_bfloat16* pb = ctxs + (k0 + (q & 1) * 8 + r) * cs + nt * 8;
        asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
                     : "=r"(b[0]), "=r"(b[1])
                     : "r"(smem_addr(pb)));
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
            "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      }
    }
  }
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int nt = nt0 + j;
    if (nt < nt1) {
      float* o = prod + (mt * 16 + g) * cs + nt * 8 + tig * 2;
      *reinterpret_cast<float2*>(o) = make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(o + 8 * cs) = make_float2(acc[j][2], acc[j][3]);
    }
  }
}

// fp32: FMAs over the rows in order (no TF32)
template <int NT>
__device__ __forceinline__ void contract(const float* dep, const float* ctxs, float* prod,
                                         int kp, int fh, int c) {
  (void)kp;
  const int cs = c + 8;
  for (Walk at(c); at.h < kDC; at.next()) {
    float s = 0.f;
    for (int h = 0; h < fh; ++h) s = fmaf(dep[h * kDS + at.h], ctxs[h * cs + at.ch], s);
    prod[at.h * cs + at.ch] = s;
  }
}

// (bin, row, column) of the i-th value of a depth tile: neighbouring i on
// depth's innermost dimension (d, or else the column); shifts only
__device__ __forceinline__ void tile_coords(int i, bool d_inner, int& d, int& h, int& wl) {
  if (d_inner) {
    d = i & (kDC - 1);
    wl = (i / kDC) & (kWT - 1);
    h = i / (kDC * kWT);
  } else {
    wl = i & (kWT - 1);
    d = (i / kWT) & (kDC - 1);
    h = i / (kWT * kDC);
  }
}

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, 2) lift_splat_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cs = p.c + 8, ctx_slab = p.kp * cs, slab = (int)dep_slab(p.kp);
  T* dep = reinterpret_cast<T*>(smem);                                 // [kWT][kp][kDS]
  T* ctxs = dep + kWT * slab;                                          // [kWT][kp][c + 8]
  float* prod = reinterpret_cast<float*>(ctxs + kWT * ctx_slab);       // [kDC][c + 8]
  int* cells = reinterpret_cast<int*>(prod + kDC * cs);                // [kWT][kDC]
  unsigned char* zbits = reinterpret_cast<unsigned char*>(cells + kWT * kDC);  // [kp][kDC]
  const int tid = threadIdx.x;
  const T* depth = static_cast<const T*>(p.depth);
  const T* ctx = static_cast<const T*>(p.ctx);

  // --- 0: zero the accumulator; zero the rows that pad fH to kp, once
  const int64_t n4 = (int64_t)p.m * p.n_cells * p.c / 4;
  float4* acc4 = reinterpret_cast<float4*>(p.acc);
  for (int64_t i = (int64_t)blockIdx.x * kThreads + tid; i < n4; i += (int64_t)gridDim.x * kThreads)
    acc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int wl = 0; wl < kWT; ++wl) {
    for (int i = tid; i < (p.kp - p.fh) * kDS; i += kThreads) dep[wl * slab + p.fh * kDS + i] = zero<T>();
    for (int i = tid; i < (p.kp - p.fh) * cs; i += kThreads) ctxs[wl * ctx_slab + p.fh * cs + i] = zero<T>();
  }
  grid_barrier(p.barrier);

  // --- 1: splat
  const int nwg = (p.fw + kWT - 1) / kWT, ndc = (p.d_bins + kDC - 1) / kDC;
  const int ntasks = nwg * p.m * ndc;
  const bool d_inner = p.sdd == 1;
  unsigned merged = 0, issued = 0;   // this thread's adds, when counted
  for (int task = blockIdx.x; task < ntasks; task += gridDim.x) {
    const int wg = task % nwg, rest = task / nwg;
    const int m = rest % p.m, d0 = (rest / p.m) * kDC, w0 = wg * kWT;
    const int nd = min(kDC, p.d_bins - d0), nw = min(kWT, p.fw - w0);
    const T* dep_m = depth + m * p.sdm + d0 * p.sdd + w0 * p.sdw;
    const T* ctx_m = ctx + m * p.scm + w0 * p.scw;
    __syncthreads();  // the last task is done with shared memory
    // the tile's cells (columns past fW go to the trash) and z-mask words,
    // issued together
    const int wl_c = tid & (kWT - 1), d_c = tid / kWT;
    const int cell = (wl_c < nw && d_c < nd)
        ? p.idx[((int64_t)m * p.d_bins + d0 + d_c) * p.fw + w0 + wl_c] : p.n_cells;
    const bool words = p.zv_words && nw == kWT;
    unsigned zrow[kZRows];
#pragma unroll
    for (int u = 0; u < kZRows; ++u) {  // the kWT mask bytes of a (bin, row) at once
      const int i = tid + u * kThreads, d = i & (kDC - 1), h = i / kDC;
      zrow[u] = 0;
      if (words && h < p.fh && d < nd)
        zrow[u] = *reinterpret_cast<const unsigned*>(
            p.zvalid + (((int64_t)m * p.d_bins + d0 + d) * p.fh + h) * p.fw + w0);
    }
    // the columns' ctx [column][h][c]
    Walk at(p.c, p.fh);
    for (int base = 0; base < nw * p.fh * p.c; base += kThreads * kBatch) {
      T v[kBatch];
      const Walk from = at;
#pragma unroll
      for (int u = 0; u < kBatch; ++u, at.next())
        if (at.w < nw) v[u] = ctx_m[at.w * p.scw + at.h * p.sch + at.ch * p.scc];
      at = from;
#pragma unroll
      for (int u = 0; u < kBatch; ++u, at.next())
        if (at.w < nw) ctxs[at.w * ctx_slab + at.h * cs + at.ch] = v[u];
    }
    cells[wl_c * kDC + d_c] = cell;
#pragma unroll
    for (int u = 0; u < kZRows; ++u) {
      const int i = tid + u * kThreads, d = i & (kDC - 1), h = i / kDC;
      if (h >= p.fh) continue;
      unsigned bits = 0;
      if (words) {
#pragma unroll
        for (int b = 0; b < kWT; ++b) bits |= ((zrow[u] >> (8 * b)) & 1u) << b;
      } else if (d < nd) {
        const bool* zv = p.zvalid + (((int64_t)m * p.d_bins + d0 + d) * p.fh + h) * p.fw + w0;
        for (int b = 0; b < nw; ++b) bits |= (unsigned)zv[b] << b;
      }
      zbits[h * kDC + d] = (unsigned char)bits;
    }
    __syncthreads();
    // the masked depth [column][h][d], read along depth's innermost dimension
    const int total = kWT * p.fh * kDC;
    for (int base = tid; base < total; base += kThreads * kBatch) {
      T v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * kThreads;
        v[u] = zero<T>();
        if (i < total) {
          int d, h, wl;
          tile_coords(i, d_inner, d, h, wl);
          if ((zbits[h * kDC + d] >> wl) & 1u) v[u] = dep_m[d * p.sdd + h * p.sdh + wl * p.sdw];
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * kThreads;
        if (i < total) {
          int d, h, wl;
          tile_coords(i, d_inner, d, h, wl);
          dep[wl * slab + h * kDS + d] = v[u];
        }
      }
    }
    __syncthreads();
    for (int wl = 0; wl < nw; ++wl) {
      contract<NT>(dep + wl * slab, ctxs + wl * ctx_slab, prod, p.kp, p.fh, p.c);
      __syncthreads();
      // runs of consecutive bins bound for one cell: one 16-byte add each
      const int* col = cells + wl * kDC;
      for (Walk q(p.c / 4); q.h < nd; q.next()) {
        const int d = q.h, g = col[d];
        if (g < 0 || g >= p.n_cells || (d > 0 && col[d - 1] == g)) continue;
        float4 s = *reinterpret_cast<const float4*>(prod + d * cs + q.ch * 4);
        int e = d + 1;
        for (; e < nd && col[e] == g; ++e) {
          const float4 v = *reinterpret_cast<const float4*>(prod + e * cs + q.ch * 4);
          s.x += v.x;
          s.y += v.y;
          s.z += v.z;
          s.w += v.w;
        }
        atomicAdd(reinterpret_cast<float4*>(p.acc + ((int64_t)m * p.n_cells + g) * p.c) + q.ch, s);
        merged += 4 * (e - d);
        ++issued;
      }
      __syncthreads();
    }
  }
  if (p.adds && issued) {
    atomicAdd(p.adds, (unsigned long long)merged);
    atomicAdd(p.adds + 1, (unsigned long long)issued);
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

template <typename T, int NT>
int launch(Params p, cudaStream_t st) {
  p.kp = (p.fh + 15) / 16 * 16;
  const size_t smem = smem_bytes<T>(p.kp, p.c);
  cudaError_t e = cudaFuncSetAttribute(lift_splat_kernel<T, NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, occ = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, lift_splat_kernel<T, NT>, kThreads,
                                                      smem);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(lift_splat_kernel<T, NT>),
                                          dim3(occ * sms), dim3(kThreads), args, smem, st);
}

// the warp's share of the 8-channel tiles: up to 5 (C <= 80) or 8
template <typename T>
int launch_c(const Params& p, cudaStream_t st) {
  return p.c <= 80 ? launch<T, 5>(p, st) : launch<T, 8>(p, st);
}

}  // namespace

// depth [M, D, fh, fw] with strides sd* and ctx [M, fh, fw, C] with strides
// sc* (elements; dtype 0 = float32, 1 = bfloat16), idx [M, D, fw] int32 in
// [0, n_cells] (n_cells = trash) and zvalid [M, D, fh, fw] bool, both
// contiguous; acc float32 scratch of M * n_cells * C values; barrier two
// uint32 that are zero before the first call (every call leaves them so);
// out [M, n_cells, C] of the inputs' dtype; adds null, or two uint64 that
// the launch adds its counts to (see the top of this file). C a multiple of
// 8 up to 128, fh up to 64. Returns the cudaError_t.
extern "C" int lift_splat(int dtype, const void* depth, long long sdm, long long sdd,
                          long long sdh, long long sdw, const void* ctx, long long scm,
                          long long sch, long long scw, long long scc, const int* idx,
                          const bool* zvalid, int m, int d_bins, int fh, int fw, int c,
                          int n_cells, float* acc, unsigned* barrier, void* out,
                          unsigned long long* adds, void* stream) {
  if (c % 8 != 0 || c < 8 || c > kMaxC || fh < 1 || fh > 64 || m < 1 || n_cells < 1)
    return (int)cudaErrorInvalidValue;
  Params p{depth, sdm, sdd, sdh, sdw, ctx, scm, sch, scw, scc, idx, zvalid, m, d_bins, fh, fw,
           c, n_cells, 0, fw % kWT == 0 && reinterpret_cast<uintptr_t>(zvalid) % kWT == 0,
           acc, barrier, out, adds};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_c<float>(p, st);
  if (dtype == 1) return launch_c<__nv_bfloat16>(p, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
