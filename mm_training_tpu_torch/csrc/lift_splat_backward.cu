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
// 7.4 GFLOP at B=4, 0.0075 ms on the tensor cores.
//
// One launch a call, no atomics, deterministic: a block owns one image
// column (m, w) of one camera and walks the depth bins in tiles of kBD.
//   * It keeps the column's ctx [fH][C] in shared memory for the whole
//     walk, in the input dtype, and its d ctx [fH][C] in registers: the
//     fragments of its mma tiles in bf16, 4 rows x 8 channels a thread in
//     fp32; every d ctx element is written once, at the end.
//   * A tile's gathered g rows [kBD][C] (the trash cell and the bins past D
//     read as zeros: cp.async with src-size 0), its masked depth [kBD][fH]
//     and its zvalid are double-buffered: the next tile's g rows are in
//     flight (cp.async) and its depth and zvalid in registers (read along
//     whichever of bins and rows is innermost in memory) while the current
//     tile's products run. The cells of the tile after next are read then
//     too, so the g rows' copies never wait for an index.
//   * bf16: both products on the tensor cores, mma.sync m16n8k16 with fp32
//     sums (bf16 products are exact in fp32; the masked depth is 0 or the
//     bf16 value):
//       d depth tile [kBD x fH] = G [kBD x C] . ctx^T [C x fH]  (C padded
//         to 16 with zeros; a warp a 16-bin x 8-row tile or two),
//       d ctx [fH x C] += masked^T [fH x kBD] . G [kBD x C]  (fH padded to
//         16; the (16-row, 8-channel) tiles dealt round the warps).
//     fp32: fp32 FMAs on the CUDA cores, never TF32.
//   * The d depth tile is staged in shared memory and written along the
//     innermost dimension of d depth's layout.
// Sums are fp32 in a fixed order (bins in order for d ctx, channels in
// order for d depth), each output rounded once to its dtype: the same bits
// on every call. The wrapper passes every tensor's strides (elements);
// nothing is copied. g's rows go by cp.async when its channels are
// contiguous and its rows 16-byte aligned, else by plain loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBD = 32;          // depth bins a tile
constexpr int kMaxH = 64;        // fH up to 64
constexpr int kMaxC = 128;       // C up to 128
constexpr int kDep = kBD * kMaxH / kThreads;   // depth values a thread brings a tile

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
  int g_vec;                             // g's rows can be copied 16 bytes at a time
};

// Shared memory, in this order: ctx [kMaxH][CS], g rows [2][kBD][CS], masked
// depth [2][kBD][HS], the staged d depth [kBD][OS] (all T), zvalid
// [2][kBD][kMaxH] bytes. Row strides padded by 16 bytes, so the 8 rows an
// ldmatrix reads lie on distinct banks.
template <typename T> struct Smem {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int CS = kMaxC + V;
  static constexpr int HS = kMaxH + V;
  static constexpr int OS = kMaxH + 2;
  static constexpr int GV = kBD * (kMaxC / V) / kThreads;   // g-row chunks a thread copies
  static constexpr size_t kBytes =
      sizeof(T) * ((size_t)kMaxH * CS + 2 * kBD * CS + 2 * kBD * HS + kBD * OS) +
      (size_t)2 * kBD * kMaxH;
};

__device__ __forceinline__ uint32_t smem_addr(const void* q) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(q));
}

// 16 bytes global -> shared; src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* q) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(q)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* q) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(q)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* q) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(q)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* q) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(q)));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The products of one tile and the d ctx sums. d depth goes to os [kBD][OS]
// (masked by zvalid, rounded to T); rows past fH and bins past the tile's are
// computed on zero padding and not written.
template <typename T> struct Products;

// bf16 on the tensor cores. d depth: warp w takes bins 16 (w % 2) .. +16
// and the 8-row tiles w / 2 and w / 2 + 4. d ctx: the (16-row, 8-channel)
// tiles p = w + 8 j, row-major over (fH / 16 rounded up) x C / 8, at most 8
// a warp, whose fragments stay in registers.
template <> struct Products<__nv_bfloat16> {
  using S = Smem<__nv_bfloat16>;
  float acc[8][4];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
  __device__ __forceinline__ void tile(const __nv_bfloat16* ctx_s, const __nv_bfloat16* g_s,
                                       const __nv_bfloat16* dep_s, const unsigned char* z_s,
                                       __nv_bfloat16* os, int fh, int c) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
    // d depth = G ctx^T over C padded to 16 (ctx and G zero there)
    {
      const int mt = warp & 1, nht = (fh + 7) / 8;
      float dd[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int k0 = 0; k0 < c; k0 += 16) {
        uint32_t a[4];
        ldsm_x4(a, g_s + (mt * 16 + (lane & 15)) * S::CS + k0 + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int nt = (warp >> 1) + 4 * j;
          if (nt >= nht) continue;
          uint32_t b[2];
          ldsm_x2(b, ctx_s + (nt * 8 + (lane & 7)) * S::CS + k0 + ((lane >> 3) & 1) * 8);
          mma_bf16(dd[j], a, b);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int nt = (warp >> 1) + 4 * j;
        if (nt >= nht) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = mt * 16 + g + (e >> 1) * 8, hh = nt * 8 + 2 * tig + (e & 1);
          os[d * S::OS + hh] = __float2bfloat16_rn(z_s[d * kMaxH + hh] ? dd[j][e] : 0.f);
        }
      }
    }
    // d ctx += masked^T G over the tile's bins
    const int nct = c / 8, npairs = (fh + 15) / 16 * nct;
#pragma unroll
    for (int k0 = 0; k0 < kBD; k0 += 16) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int pr = warp + kWarps * j;
        if (pr >= npairs) break;
        const int mt = pr / nct, ct = pr % nct;
        uint32_t a[4], b[2];
        ldsm_x4_t(a, dep_s + (k0 + (lane & 7) + ((lane >> 4) << 3)) * S::HS + mt * 16 +
                         ((lane >> 3) & 1) * 8);
        ldsm_x2_t(b, g_s + (k0 + (lane & 15)) * S::CS + ct * 8);
        mma_bf16(acc[j], a, b);
      }
    }
  }
  __device__ __forceinline__ void store(__nv_bfloat16* d_ctx, long long sfh, long long sfc,
                                        int fh, int c) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
    const int nct = c / 8, npairs = (fh + 15) / 16 * nct;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int pr = warp + kWarps * j;
      if (pr >= npairs) break;
      const int mt = pr / nct, ct = pr % nct;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = mt * 16 + g + (e >> 1) * 8, ch = ct * 8 + 2 * tig + (e & 1);
        if (hh < fh) d_ctx[hh * sfh + ch * sfc] = __float2bfloat16_rn(acc[j][e]);
      }
    }
  }
};

// fp32: thread (ty, tx) = (tid / 16, tid % 16). d depth: bins ty, ty + 16,
// rows tx + 16 b; d ctx: rows ty + 16 i, channels tx + 16 j (4 x 8 sums)
template <> struct Products<float> {
  using S = Smem<float>;
  float acc[4][8];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  __device__ __forceinline__ void tile(const float* ctx_s, const float* g_s, const float* dep_s,
                                       const unsigned char* z_s, float* os, int fh, int c) {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    float s[2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
    for (int ch = 0; ch < c; ++ch) {
      float gv[2], cv[4];
#pragma unroll
      for (int a = 0; a < 2; ++a) gv[a] = g_s[(ty + 16 * a) * S::CS + ch];
#pragma unroll
      for (int b = 0; b < 4; ++b) cv[b] = ctx_s[(tx + 16 * b) * S::CS + ch];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) s[a][b] = fmaf(gv[a], cv[b], s[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int d = ty + 16 * a, hh = tx + 16 * b;
        if (hh < fh) os[d * S::OS + hh] = z_s[d * kMaxH + hh] ? s[a][b] : 0.f;
      }
    for (int d = 0; d < kBD; ++d) {
      float dv[4], gv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) dv[i] = dep_s[d * S::HS + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) gv[j] = g_s[d * S::CS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(dv[i], gv[j], acc[i][j]);
    }
  }
  __device__ __forceinline__ void store(float* d_ctx, long long sfh, long long sfc, int fh,
                                        int c) const {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int hh = ty + 16 * i;
      if (hh >= fh) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ch = tx + 16 * j;
        if (ch < c) d_ctx[hh * sfh + ch * sfc] = acc[i][j];
      }
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) lift_splat_bwd_kernel(const Params p) {
  using S = Smem<T>;
  constexpr int V = S::V;
  extern __shared__ __align__(16) unsigned char sm[];
  T* ctx_s = reinterpret_cast<T*>(sm);                  // [kMaxH][CS]
  T* g_s = ctx_s + kMaxH * S::CS;                       // [2][kBD][CS]
  T* dep_s = g_s + 2 * kBD * S::CS;                     // [2][kBD][HS] masked depth
  T* o_s = dep_s + 2 * kBD * S::HS;                     // [kBD][OS] the tile's d depth
  unsigned char* z_s = reinterpret_cast<unsigned char*>(o_s + kBD * S::OS);   // [2][kBD][kMaxH]
  const int w = blockIdx.x, m = blockIdx.y, tid = threadIdx.x;
  const int fh = p.fh, c = p.c;
  const int cpad = (c + 15) / 16 * 16, fhp = (fh + 15) / 16 * 16;
  const int nvec = cpad / V;                            // 16-byte chunks of a g row
  const T* ctx = static_cast<const T*>(p.ctx) + (int64_t)m * p.scm + (int64_t)w * p.scw;
  const T* depth = static_cast<const T*>(p.depth) + (int64_t)m * p.sdm + (int64_t)w * p.sdw;
  const T* g = static_cast<const T*>(p.g) + (int64_t)m * p.sgm;
  T* d_depth = static_cast<T*>(p.d_depth) + (int64_t)m * p.sem + (int64_t)w * p.sew;
  const int* idx = p.idx + (int64_t)m * p.d_bins * p.fw + w;
  const unsigned char* zv =
      reinterpret_cast<const unsigned char*>(p.zvalid) + (int64_t)m * p.d_bins * fh * p.fw + w;
  // the depth tiles are read and d depth written along bins when bins are
  // innermost in memory (the channels-last softmax), else along rows
  const bool bins_fast = p.sdd <= p.sdh;
  const bool out_bins_fast = p.sed <= p.seh;
  const int ntiles = (p.d_bins + kBD - 1) / kBD;

  // the cells of a tile's g-row chunks this thread copies
  auto cells_of = [&](int tile, int (&cell)[S::GV]) {
#pragma unroll
    for (int u = 0; u < S::GV; ++u) {
      const int e = tid + u * kThreads, dd = e / nvec, d = tile * kBD + dd;
      cell[u] = (e < kBD * nvec && tile < ntiles && d < p.d_bins) ? __ldg(idx + (int64_t)d * p.fw)
                                                                  : p.n_cells;
    }
  };
  // the gathered g rows of a tile into buffer buf (zeros for the trash cell,
  // bins past D and channels past C)
  auto copy_g = [&](const int (&cell)[S::GV], int buf) {
    T* dst = g_s + buf * kBD * S::CS;
    if (p.g_vec) {
#pragma unroll
      for (int u = 0; u < S::GV; ++u) {
        const int e = tid + u * kThreads, dd = e / nvec, v = e % nvec;
        if (e >= kBD * nvec) break;
        const bool ok = cell[u] < p.n_cells && v * V < c;
        cp_async16(dst + dd * S::CS + v * V, ok ? g + (int64_t)cell[u] * p.sgg + v * V : g,
                   ok ? 16 : 0);
      }
    } else {
#pragma unroll
      for (int u = 0; u < S::GV; ++u) {
        const int e = tid + u * kThreads, dd = e / nvec, v = e % nvec;
        if (e >= kBD * nvec) break;
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const int ch = v * V + q;
          dst[dd * S::CS + ch] = cell[u] < p.n_cells && ch < c
              ? g[(int64_t)cell[u] * p.sgg + (int64_t)ch * p.sgc] : from_float<T>(0.f);
        }
      }
    }
  };
  // a tile's depth and zvalid: read into registers (both at once), then
  // stored, the depth masked
  T dv[kDep];
  unsigned char zr[kDep];
  auto read_depth = [&](int tile) {
    const int nd = min(kBD, p.d_bins - tile * kBD);
#pragma unroll
    for (int u = 0; u < kDep; ++u) {
      const int e = tid + u * kThreads;
      const int dd = bins_fast ? e % kBD : e / fh, hh = bins_fast ? e / kBD : e % fh;
      zr[u] = 0;
      dv[u] = from_float<T>(0.f);
      if (e < kBD * fh && dd < nd) {
        const int64_t di = tile * kBD + dd;
        zr[u] = __ldg(zv + (di * fh + hh) * p.fw);
        dv[u] = depth[di * p.sdd + (int64_t)hh * p.sdh];
      }
    }
  };
  auto store_depth = [&](int buf) {
#pragma unroll
    for (int u = 0; u < kDep; ++u) {
      const int e = tid + u * kThreads;
      if (e >= kBD * fh) break;
      const int dd = bins_fast ? e % kBD : e / fh, hh = bins_fast ? e / kBD : e % fh;
      dep_s[buf * kBD * S::HS + dd * S::HS + hh] = zr[u] ? dv[u] : from_float<T>(0.f);
      z_s[buf * kBD * kMaxH + dd * kMaxH + hh] = zr[u];
    }
  };

  // the column's ctx, zero past fH and C up to the products' padding
  for (int e = tid; e < fhp * cpad; e += kThreads) {
    const int hh = e / cpad, ch = e - hh * cpad;
    ctx_s[hh * S::CS + ch] = (hh < fh && ch < c)
        ? ctx[(int64_t)hh * p.sch + (int64_t)ch * p.scc] : from_float<T>(0.f);
  }
  int cell_next[S::GV], cell_after[S::GV];
  cells_of(0, cell_next);
  copy_g(cell_next, 0);
  cp_async_commit();
  read_depth(0);
  store_depth(0);
  cells_of(1, cell_next);

  Products<T> prod;
  prod.init();
  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1, nd = min(kBD, p.d_bins - t * kBD);
    cp_async_wait_all();
    __syncthreads();   // tile t landed; every thread is done with tile t - 1's buffers and o_s
    if (t + 1 < ntiles) {
      copy_g(cell_next, buf ^ 1);
      cp_async_commit();
      read_depth(t + 1);
      cells_of(t + 2, cell_after);
    }
    prod.tile(ctx_s, g_s + buf * kBD * S::CS, dep_s + buf * kBD * S::HS, z_s + buf * kBD * kMaxH,
              o_s, fh, c);
    if (t + 1 < ntiles) {
      store_depth(buf ^ 1);
#pragma unroll
      for (int u = 0; u < S::GV; ++u) cell_next[u] = cell_after[u];
    }
    __syncthreads();   // the tile's d depth is staged
    for (int e = tid; e < kBD * fh; e += kThreads) {
      const int dd = out_bins_fast ? e % kBD : e / fh, hh = out_bins_fast ? e / kBD : e % fh;
      if (dd < nd)
        d_depth[(int64_t)(t * kBD + dd) * p.sed + (int64_t)hh * p.seh] = o_s[dd * S::OS + hh];
    }
  }
  prod.store(static_cast<T*>(p.d_ctx) + (int64_t)m * p.sfm + (int64_t)w * p.sfw, p.sfh, p.sfc, fh,
             c);
}

template <typename T>
int launch(const Params& p, cudaStream_t st) {
  const size_t smem = Smem<T>::kBytes;
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
// contiguous. C a multiple of 8 up to 128, fh up to 64, M up to 65535.
// g_vec = 1: g's channels are contiguous (sgc = 1) and its base, row and
// camera strides 16-byte aligned. Writes every element of d_depth and d_ctx
// once. Returns the cudaError_t.
extern "C" int lift_splat_backward(
    int dtype, const void* g, long long sgm, long long sgg, long long sgc, const void* depth,
    long long sdm, long long sdd, long long sdh, long long sdw, const void* ctx, long long scm,
    long long sch, long long scw, long long scc, const int* idx, const bool* zvalid,
    void* d_depth, long long sem, long long sed, long long seh, long long sew, void* d_ctx,
    long long sfm, long long sfh, long long sfw, long long sfc, int m, int d_bins, int fh,
    int fw, int c, int n_cells, int g_vec, void* stream) {
  if (m == 0 || d_bins == 0 || fh == 0 || fw == 0 || c == 0) return 0;
  if (c % 8 || c > kMaxC || fh > kMaxH || m > 65535 || n_cells < 1)
    return (int)cudaErrorInvalidValue;
  Params p{g, sgm, sgg, sgc, depth, sdm, sdd, sdh, sdw, ctx, scm, sch, scw, scc, idx, zvalid,
           d_depth, sem, sed, seh, sew, d_ctx, sfm, sfh, sfw, sfc, m, d_bins, fh, fw, c,
           n_cells, g_vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, st);
  if (dtype == 1) return launch<__nv_bfloat16>(p, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
