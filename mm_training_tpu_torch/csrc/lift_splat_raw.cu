// Kernels K8 and K8': the raw-rig (non-factorized) lift-splat of the camera
// branch and its backward.
//
//   out[m, g, c] = sum over (d, p) with idx[m, d, p] == g of
//                  round_T(depth[m, d, p] * ctx[m, p, c])
//
// summed in float32 and returned in ctx's dtype T, the trash cell
// idx == n_cells (a frustum point off the grid) dropped. Replaces the JAX
// package's device formulation mm_training_tpu/ops/voxel_pooling.py:83-112
// lift_splat: per camera the [D*P, C] slab of products depth * ctx in the
// compute dtype ("the slab stays bf16": each product rounded to bf16), then
// a float32 segment-sum of its rows into n_cells + 1 cells, cast back.
//
// K8, one cooperative launch a call (a persistent grid of co-resident
// blocks, four a SM; four grid barriers between five phases). The kept rows
// are put in cell order first (BEVPoolv2's intervals, built on the card
// within the call), so every output cell is summed by one warp and written
// once: no float atomics and no float32 accumulator.
//   (a) count: a block takes 32 consecutive pixels of one camera at a time,
//       a warp 16 bins of them at once (each bin 128 contiguous bytes of the
//       index), counts the kept rows per cell in a shared-memory histogram
//       (n_cells up to kHistCells; beyond it, one integer atomic per run of
//       lanes bound for one cell, into device memory) and adds each non-zero
//       bin to the counts with one integer atomic. The grid also copies
//       ctx's rows into an aligned [M, P, C] copy when the path's view is
//       not (its rows start at odd addresses), for (d)'s 16-byte loads.
//   (b) scan: an exclusive prefix sum over the M x n_cells counts gives each
//       cell's interval of entries, and over their chunks (an interval cut
//       into ceil(count / chunk) near-equal pieces) the work units of (d),
//       each written as (cell, first entry, end, chunk); an empty cell is
//       written as zeros here. Two phases: each block sums a segment, then
//       scans it after the blocks before it.
//   (c) scatter: a warp takes 32 pixels x 32 bins; it loads their depth
//       into its own shared tile along the layout's contiguous axis (both
//       layouts of the path load coalesced) and writes each kept row's
//       8-byte entry (pixel, depth as float) into its cell's interval, at
//       places taken by one integer atomic per run of neighbouring pixels
//       bound for one cell, 8 bins' atomics in flight together.
//   (d) gather: a warp takes one work unit; lane groups of C / 8 lanes take
//       its entries in turn (32 read at once and handed round by shuffles),
//       multiply each depth by the pixel's ctx row (16 bytes a lane, from
//       L2), round each product to T as the JAX package does (packed HMUL2
//       in bf16) and sum in float32; the groups' sums are added in group
//       order. A cell of one chunk (nearly all) is written at once. A chunk
//       of a longer cell leaves its float32 partial over its own, already
//       read entries (a chunk holds at least chunk / 2 >= C / 2 entries of 8
//       bytes) and counts itself done; the last of the cell's chunks adds the
//       partials in chunk order and writes the cell.
// The entries of a cell come in the order the scatter's atomics give them:
// the sums agree with the plain version to float32 rounding, not bit for
// bit. Bound: device-memory bytes (depth, the int32 indices and ctx read
// once, the BEV written once; the indices are half of it). The design reads
// the indices twice, writes and reads the entries once (~31 MB at the B=4
// request) and gathers a ctx row from L2 for every kept row (620 MB at B=4):
// (c) and (d) are latency-bound chains a warp and take most of the time
// (exps/ablate_backward.py times each phase). Given a counter, a launch adds
// its counts: kept rows scattered, and the integer atomics of (a), (c) and
// (d). It has no float atomic to count: ops/build.py::float_atomics reads
// the built library's SASS for them.
//
// K8' (lift_splat_raw_backward), for the output gradient g [M, n_cells, C]:
//   d depth[m, d, p] = sum_c round_T(ctx[m, p, c] g[m, idx, c])   (0 for trash)
//   d ctx[m, p, c]   = sum_d round_T(depth[m, d, p] g[m, idx, c])
// the products rounded to T as autograd through the plain version rounds
// them, the sums in float32. A block owns 32 consecutive pixels of one
// camera; its C / 8 warps each take 8 channels of all 32 pixels, so a lane
// holds one pixel's 8 channels of ctx and of the d ctx sums in registers
// (three blocks an SM at the path's C = 80). The block walks the bins in
// chunks of 16: the chunk's cells and depths are one coalesced shared tile
// (loaded in the layout's contiguous order, the next chunk's loads issued
// before this chunk's gathers), 4 bins at a time: the g rows of the 4 bins
// (16 bytes a lane, from L2) are loaded together, a bin that none of the 32
// pixels keeps is skipped by a warp vote, each warp leaves its 8 channels' share of d depth in
// shared memory, and after one barrier the block adds the shares in warp
// order and writes d depth in the layout's contiguous order. No atomics;
// every output is written once in a fixed order: a second call gives the
// same bits. Bound: device-memory bytes (g, depth, ctx and the indices read
// once, d depth and d ctx written once); the gathered rows come from L2,
// and the gathers' latency sets the pace (exps/ablate_backward.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;              // K8
constexpr int kWarps = kThreads / 32;
constexpr int kCh = 8;                     // channels a lane
constexpr int kMaxC = 32 * kCh;
constexpr int kHistCells = 16384;          // K8's shared histogram: 64 KB
constexpr int kTileBins = 32;              // K8's depth tile in (c)
constexpr int kPad = 33;                   // shared tiles' row pitch (no bank conflicts)
constexpr int kMaxGrid = 4096;             // K8's block sums
constexpr int kUnroll = 2;                 // K8's entries in flight a lane group

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// 8 values at src, src + stride, ...; one 16/32-byte load when vec
template <typename T>
__device__ __forceinline__ Row<T> load_row(const T* src, long long stride, bool vec) {
  if (vec) return *reinterpret_cast<const Row<T>*>(src);
  Row<T> r;
#pragma unroll
  for (int k = 0; k < kCh; ++k) r.v[k] = src[k * stride];
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

// 8 float sums stored as T at dst (16-byte aligned)
__device__ __forceinline__ void store_row(float* dst, const float* v) {
  float4* d4 = reinterpret_cast<float4*>(dst);
  d4[0] = make_float4(v[0], v[1], v[2], v[3]);
  d4[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store_row(__nv_bfloat16* dst, const float* v) {
  uint4 pk;
  unsigned* w = reinterpret_cast<unsigned*>(&pk);
#pragma unroll
  for (int k = 0; k < kCh / 2; ++k) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    w[k] = *reinterpret_cast<const unsigned*>(&b);
  }
  *reinterpret_cast<uint4*>(dst) = pk;
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

// The kept lanes of a warp claim places in counters[cell]: each run of
// neighbouring lanes with one cell takes its places with one integer atomic
// (issued by its first lane), and lane u of each of the kN batches gets the
// counter's old value plus its rank in its run. The kN atomics are in flight
// together. Every lane of the warp calls it.
template <int kN>
__device__ __forceinline__ void warp_claim(int* counters, const int* cell, const bool* kept,
                                           int* at, unsigned long long* n) {
  const int lane = threadIdx.x & 31;
  int head[kN];
#pragma unroll
  for (int u = 0; u < kN; ++u) {
    const int prev = __shfl_up_sync(0xffffffffu, cell[u], 1);
    const bool cont = kept[u] && lane > 0 && prev == cell[u];   // same run as the lane before
    const unsigned starts = ~__ballot_sync(0xffffffffu, cont);    // lanes that begin a run (or none)
    const unsigned le = 0xffffffffu >> (31 - lane);               // lanes 0..lane
    head[u] = 31 - __clz(starts & le);
    const unsigned after = starts & ~le;                          // the next run's first lane
    const int len = (after ? __ffs(after) - 1 : 32) - lane;
    at[u] = 0;
    if (kept[u] && !cont) {
      at[u] = atomicAdd(counters + cell[u], len);
      ++*n;
    }
  }
#pragma unroll
  for (int u = 0; u < kN; ++u) at[u] = __shfl_sync(0xffffffffu, at[u], head[u]) + lane - head[u];
}

// a cell's chunks: ceil(count / chunk), none for an empty cell
__device__ __forceinline__ int chunks_of(int count, int chunk) {
  return (count + chunk - 1) / chunk;
}

// sum of v over the block (every thread gets it)
__device__ __forceinline__ unsigned long long block_sum(unsigned long long v,
                                                        unsigned long long* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) v += red[w];
  return v;
}

// exclusive prefix of v over the block's threads; *total the block's sum
__device__ __forceinline__ unsigned long long block_scan(unsigned long long v,
                                                         unsigned long long* red,
                                                         unsigned long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long t = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += t;
  }
  __syncthreads();
  if (lane == 31) red[warp] = inc;
  __syncthreads();
  unsigned long long before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += red[w];
    all += red[w];
  }
  *total = all;
  return before + inc - v;
}

struct Params {
  const void* depth;
  long long sdm, sdd, sdp;        // depth [M, D, P] strides, elements
  const void* ctx;
  long long scm, scp, scc;        // ctx [M, P, C] strides, elements
  int ctx_vec;                    // ctx's 8-channel rows: one aligned vector load
  const int* idx;                 // [M, D, P] contiguous
  int m, d_bins, p, c, n_cells, chunk;
  unsigned* barrier;              // [2], zero before the first call
  int* counts;                    // [M * n_cells], zero before and after a call
  int* off;                       // [M * n_cells + 2]: interval starts, entries, units
  int* cursor;                    // [M * n_cells]
  unsigned long long* block_sums; // [kMaxGrid]
  int4* units;                    // [cells + M*D*P / chunk + 1]: (cell, first entry,
                                  //  end, chunk or -1 for a cell of one chunk)
  int2* entries;                  // [M*D*P]: (pixel, depth) in cell order
  void* ctx_rows;                 // [M, P, C] aligned copy of ctx (when !ctx_vec)
  void* out;                      // [M, n_cells, C] contiguous
  unsigned long long* adds;       // [4] or null, see the top of this file
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 4) lift_splat_raw_kernel(const Params p) {
  extern __shared__ int smem[];   // (a) the histogram, (c) a depth tile a warp
  __shared__ unsigned long long red[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = (p.p + 31) / 32;
  const int64_t items = (int64_t)p.m * tiles;
  const int64_t cells = (int64_t)p.m * p.n_cells;
  const bool hist = p.n_cells <= kHistCells;
  unsigned long long n_a = 0, n_c = 0, n_d = 0, kept_rows = 0;

  // --- (a) count the kept rows of each cell
  if (hist)
    for (int i = tid; i < p.n_cells; i += kThreads) smem[i] = 0;
  __syncthreads();
  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    const int mi = (int)(item / tiles), pi = (int)(item - (int64_t)mi * tiles) * 32 + lane;
    const bool live = pi < p.p;
    const int* ip = p.idx + (int64_t)mi * p.d_bins * p.p + pi;
    int* cnt = p.counts + (int64_t)mi * p.n_cells;
    for (int d0 = warp * 16; d0 < p.d_bins; d0 += kWarps * 16) {
      int cell[16];
      bool kept[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        cell[u] = live && d0 + u < p.d_bins ? __ldg(ip + (int64_t)(d0 + u) * p.p) : p.n_cells;
        kept[u] = (unsigned)cell[u] < (unsigned)p.n_cells;
      }
      if (hist) {
#pragma unroll
        for (int u = 0; u < 16; ++u)
          if (kept[u]) atomicAdd(smem + cell[u], 1);
      } else {
        int at[8];
        warp_claim<8>(cnt, cell, kept, at, &n_a);
        warp_claim<8>(cnt, cell + 8, kept + 8, at, &n_a);
      }
    }
    if (hist) {
      __syncthreads();
      for (int i = tid; i < p.n_cells; i += kThreads) {
        const int v = smem[i];
        if (v) {
          atomicAdd(cnt + i, v);
          smem[i] = 0;
          ++n_a;
        }
      }
      __syncthreads();
    }
  }
  // ctx's rows into an aligned copy, for (d)'s 16-byte loads
  const T* ctx = static_cast<const T*>(p.ctx);
  long long scm = p.scm, scp = p.scp, scc = p.scc;
  if (!p.ctx_vec) {
    T* rows = static_cast<T*>(p.ctx_rows);
    const int groups8 = p.c / kCh;
    const int64_t n8 = (int64_t)p.m * p.p * groups8;
    for (int64_t i = (int64_t)blockIdx.x * kThreads + tid; i < n8; i += (int64_t)gridDim.x * kThreads) {
      const int64_t row = i / groups8;
      const int ch = (int)(i - row * groups8) * kCh, mi = (int)(row / p.p), pi = (int)(row - (int64_t)mi * p.p);
      *reinterpret_cast<Row<T>*>(rows + row * p.c + ch) =
          load_row(ctx + mi * p.scm + pi * p.scp + ch * p.scc, p.scc, false);
    }
    ctx = rows;
    scm = (long long)p.p * p.c;
    scp = p.c;
    scc = 1;
  }
  grid_barrier(p.barrier);

  // --- (b) scan: (units << 32 | entries) summed over a segment of cells a block
  const int64_t seg = (cells + gridDim.x - 1) / gridDim.x;
  const int64_t lo = blockIdx.x * seg, hi = lo + seg < cells ? lo + seg : cells;
  unsigned long long s = 0;
  for (int64_t i = lo + tid; i < hi; i += kThreads) {
    const int n = __ldcg(p.counts + i);
    s += ((unsigned long long)chunks_of(n, p.chunk) << 32) | (unsigned)n;
  }
  s = block_sum(s, red);
  if (tid == 0) p.block_sums[blockIdx.x] = s;
  grid_barrier(p.barrier);

  unsigned long long before = 0, all = 0;
  for (int b = tid; b < (int)gridDim.x; b += kThreads) {
    const unsigned long long v = __ldcg(p.block_sums + b);
    all += v;
    if (b < (int)blockIdx.x) before += v;
  }
  before = block_sum(before, red);
  all = block_sum(all, red);
  if (blockIdx.x == 0 && tid == 0) {
    p.off[cells] = (int)(all & 0xffffffffu);
    p.off[cells + 1] = (int)(all >> 32);
  }
  for (int64_t t0 = lo; t0 < hi; t0 += kThreads) {
    const int64_t i = t0 + tid;
    const int n = i < hi ? __ldcg(p.counts + i) : 0;
    const int nu = chunks_of(n, p.chunk);
    unsigned long long tile_total;
    const unsigned long long at =
        before + block_scan(((unsigned long long)nu << 32) | (unsigned)n, red, &tile_total);
    before += tile_total;
    if (i < hi) {
      const int e0 = (int)(at & 0xffffffffu), u0 = (int)(at >> 32);
      p.off[i] = e0;
      p.cursor[i] = e0;
      p.counts[i] = 0;     // zero again: (d) counts a long cell's chunks done here
      for (int j = 0; j < nu; ++j)
        p.units[u0 + j] = make_int4((int)i, e0 + (int)((int64_t)j * n / nu),
                                    e0 + (int)((int64_t)(j + 1) * n / nu), nu == 1 ? -1 : j);
      if (n == 0) {        // an empty cell: zeros
        uint4* o = reinterpret_cast<uint4*>(static_cast<T*>(p.out) + i * p.c);
        for (int k = 0; k < p.c * (int)sizeof(T) / 16; ++k) o[k] = make_uint4(0, 0, 0, 0);
      }
    }
  }
  grid_barrier(p.barrier);

  // --- (c) scatter the kept rows into their cells' intervals: a warp a
  // task of 32 pixels x 32 bins, its depth through its own shared tile
  float* tile = reinterpret_cast<float*>(smem) + warp * kTileBins * kPad;
  const T* depth = static_cast<const T*>(p.depth);
  const bool bins_fast = p.sdd == 1 || (p.sdd < p.sdp && p.sdp != 1);
  const int bin_tiles = (p.d_bins + kTileBins - 1) / kTileBins;
  const int64_t tasks = items * bin_tiles;
  for (int64_t t = (int64_t)blockIdx.x * kWarps + warp; t < tasks; t += (int64_t)gridDim.x * kWarps) {
    const int64_t item = t / bin_tiles;
    const int d0 = (int)(t - item * bin_tiles) * kTileBins;
    const int mi = (int)(item / tiles), p0 = (int)(item - (int64_t)mi * tiles) * 32;
    const int pi = p0 + lane;
    const bool live = pi < p.p;
    const int* ip = p.idx + (int64_t)mi * p.d_bins * p.p + pi;
    const T* dm = depth + mi * p.sdm;
    __syncwarp();   // the last task's tile is read
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {   // a lane a bin (bins contiguous) or a pixel
      const int b = bins_fast ? lane : j, x = bins_fast ? j : lane;
      const bool in = d0 + b < p.d_bins && p0 + x < p.p;
      tile[b * kPad + x] = in ? to_float(dm[(d0 + b) * p.sdd + (int64_t)(p0 + x) * p.sdp]) : 0.f;
    }
    __syncwarp();
    int* cur = p.cursor + (int64_t)mi * p.n_cells;
    for (int b0 = 0; b0 < kTileBins && d0 + b0 < p.d_bins; b0 += 16) {
      int cell[16], at[8];
      bool kept[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int d = d0 + b0 + u;
        cell[u] = live && d < p.d_bins ? __ldg(ip + (int64_t)d * p.p) : p.n_cells;
        kept[u] = (unsigned)cell[u] < (unsigned)p.n_cells;
      }
#pragma unroll
      for (int h = 0; h < 16; h += 8) {
        warp_claim<8>(cur, cell + h, kept + h, at, &n_c);
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (kept[h + u]) {
            p.entries[at[u]] = make_int2(pi, __float_as_int(tile[(b0 + h + u) * kPad + lane]));
            ++kept_rows;
          }
      }
    }
  }
  grid_barrier(p.barrier);

  // --- (d) gather: a warp a work unit (one chunk of one cell's interval);
  // lane groups of C / 8 lanes take the chunk's entries in turn, 32 entries
  // read by the warp at once and handed round by shuffles
  const int lanes = p.c / kCh, groups = 32 / lanes;
  const int grp = lane / lanes, lig = lane - grp * lanes, ch0 = lig * kCh;
  const bool active = grp < groups;
  const int n_units = __ldcg(p.off + cells + 1);
  const T* cbase = ctx + ch0 * scc;
  const int ustride = gridDim.x * kWarps;
  int u = blockIdx.x * kWarps + warp;
  int4 next = u < n_units ? __ldcg(p.units + u) : make_int4(0, 0, 0, 0);
  for (; u < n_units; u += ustride) {
    const int4 uc = next;   // (cell, first entry, end, chunk or -1)
    if (u + ustride < n_units) next = __ldcg(p.units + u + ustride);
    const int e_lo = uc.y, e_hi = uc.z;
    const T* cm = cbase + (uc.x / p.n_cells) * scm;
    float acc[kCh];
#pragma unroll
    for (int k = 0; k < kCh; ++k) acc[k] = 0.f;
    for (int base = e_lo; base < e_hi; base += 32) {
      const int nb = e_hi - base < 32 ? e_hi - base : 32;
      const int2 mine = lane < nb ? __ldcg(p.entries + base + lane) : make_int2(0, 0);
      for (int k0 = 0; k0 < nb; k0 += groups * kUnroll) {
        Row<T> cr[kUnroll];
        float dv[kUnroll];
#pragma unroll
        for (int v = 0; v < kUnroll; ++v) {
          const int kk = k0 + v * groups + grp;
          const int pix = __shfl_sync(0xffffffffu, mine.x, kk & 31);
          const float dep = __int_as_float(__shfl_sync(0xffffffffu, mine.y, kk & 31));
          const bool ok = active && kk < nb;
          cr[v] = ok ? load_row(cm + pix * scp, scc, true) : splat_row(from_float<T>(0.f));
          dv[v] = ok ? dep : 0.f;
        }
#pragma unroll
        for (int v = 0; v < kUnroll; ++v) {
          float prod[kCh];
          mul_rows(splat_row(from_float<T>(dv[v])), cr[v], prod);
#pragma unroll
          for (int k = 0; k < kCh; ++k) acc[k] = __fadd_rn(acc[k], prod[k]);
        }
      }
    }
    // the warp's lane groups added in group order into group 0
    for (int gq = 1; gq < groups; ++gq) {
#pragma unroll
      for (int k = 0; k < kCh; ++k) {
        const float t = __shfl_sync(0xffffffffu, acc[k], lig + gq * lanes);
        if (grp == 0) acc[k] = __fadd_rn(acc[k], t);
      }
    }
    T* dst = static_cast<T*>(p.out) + (int64_t)uc.x * p.c + ch0;
    if (uc.w < 0) {
      if (grp == 0) store_row(dst, acc);
      continue;
    }
    const int start = __ldcg(p.off + uc.x), count = __ldcg(p.off + uc.x + 1) - start;
    const int nch = chunks_of(count, p.chunk);
    // a chunk of a long cell: its partial over its own entries, then the
    // last chunk done adds the partials in chunk order
    float* part = reinterpret_cast<float*>(p.entries + e_lo) + ch0;
    __syncwarp();
    if (grp == 0) {
#pragma unroll
      for (int k = 0; k < kCh; k += 2)
        reinterpret_cast<float2*>(part)[k / 2] = make_float2(acc[k], acc[k + 1]);
    }
    __threadfence();
    __syncwarp();
    int done = 0;
    if (lane == 0) {
      done = atomicAdd(p.counts + uc.x, 1);
      ++n_d;
    }
    done = __shfl_sync(0xffffffffu, done, 0);
    if (done != nch - 1) continue;
    __threadfence();
    if (grp == 0) {
      float sum[kCh];
#pragma unroll
      for (int k = 0; k < kCh; ++k) sum[k] = 0.f;
      for (int j = 0; j < nch; ++j) {
        float v[kCh];
        if (j == uc.w) {
#pragma unroll
          for (int k = 0; k < kCh; ++k) v[k] = acc[k];
        } else {
          const float2* q = reinterpret_cast<const float2*>(reinterpret_cast<const float*>(
              p.entries + start + (int)((int64_t)j * count / nch)) + ch0);
#pragma unroll
          for (int k = 0; k < kCh; k += 2) {
            const float2 f = __ldcg(q + k / 2);
            v[k] = f.x;
            v[k + 1] = f.y;
          }
        }
#pragma unroll
        for (int k = 0; k < kCh; ++k) sum[k] = __fadd_rn(sum[k], v[k]);
      }
      store_row(dst, sum);
    }
    if (lane == 0) p.counts[uc.x] = 0;
  }

  if (p.adds) {
    if (kept_rows) atomicAdd(p.adds, kept_rows);
    if (n_a) atomicAdd(p.adds + 1, n_a);
    if (n_c) atomicAdd(p.adds + 2, n_c);
    if (n_d) atomicAdd(p.adds + 3, n_d);
  }
}

int64_t align16(int64_t n) { return (n + 15) / 16 * 16; }

// the workspace's parts, bytes from its start; the last is its size
struct Layout {
  int64_t off, cursor, block_sums, units, ctx_rows, entries, size;
  Layout(int m, int d_bins, int p, int c, int n_cells, int chunk, int elem) {
    const int64_t cells = (int64_t)m * n_cells, rows = (int64_t)m * d_bins * p;
    off = 0;
    cursor = align16((cells + 2) * 4);
    block_sums = cursor + align16(cells * 4);
    units = block_sums + kMaxGrid * 8;
    ctx_rows = units + align16((cells + rows / chunk + 1) * 16);
    entries = ctx_rows + align16((int64_t)m * p * c * elem);
    size = entries + rows * 8;
  }
};

template <typename T>
int launch(Params p, char* work, cudaStream_t st) {
  int dev = 0, sms = 0, occ = 0;
  const int tiles = kWarps * kTileBins * kPad;   // (c)'s depth tiles, floats
  const int smem = (p.n_cells <= kHistCells && p.n_cells > tiles ? p.n_cells : tiles) * 4;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(lift_splat_raw_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kHistCells * 4);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, lift_splat_raw_kernel<T>, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = occ * sms < kMaxGrid ? occ * sms : kMaxGrid;
  const Layout l(p.m, p.d_bins, p.p, p.c, p.n_cells, p.chunk, sizeof(T));
  p.off = reinterpret_cast<int*>(work + l.off);
  p.cursor = reinterpret_cast<int*>(work + l.cursor);
  p.block_sums = reinterpret_cast<unsigned long long*>(work + l.block_sums);
  p.units = reinterpret_cast<int4*>(work + l.units);
  p.entries = reinterpret_cast<int2*>(work + l.entries);
  p.ctx_rows = work + l.ctx_rows;
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(lift_splat_raw_kernel<T>),
                                          dim3(grid), dim3(kThreads), args, smem, st);
}

// ------------------------------------------------------------------- K8'

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

// kB bins a chunk (a shared tile), kG of them gathered at a time; a lane 8
// channels of one pixel, C / 8 warps a block, at most kMaxThreads threads
template <typename T, int kB, int kG, int kMaxThreads, int kMinBlocks>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks) lift_splat_raw_bwd_kernel(const BwdParams p) {
  constexpr int kMaxWarps = kMaxThreads / 32, kPF = 2;
  __shared__ int cell_s[2][kB * kPad];
  __shared__ float dep_s[2][kB * kPad];
  __shared__ float part_s[kMaxWarps * kB * kPad];   // [warp][bin][pixel] d depth shares
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = p.c / kCh, nt = nw * 32;
  const int tiles = (p.p + 31) / 32;
  const int mi = blockIdx.x / tiles, p0 = (blockIdx.x - mi * tiles) * 32;
  const int pi = p0 + lane;
  const bool live = pi < p.p;
  const int ch0 = warp * kCh;
  const T zero = from_float<T>(0.f);
  const T* depth = static_cast<const T*>(p.depth) + mi * p.sdm;
  const int* ip = p.idx + (int64_t)mi * p.d_bins * p.p;
  const T* g = static_cast<const T*>(p.g) + mi * p.sgm + ch0;
  const bool in_fast = p.sdd == 1 || (p.sdd < p.sdp && p.sdp != 1);    // depth: bins contiguous
  const bool out_fast = p.sed == 1 || (p.sed < p.sep && p.sep != 1);   // d depth: bins contiguous
  constexpr int per_chunk = kB * 32;

  // a chunk's (cell, depth) tile element i, in the depth layout's order
  auto element = [&](int d0, int i, int& b, int& x) {
    b = in_fast ? i % kB : i / 32;
    x = in_fast ? i / kB : i % 32;
    return d0 + b < p.d_bins && p0 + x < p.p;
  };
  // each thread's share of the next tile, loaded before this chunk's
  // gathers: kPF elements (all of it from kB * 16 threads up); beyond, in a
  // loop
  int pc[kPF];
  float pd[kPF];
  auto fetch = [&](int d0) {
#pragma unroll
    for (int r = 0; r < kPF; ++r) {
      const int i = tid + r * nt;
      int b, x;
      const bool in = i < per_chunk && element(d0, i, b, x);
      pc[r] = in ? __ldg(ip + (int64_t)(d0 + b) * p.p + p0 + x) : p.n_cells;
      pd[r] = in ? to_float(depth[(d0 + b) * p.sdd + (int64_t)(p0 + x) * p.sdp]) : 0.f;
    }
  };
  auto place = [&](int d0, int buf) {
#pragma unroll
    for (int r = 0; r < kPF; ++r) {
      const int i = tid + r * nt;
      int b, x;
      if (i < per_chunk) {
        element(d0, i, b, x);
        cell_s[buf][b * kPad + x] = pc[r];
        dep_s[buf][b * kPad + x] = pd[r];
      }
    }
    for (int i = tid + kPF * nt; i < per_chunk; i += nt) {
      int b, x;
      const bool in = element(d0, i, b, x);
      cell_s[buf][b * kPad + x] = in ? __ldg(ip + (int64_t)(d0 + b) * p.p + p0 + x) : p.n_cells;
      dep_s[buf][b * kPad + x] = in ? to_float(depth[(d0 + b) * p.sdd + (int64_t)(p0 + x) * p.sdp]) : 0.f;
    }
  };

  Row<T> cr = splat_row(zero);
  if (live) {
    const T* cp = static_cast<const T*>(p.ctx) + mi * p.scm + pi * p.scp + ch0 * p.scc;
#pragma unroll
    for (int k = 0; k < kCh; ++k) cr.v[k] = cp[k * p.scc];
  }
  float dc[kCh];
#pragma unroll
  for (int k = 0; k < kCh; ++k) dc[k] = 0.f;
  const bool vec = p.g_vec;
  T* dd = static_cast<T*>(p.d_depth) + mi * p.sem;

  fetch(0);
  place(0, 0);
  int buf = 0;
  for (int d0 = 0; d0 < p.d_bins; d0 += kB, buf ^= 1) {
    __syncthreads();   // this chunk's tile is in place; the last chunk's shares are read
    const bool next = d0 + kB < p.d_bins;
    if (next) fetch(d0 + kB);
    // kG bins' g rows in flight at a time
#pragma unroll
    for (int h = 0; h < kB; h += kG) {
      int cell[kG];
      unsigned any = 0;
#pragma unroll
      for (int u = 0; u < kG; ++u) {
        cell[u] = cell_s[buf][(h + u) * kPad + lane];
        any |= (unsigned)__any_sync(0xffffffffu, (unsigned)cell[u] < (unsigned)p.n_cells) << u;
      }
      if (!any) continue;   // no pixel of the block keeps these bins
      Row<T> gr[kG];
#pragma unroll
      for (int u = 0; u < kG; ++u)
        gr[u] = (unsigned)cell[u] < (unsigned)p.n_cells
                    ? load_row(g + (int64_t)cell[u] * p.sgg, 1, vec) : splat_row(zero);
#pragma unroll
      for (int u = 0; u < kG; ++u) {
        if (!((any >> u) & 1u)) continue;
        float pc_[kCh], pd_[kCh];
        mul_rows(cr, gr[u], pc_);
        mul_rows(splat_row(from_float<T>(dep_s[buf][(h + u) * kPad + lane])), gr[u], pd_);
        float share = 0.f;
#pragma unroll
        for (int k = 0; k < kCh; ++k) {
          dc[k] = __fadd_rn(dc[k], pd_[k]);
          share = __fadd_rn(share, pc_[k]);
        }
        part_s[(warp * kB + h + u) * kPad + lane] = share;
      }
    }
    if (next) place(d0 + kB, buf ^ 1);
    __syncthreads();   // every warp's shares of this chunk
    // d depth: the shares added in warp order, written in the layout's order
    for (int i = tid; i < per_chunk; i += nt) {
      const int b = out_fast ? i % kB : i / 32, x = out_fast ? i / kB : i % 32;
      if (d0 + b >= p.d_bins || p0 + x >= p.p) continue;
      const int cl = cell_s[buf][b * kPad + x];
      float v = 0.f;
      if ((unsigned)cl < (unsigned)p.n_cells)
        for (int w = 0; w < nw; ++w) v = __fadd_rn(v, part_s[(w * kB + b) * kPad + x]);
      dd[(d0 + b) * p.sed + (int64_t)(p0 + x) * p.sep] = from_float<T>(v);
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
  const int64_t blocks = (int64_t)p.m * ((p.p + 31) / 32);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  const int threads = p.c / kCh * 32;
  if (threads <= 320)        // the camera path's C = 80: three blocks an SM
    lift_splat_raw_bwd_kernel<T, 16, 4, 320, 3><<<grid, threads, 0, st>>>(p);
  else if (threads <= 512)
    lift_splat_raw_bwd_kernel<T, 16, 8, 512, 1><<<grid, threads, 0, st>>>(p);
  else
    lift_splat_raw_bwd_kernel<T, 4, 4, 1024, 1><<<grid, threads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of K8's workspace (device memory, no initial value) for these sizes
// (elem: the bytes of a ctx value).
extern "C" long long lift_splat_raw_workspace(int m, int d_bins, int p, int c, int n_cells,
                                              int chunk, int elem) {
  if (m < 1 || d_bins < 1 || p < 1 || c < 1 || n_cells < 1 || chunk < 1 || elem < 1) return -1;
  return Layout(m, d_bins, p, c, n_cells, chunk, elem).size;
}

// K8. depth [M, D, P] with strides sd*, ctx [M, P, C] with strides sc*
// (elements; dtype 0 = float32, 1 = bfloat16; ctx_vec = 1: its 8-channel
// rows are aligned contiguous vectors), idx [M, D, P] int32 in [0, n_cells]
// (n_cells = trash), contiguous; chunk the entries a work unit of (d) sums
// at most, even and at least C; words 2 + M * n_cells uint32 that are zero
// before the first call (every call leaves them so); work
// lift_splat_raw_workspace bytes, 16-byte aligned; out [M, n_cells, C]
// contiguous, of the inputs' dtype; adds null, or four uint64 that the
// launch adds its counts to (see the top of this file). C a multiple of 8 up
// to 256. Returns the cudaError_t.
extern "C" int lift_splat_raw(int dtype, const void* depth, long long sdm, long long sdd,
                              long long sdp, const void* ctx, long long scm, long long scp,
                              long long scc, int ctx_vec, const int* idx, int m, int d_bins,
                              int p, int c, int n_cells, int chunk, unsigned* words, void* work,
                              void* out, unsigned long long* adds, void* stream) {
  if (c % kCh != 0 || c < kCh || c > kMaxC || m < 1 || d_bins < 1 || p < 1 || n_cells < 1 ||
      chunk < c || chunk % 2 || (int64_t)m * d_bins * p >= 0x7fffffff ||
      (int64_t)m * n_cells >= 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  Params prm{depth, sdm, sdd, sdp, ctx, scm, scp, scc, ctx_vec, idx, m, d_bins, p, c, n_cells,
             chunk, words, reinterpret_cast<int*>(words + 2), nullptr, nullptr, nullptr,
             nullptr, nullptr, nullptr, out, adds};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* w = static_cast<char*>(work);
  if (dtype == 0) return launch<float>(prm, w, st);
  if (dtype == 1) return launch<__nv_bfloat16>(prm, w, st);
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
