// Kernel K3: circle NMS keep mask, one thread-block cluster per (batch, task)
// row, one launch for all rows.
//
// Replaces the JAX package's device formulation
// mm_training_tpu/ops/circle_nms.py::circle_nms_mask (an argsort, a K x K
// distance matrix and a lax.fori_loop of K masked updates).
//
// The kernel takes the rows unsorted and writes the keep mask in slot order.
// A cluster of 8 CTAs serves one row:
//   1. rank 0 sorts the row: a bitonic sort of 64-bit (key, slot) words,
//      key = valid ? score : -inf, padded to the next power of two (at
//      least 32, one warp: a shorter sort costs no less). Thread
//      e holds word e in a register; a stage whose partners lie within a
//      warp exchanges them by shuffle, a wider one through shared memory
//      (two buffers in turn, one barrier a stage). The order is key
//      descending, then slot ascending, the order of
//      torch.sort(descending=True, stable=True) and of jnp.argsort(-key)
//      for NaN-free scores. Rank 0 then gathers the sorted centres and the
//      validity (one bit a box, 32 boxes a word);
//   2. after cluster.sync(), every rank copies the sorted centres from rank
//      0 through distributed shared memory and builds its share of the
//      upper-triangular "close" bitmask: bit b of word (i, w) is set when
//      box j = 32 w + b > i lies within the row's threshold of box i (the
//      squared centre distance against the raw min_radius value, as
//      CenterPoint compares it). One thread computes one word with 32 pair
//      tests, a warp a 32 x 32 block of words, the blocks dealt out over
//      the cluster's warps; each word is stored into rank 0's shared
//      memory;
//   3. after a second cluster.sync(), one warp of rank 0 sweeps the row in
//      32-box chunks. Lane l holds the valid and the removed word of chunk
//      l in registers. For chunk c it takes the valid boxes not yet removed
//      (one shuffle from lane c), resolves the chunk's 32 x 32 diagonal
//      block in registers (visiting the kept boxes with a close later box
//      of the chunk when there are few, all 32 steps unrolled otherwise),
//      and each lane
//      l > c ORs the kept boxes' words of column l into its removed word.
//      The dependent chain is a few integer operations a box;
//   4. rank 0 scatters the kept bits back to slot order.
//
// Bound: operations. K(K-1)/2 fp32 distances a row against kilobytes of
// input; the greedy order makes the sweep sequential, so a row's latency
// has a floor of K dependent steps. Distances round each step with
// __fsub_rn / __fmul_rn / __fadd_rn (no FMA contraction), as the JAX and
// plain versions do, so the masks agree exactly. K <= 1024: the bitmask
// (<= 128 KB) lives in rank 0's shared memory, one word a lane per chunk.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;      // CTAs a row (the portable cluster size)
constexpr int kThreads = 1024;  // one sort word a thread (K <= 1024)
constexpr int kMaxK = 1024;
constexpr int kMaxTasks = 16;
// The sweep resolves a diagonal block by visiting its boxes with a close
// later box when at most this many need it, else in 32 unrolled steps. Any
// value from 2 to 16 times the same within 0.3 us on sparse, clustered and
// dense rows; 0 (always unrolled) is ~1 us slower on sparse rows, 32
// (never unrolled) 3-8 us slower on dense ones (exps/profile_nms.py).
constexpr int kSparseVisits = 8;

struct Thresholds {             // per-task thresholds by value: row r uses v[r % n]
  int n;
  float v[kMaxTasks];
};

// 1 when the squared centre distance of i and j is <= th, rounded as the
// JAX and plain versions round it
__device__ __forceinline__ unsigned is_near(float xi, float yi, float xj, float yj, float th) {
  const float dx = __fsub_rn(xi, xj), dy = __fsub_rn(yi, yj);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <= th ? 1u : 0u;
}

// a float's bits, ordered as unsigned integers as the floats are ordered;
// -0 is first turned into +0 so that equal keys keep the slot order
__device__ __forceinline__ unsigned ordered_bits(float f) {
  const unsigned u = __float_as_uint(__fadd_rn(f, 0.f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ void sort_barrier(int n) {   // barrier 1, for the n sorting threads
  asm volatile("bar.sync 1, %0;" ::"r"(n) : "memory");
}

// Bitonic sort, descending, of the words held by threads 0 .. N - 1 (one
// each, N >= 32). A stage
// whose partners lie within a warp exchanges them by shuffle, a wider one
// through key (two buffers of N in turn, one barrier a stage). The sorted
// words end in key[0 .. N).
template <int N>
__device__ __forceinline__ void bitonic_sort(unsigned long long v, unsigned long long* key,
                                             int tid) {
  int buf = 0;
#pragma unroll
  for (int size = 2; size <= N; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      unsigned long long other;
      if (stride >= 32) {
        key[buf * N + tid] = v;
        sort_barrier(N);
        other = key[buf * N + (tid ^ stride)];
        buf ^= 1;
      } else {
        other = __shfl_xor_sync(0xffffffffu, v, stride);
      }
      // the lower index of a pair keeps the larger word in a descending
      // run (tid & size == 0), the smaller in an ascending one
      const bool keep_max = ((tid & size) == 0) == ((tid & stride) == 0);
      if (keep_max != (v > other)) v = other;
    }
  }
  if (N >= 64) sort_barrier(N);   // a slower warp may still read buffer 0
  if (tid < N) key[tid] = v;
}

__global__ void __launch_bounds__(kThreads)
circle_nms_kernel(const float* __restrict__ centers,  // [R, K, 2], strided
                  int64_t c_row, int64_t c_box,       // strides in floats
                  const float* __restrict__ scores,   // [R, K]
                  const bool* __restrict__ valid,     // [R, K]
                  const float* __restrict__ thresh,   // [R] (stride th_step)
                  int th_step, Thresholds th_vals,    // or by value
                  bool* __restrict__ keep,            // [R, K] slot order
                  int k, int n_pad, int col_stride) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int64_t row = blockIdx.x / kCluster;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = (k + 31) >> 5;

  // the same layout in every CTA; the keys and the bitmask are rank 0's
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* key = reinterpret_cast<unsigned long long*>(smem);  // [2][n_pad]
  float* cx = reinterpret_cast<float*>(key + 2 * n_pad);                // [32 nw] sorted
  float* cy = cx + 32 * nw;
  unsigned* vwords = reinterpret_cast<unsigned*>(cy + 32 * nw);         // [32] valid bits
  unsigned* keepw = vwords + 32;                                        // [32] kept bits
  unsigned* close = keepw + 32;   // [nw columns][col_stride]: word (i, w) at w col_stride + i

  if (rank == 0) {
    // 1. the sort: (ordered key << 32) | ~slot, descending; padding is 0
    unsigned long long v = 0ull;
    if (tid < k) {
      const float s = valid[row * k + tid] ? scores[row * k + tid] : -__int_as_float(0x7f800000);
      v = ((unsigned long long)ordered_bits(s) << 32) | (0xffffffffu - (unsigned)tid);
    }
    if (tid < n_pad) {
      switch (n_pad) {
        case 32: bitonic_sort<32>(v, key, tid); break;
        case 64: bitonic_sort<64>(v, key, tid); break;
        case 128: bitonic_sort<128>(v, key, tid); break;
        case 256: bitonic_sort<256>(v, key, tid); break;
        case 512: bitonic_sort<512>(v, key, tid); break;
        default: bitonic_sort<1024>(v, key, tid); break;
      }
    }
    __syncthreads();
    // the sorted centres (zero past K) and one validity bit a box
    for (int cw = warp; cw < nw; cw += kThreads / 32) {
      const int p = 32 * cw + lane;
      bool ok = false;
      float x = 0.f, y = 0.f;
      if (p < k) {
        const unsigned slot = 0xffffffffu - (unsigned)key[p];
        const float* c = centers + row * c_row + (int64_t)slot * c_box;
        x = c[0];
        y = c[1];
        ok = valid[row * k + slot];
      }
      cx[p] = x;
      cy[p] = y;
      const unsigned bits = __ballot_sync(0xffffffffu, ok);
      if (lane == 0) vwords[cw] = bits;
    }
  }
  cluster.sync();

  // 2. the bitmask, spread over the cluster
  if (rank != 0) {
    const float* rx = cluster.map_shared_rank(cx, 0);
    const float* ry = cluster.map_shared_rank(cy, 0);
    for (int p = tid; p < 32 * nw; p += kThreads) {
      cx[p] = rx[p];
      cy[p] = ry[p];
    }
    __syncthreads();
  }
  unsigned* close0 = cluster.map_shared_rank(close, 0);
  float th;
  if (thresh) {
    th = thresh[row * th_step];
  } else {   // a select chain, not a dynamic index (which would copy v to local memory)
    const int t = (int)row % th_vals.n;   // rows < 2^28: a 32-bit remainder
    th = th_vals.v[0];
#pragma unroll
    for (int u = 1; u < kMaxTasks; ++u)
      if (u == t) th = th_vals.v[u];
  }
  // one warp a 32 x 32 block of words: rows 32 a + lane of column w >= a,
  // blocks numbered column by column (column w starts at w (w + 1) / 2)
  // and dealt to the ranks in turn
  const int n_blocks = nw * (nw + 1) / 2;
  for (int blk = warp * kCluster + (int)rank; blk < n_blocks;
       blk += kCluster * (kThreads / 32)) {
    int w = (int)((sqrtf(8.f * blk + 1.f) - 1.f) * 0.5f);
    if ((w + 1) * (w + 2) / 2 <= blk) ++w;
    if (w * (w + 1) / 2 > blk) --w;
    const int i = 32 * (blk - w * (w + 1) / 2) + lane;
    if (i >= k) continue;
    const float xi = cx[i], yi = cy[i];
    const float4* xj = reinterpret_cast<const float4*>(cx + 32 * w);
    const float4* yj = reinterpret_cast<const float4*>(cy + 32 * w);
    unsigned bits = 0u;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float4 x = xj[q], y = yj[q];
      bits |= is_near(xi, yi, x.x, y.x, th) << (4 * q);
      bits |= is_near(xi, yi, x.y, y.y, th) << (4 * q + 1);
      bits |= is_near(xi, yi, x.z, y.z, th) << (4 * q + 2);
      bits |= is_near(xi, yi, x.w, y.w, th) << (4 * q + 3);
    }
    if ((i >> 5) == w) bits &= ~((2u << (i & 31)) - 1u);   // only j > i
    if (32 * w + 32 > k) bits &= (1u << (k - 32 * w)) - 1u;  // only j < K
    close0[w * col_stride + i] = bits;
  }
  cluster.sync();
  if (rank != 0) return;

  // 3. the sweep, one warp
  if (warp == 0) {
    const unsigned valid_mine = lane < nw ? vwords[lane] : 0u;
    unsigned removed = 0u, kept_mine = 0u;
    unsigned diag_next = lane < k ? close[lane] : 0u;   // chunk 0's diagonal block
    for (int c = 0; c < nw; ++c) {
      const unsigned diag = diag_next;                  // row 32 c + lane, column c
      if (c + 1 < nw) {
        const int p = 32 * (c + 1) + lane;
        diag_next = p < k ? close[(c + 1) * col_stride + p] : 0u;
      }
      const unsigned has_near = __ballot_sync(0xffffffffu, diag != 0u);
      unsigned alive = __shfl_sync(0xffffffffu, valid_mine & ~removed, c);
      // the diagonal block: in order, each kept box removes its later
      // close boxes of the chunk. Few boxes with a close later box of the
      // chunk: visit those still kept, the lowest first (a dependent
      // shuffle each); more: all 32 steps unrolled (independent shuffles)
      unsigned todo = alive & has_near;
      if (__popc(todo) <= kSparseVisits) {
        while (todo) {
          const unsigned d = __shfl_sync(0xffffffffu, diag, __ffs(todo) - 1);
          alive &= ~d;
          todo = (todo & (todo - 1)) & alive;
        }
      } else {
#pragma unroll
        for (int b = 0; b < 32; ++b) {
          const unsigned d = __shfl_sync(0xffffffffu, diag, b);
          alive = ((alive >> b) & 1u) ? (alive & ~d) : alive;
        }
      }
      if (lane == c) kept_mine = alive;
      if (lane > c && lane < nw) {
        // rows 32 c .. 32 c + 31 of column lane, all below K here, read
        // 16 bytes at a time
        const uint4* col = reinterpret_cast<const uint4*>(close + lane * col_stride + 32 * c);
        unsigned acc[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const uint4 r = col[q];
          if ((alive >> (4 * q)) & 1u) acc[0] |= r.x;
          if ((alive >> (4 * q + 1)) & 1u) acc[1] |= r.y;
          if ((alive >> (4 * q + 2)) & 1u) acc[2] |= r.z;
          if ((alive >> (4 * q + 3)) & 1u) acc[3] |= r.w;
        }
        removed |= (acc[0] | acc[1]) | (acc[2] | acc[3]);
      }
    }
    keepw[lane] = kept_mine;
  }
  __syncthreads();

  // 4. back to slot order
  for (int p = tid; p < k; p += kThreads) {
    const unsigned slot = 0xffffffffu - (unsigned)key[p];
    keep[row * k + slot] = (keepw[p >> 5] >> (p & 31)) & 1u;
  }
}

}  // namespace

// centers: fp32 [R, K, 2] with strides (c_row, c_box, 1) in floats; scores
// fp32 and valid bool, contiguous [R, K]; keep bool [R, K]. Thresholds:
// thresh [R] fp32 on the device read at row * th_step (th_step 0: one
// value), or, when thresh is null, n_vals (1 .. 16) host floats, row r
// using vals[r % n_vals]. K <= 1024. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for arguments out of range).
extern "C" int circle_nms(const float* centers, long long c_row, long long c_box,
                          const float* scores, const bool* valid, const float* thresh,
                          int th_step, const float* vals, int n_vals, bool* keep,
                          long long rows, int k, void* stream) {
  if (rows == 0 || k == 0) return 0;
  if (k > kMaxK || rows * kCluster > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Thresholds tv{};
  if (!thresh) {
    if (n_vals < 1 || n_vals > kMaxTasks) return (int)cudaErrorInvalidValue;
    tv.n = n_vals;
    for (int t = 0; t < n_vals; ++t) tv.v[t] = vals[t];
  }
  const int nw = (k + 31) / 32;
  int n_pad = 32;
  while (n_pad < k) n_pad <<= 1;
  // col_stride = 4 mod 32: 16-byte aligned columns, and the sweep's lanes
  // read 16 bytes each from distinct banks, 8 lanes a wavefront
  const int col_stride = (k + 27) / 32 * 32 + 4;
  const size_t smem = sizeof(unsigned long long) * 2 * n_pad + sizeof(float) * 2 * 32 * nw +
                      sizeof(unsigned) * (64 + (size_t)nw * col_stride);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        circle_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows * kCluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, circle_nms_kernel, centers, (int64_t)c_row,
                                           (int64_t)c_box, scores, valid, thresh, th_step, tv,
                                           keep, k, n_pad, col_stride);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
