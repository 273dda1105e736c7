// Kernel K5: the deformable 3x3 conv (DCNv1, one deform group, `groups`
// conv groups) after its offset conv, and the bilinear columns it is made of.
//
//   cols[b, p, t, :] = sum over the 4 corners k of x[b, corner_k] * w_k
//   out[b, p, g*og + o] = round(sum over (t, c) of cols[b, p, t, g*cg + c]
//                                  * W[g, t*cg + c, o]) + bias[g*og + o]
//
// for pixel p = (y, x), tap t = (ty, tx) of the 3x3 window, at the sampling
// point (y + ty - 1 + dy_t, x + tx - 1 + dx_t) with (dy_t, dx_t) the offsets
// the offset conv predicted. Corners outside the image weigh 0 (against a
// clipped row).
//
// Replaces the JAX package's device formulation
// mm_training_tpu/models/depth_net.py::DeformConv2d.__call__ (:46-110 without
// the offset conv): four flat row gathers from the [H*W, C] map, each
// weighted and added on flat rows in the input dtype (:56-90), then the
// grouped einsum over (tap, C/g) with fp32 sums, the cast and the bias
// (:100-110).
//
// Rounding, shared by both kernels (tap_corners, blend_add): as the JAX
// package and the plain PyTorch version do it, the coordinates and corner
// weights are fp32; each corner weight is rounded to the input dtype, each
// product and each running sum is rounded to the input dtype (__fmul_rn /
// __fadd_rn, or bf16x2 mul.rn / add.rn, whose single rounding of the exact
// bf16 product and sum gives the same bits; no FMA contraction). So the
// columns, and the fused kernel's A-tiles, equal the plain version's bit for
// bit.
//
// deform_sample: the columns [B, H*W, 9, C]. Bound by device-memory bytes
// (it writes 9 x the input's bytes). One thread per (pixel, tap, 16-byte
// channel vector). Off the serving path since the fused kernel; kept for
// the weight gradient of the training slice (dW = cols^T dY per group).
//
// deform_conv3x3: the fused op, which never writes a column. Bound by
// operations: 2 x B*H*W x C_out x 9 x C/g, 16.6 GFLOP for a 4-camera
// 44 x 80 x 512 frame (0.0168 ms on the tensor cores); the bytes of x, the
// offsets, the weights and the output are 31 MB. Design:
//   - a block computes 8 x 16 = 128 pixels x up to 128 output channels of
//     one group (grid: pixel tiles, groups x channel tiles, images), one
//     block an SM; bf16 takes 16 warps of 32 pixels x 32 channels;
//   - it walks K in chunks of (one tap, 128 bytes of input channels: 64
//     bf16), channel chunk outer, tap inner, so each chunk's halo is staged
//     once for 9 taps;
//   - halo: the chunk's channels of the pixel tile plus 1 + R (R = 3) pixels
//     on each side (1 + R + 1 below and right), 17 x 25 pixels, copied by
//     cp.async; a corner inside it is read from shared memory, one outside
//     (offsets beyond R px) from L2 (__ldg). The (pixel, tap) corner table
//     (halo or image index and rounded weight of each corner) is computed
//     once a block, while the first halo and B-tile are in flight;
//   - A-tile: each chunk's [128 pixels x 64 channels] is built in shared
//     memory from the corners, the 8 threads of a quarter warp one pixel's
//     128-byte row, so each corner read is one conflict-free wavefront
//     whatever the offsets (rows padded to 144 bytes: ldmatrix rows on
//     distinct banks), double-buffered, one barrier a chunk;
//   - B-tile: the weights, laid out once by the wrapper as [g, 9*cg, og]
//     (row tap * cg + c, the order read here), arrive by cp.async,
//     double-buffered, rows padded to 272 bytes;
//   - products: bf16 mma.sync m16n8k16 from ldmatrix with fp32
//     accumulators (bf16 products are exact in fp32); fp32 inputs take fp32
//     FMAs, never TF32;
//   - epilogue: each sum rounded once to the input dtype, then the bias
//     (in that dtype) added in that dtype, written NHWC.
// Shared memory sets the pace: the corner reads, the A-tile and the
// ldmatrix reads of A and B (each read by four warps) move about 236 KB a
// chunk through it (counted from the tile shapes, not measured), some 66 us
// at B=1 at 128 bytes a clock an SM, more than the products need on the
// tensor cores. What a wgmma version would need: the A-tile is a
// gather, which TMA cannot make, so the threads would still build it, in
// the 128-byte-swizzled K-major layout wgmma reads (a fence.proxy.async
// before the wgmma), with the weights laid out K-major too ([g, og, 9*cg])
// so B is K-major and could come by TMA; two warpgroups of m64n128k16 would
// read A once and B twice a chunk (48 KB instead of 128 KB of ldmatrix
// traffic), and producer warpgroups building the next A-tile while the
// consumers' wgmma runs would overlap the gather with the products.
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

// v rounded to T's precision, kept as a float
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V> __device__ __forceinline__ Pack<T, V> zero_pack() {
  Pack<T, V> p;
#pragma unroll
  for (int e = 0; e < V; ++e) p.v[e] = from_float<T>(0.f);
  return p;
}

// a 16-byte vector from global memory through the read-only path
template <typename T, int V> __device__ __forceinline__ Pack<T, V> ldg_pack(const T* q) {
  static_assert(sizeof(Pack<T, V>) == 16, "16-byte vectors");
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(q));
  Pack<T, V> r;
  *reinterpret_cast<uint4*>(&r) = u;
  return r;
}

// ---- the sampling, shared by both kernels

// The sampling point of tap t at pixel (py_i, px_i) with the tap's offsets
// o[0] (dy), o[1] (dx): its top-left corner and its fractional weights.
struct TapPoint {
  int y0i, x0i;
  float wy, wx;
};

__device__ __forceinline__ TapPoint tap_point(int py_i, int px_i, int t, const float* o) {
  // (iota + base tap) + offset, in fp32, in the JAX order
  const float py = __fadd_rn(__fadd_rn((float)py_i, (float)(t / 3 - 1)), o[0]);
  const float px = __fadd_rn(__fadd_rn((float)px_i, (float)(t % 3 - 1)), o[1]);
  const float y0 = floorf(py), x0 = floorf(px);
  return TapPoint{(int)y0, (int)x0, __fsub_rn(py, y0), __fsub_rn(px, x0)};
}

// corner k of a tap point (order (0, 0), (0, 1), (1, 0), (1, 1)) inside the image
__device__ __forceinline__ bool corner_inside(const TapPoint& tp, int k, int h, int w) {
  const int yi = tp.y0i + (k >> 1), xi = tp.x0i + (k & 1);
  return yi >= 0 && yi < h && xi >= 0 && xi < w;
}

// The four bilinear corners of tap t at pixel (py_i, px_i) with the tap's
// offsets o[0] (dy), o[1] (dx): each corner's clamped row (yc, xc) and its
// weight rounded to T, zero outside the image. Corners in the order
// (0, 0), (0, 1), (1, 0), (1, 1).
template <typename T>
__device__ __forceinline__ void tap_corners(int py_i, int px_i, int t, const float* o, int h,
                                            int w, int yc[4], int xc[4], float cw[4]) {
  const TapPoint tp = tap_point(py_i, px_i, t, o);
  const float omy = __fsub_rn(1.f, tp.wy), omx = __fsub_rn(1.f, tp.wx);
  const float wk[4] = {__fmul_rn(omy, omx), __fmul_rn(omy, tp.wx), __fmul_rn(tp.wy, omx),
                       __fmul_rn(tp.wy, tp.wx)};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int yi = tp.y0i + (k >> 1), xi = tp.x0i + (k & 1);
    yc[k] = min(max(yi, 0), h - 1);
    xc[k] = min(max(xi, 0), w - 1);
    cw[k] = round_to<T>(corner_inside(tp, k, h, w) ? wk[k] : 0.f);
  }
}

// acc += row * cw on V channels, the product and the sum each rounded to T
template <typename T, int V>
__device__ __forceinline__ void blend_add(Pack<T, V>& acc, const Pack<T, V>& row, float cw) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && V % 2 == 0) {
    const __nv_bfloat162 w2 = __float2bfloat162_rn(cw);   // exact: cw is a bf16 value
    __nv_bfloat162* a = reinterpret_cast<__nv_bfloat162*>(acc.v);
    const __nv_bfloat162* r = reinterpret_cast<const __nv_bfloat162*>(row.v);
#pragma unroll
    for (int j = 0; j < V / 2; ++j) a[j] = __hadd2_rn(a[j], __hmul2_rn(r[j], w2));
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float prod = round_to<T>(__fmul_rn(to_float(row.v[e]), cw));
      acc.v[e] = from_float<T>(__fadd_rn(to_float(acc.v[e]), prod));
    }
  }
}

// ---- deform_sample: the columns

template <typename T, int V>
__global__ void deform_sample_kernel(const T* __restrict__ x, const float* __restrict__ off,
                                     T* __restrict__ cols, int64_t n_items, int h, int w,
                                     int c) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_items) return;
  const int nvec = c / V;
  const int j = (int)(i % nvec);
  const int64_t row = i / nvec;          // (b * H*W + p) * 9 + t
  const int t = (int)(row % 9);
  const int64_t bp = row / 9;            // b * H*W + p
  const int64_t hw = (int64_t)h * w;
  const int64_t b = bp / hw;
  const int p = (int)(bp - b * hw);
  int yc[4], xc[4];
  float cw[4];
  tap_corners<T>(p / w, p % w, t, off + bp * 18 + 2 * t, h, w, yc, xc, cw);
  Pack<T, V> acc = zero_pack<T, V>();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const Pack<T, V> r = *reinterpret_cast<const Pack<T, V>*>(
        x + (b * hw + (int64_t)yc[k] * w + xc[k]) * c + (int64_t)j * V);
    blend_add(acc, r, cw[k]);
  }
  *reinterpret_cast<Pack<T, V>*>(cols + row * c + (int64_t)j * V) = acc;
}

template <typename T, int V>
void launch_sample(const void* x, const float* off, void* cols, int64_t rows, int h, int w,
                   int c, cudaStream_t st) {
  const int64_t n_items = rows * (c / V);
  const int threads = 256;
  deform_sample_kernel<T, V><<<(unsigned)((n_items + threads - 1) / threads), threads, 0, st>>>(
      static_cast<const T*>(x), off, static_cast<T*>(cols), n_items, h, w, c);
}

// ---- deform_sample_backward: d x and d offsets from the columns' gradient
//
// Kernel K5': the transposed sampling. For the gradient of the columns,
// laid out as the grouped product leaves it, dcols [g, B*H*W, 9 * C/g]
// (row tap * C/g + c), one warp a (pixel, tap):
//   * d x[corner_k] += cw_k * dcols[., c] for the four corners inside the
//     image, cw_k the forward's rounded weight (tap_corners, the same
//     function), as float32 atomics into a zeroed float32 buffer (the
//     float32 gradient itself, or a scratch rounded once to bf16 after);
//     a corner whose weight is exactly zero (a whole-pixel sample) adds
//     nothing and is skipped;
//   * d cw_k = sum_c dcols[., c] x[corner_k, c] (fp32, lanes then a warp
//     sum), and through cw_00 = (1 - wy)(1 - wx), cw_01 = (1 - wy) wx,
//     cw_10 = wy (1 - wx), cw_11 = wy wx with wy = py - floor(py) (floor has
//     no gradient, as in JAX: at a whole pixel the derivative is the
//     one-sided difference of the corners below and above),
//     d dy = (d cw_10 (1 - wx) + d cw_11 wx) - (d cw_00 (1 - wx) + d cw_01 wx)
//     and d dx alike, written once, no atomics.
// Bound: device-memory bytes (dcols and x read, d x and d offsets written;
// 0.5 GB of dcols at the B=4 train step in bf16); the atomics land in L2.
template <typename T, int V>
__global__ void deform_bwd_kernel(const T* __restrict__ x, const float* __restrict__ off,
                                  const T* __restrict__ dcols, float* __restrict__ dx,
                                  float* __restrict__ doff, int64_t rows, int64_t bhw, int h,
                                  int w, int c, int cg) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;               // whole warps
  const int t = (int)(row % 9);
  const int64_t bp = row / 9;            // b * H*W + p
  const int64_t hw = (int64_t)h * w;
  const int64_t b = bp / hw;
  const int p = (int)(bp - b * hw);
  const float* o = off + bp * 18 + 2 * t;
  int yc[4], xc[4];
  float cw[4];
  tap_corners<T>(p / w, p % w, t, o, h, w, yc, xc, cw);
  const TapPoint tp = tap_point(p / w, p % w, t, o);
  bool inside[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) inside[k] = corner_inside(tp, k, h, w);
  const T* xb = x + b * hw * c;
  float* dxb = dx + b * hw * c;
  float dcw[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j = lane; j < c / V; j += 32) {
    const int c0 = j * V;
    const int gi = c0 / cg, cc = c0 - gi * cg;
    const Pack<T, V> dp = *reinterpret_cast<const Pack<T, V>*>(
        dcols + (((int64_t)gi * bhw + bp) * 9 + t) * cg + cc);
    float dc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) dc[e] = to_float(dp.v[e]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!inside[k]) continue;
      const int64_t at = ((int64_t)yc[k] * w + xc[k]) * c + c0;
      const Pack<T, V> r = *reinterpret_cast<const Pack<T, V>*>(xb + at);
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < V; ++e) s = fmaf(dc[e], to_float(r.v[e]), s);
      dcw[k] += s;
      if (cw[k] == 0.f) continue;
      if constexpr (V % 4 == 0) {
#pragma unroll
        for (int e = 0; e < V; e += 4)
          atomicAdd(reinterpret_cast<float4*>(dxb + at + e),
                    make_float4(__fmul_rn(cw[k], dc[e]), __fmul_rn(cw[k], dc[e + 1]),
                                __fmul_rn(cw[k], dc[e + 2]), __fmul_rn(cw[k], dc[e + 3])));
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) atomicAdd(dxb + at + e, __fmul_rn(cw[k], dc[e]));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) dcw[k] += __shfl_xor_sync(0xffffffffu, dcw[k], s);
  if (lane == 0) {
    const float omy = __fsub_rn(1.f, tp.wy), omx = __fsub_rn(1.f, tp.wx);
    const float d_omy = __fadd_rn(__fmul_rn(dcw[0], omx), __fmul_rn(dcw[1], tp.wx));
    const float d_wy = __fadd_rn(__fmul_rn(dcw[2], omx), __fmul_rn(dcw[3], tp.wx));
    const float d_omx = __fadd_rn(__fmul_rn(dcw[0], omy), __fmul_rn(dcw[2], tp.wy));
    const float d_wx = __fadd_rn(__fmul_rn(dcw[1], omy), __fmul_rn(dcw[3], tp.wy));
    doff[bp * 18 + 2 * t] = __fsub_rn(d_wy, d_omy);
    doff[bp * 18 + 2 * t + 1] = __fsub_rn(d_wx, d_omx);
  }
}

template <typename T, int V>
void launch_sample_backward(const void* x, const float* off, const void* dcols, float* dx,
                            float* doff, int64_t rows, int64_t bhw, int h, int w, int c, int cg,
                            cudaStream_t st) {
  const int threads = 256;
  const int64_t blocks = (rows + threads / 32 - 1) / (threads / 32);
  deform_bwd_kernel<T, V><<<(unsigned)blocks, threads, 0, st>>>(
      static_cast<const T*>(x), off, static_cast<const T*>(dcols), dx, doff, rows, bhw, h, w, c,
      cg);
}

// out = acc rounded to bf16, 4 values a thread (n4 of them), then the tail
__global__ void round_bf16_kernel(const float* __restrict__ acc,
                                  __nv_bfloat16* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t n4 = n / 4;
  if (i < n4) {
    const float4 v = reinterpret_cast<const float4*>(acc)[i];
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 pk;
    pk.x = *reinterpret_cast<const unsigned*>(&lo);
    pk.y = *reinterpret_cast<const unsigned*>(&hi);
    reinterpret_cast<uint2*>(out)[i] = pk;
  } else if (i < n4 + (n - 4 * n4)) {
    const int64_t k = 4 * n4 + (i - n4);
    out[k] = __float2bfloat16_rn(acc[k]);
  }
}

// ---- deform_conv3x3: the fused op

constexpr int kBN = 128;                // output channels a block
constexpr int kR = 3;                   // halo reach beyond the 3x3 window, px

struct FParams {
  const void* x;        // [B, H, W, C] T
  const float* off;     // [B, H, W, 18]
  const void* wgt;      // [g, 9 * cg, og] T
  const void* bias;     // [g * og] T
  void* out;            // [B, H, W, g * og] T
  int h, w, c, cg, og, c_out;
  unsigned long long* corners;   // null, or [2]: += (corners read from L2, corners)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the four corner weights of a (tap, pixel), rounded to T
template <typename T> struct alignas(4 * sizeof(T)) Weights4 {
  T w[4];
};

// Tile geometry and shared memory: 8 x 16 pixels a block, one block an SM.
// A K chunk is 128 bytes of channels of one tap (64 bf16, 32 fp32), so the
// 8 threads of a quarter warp read one corner row of one pixel, one
// shared-memory wavefront, whatever the offsets; bf16 takes 512 threads
// (16 warps of 32 pixels x 32 channels), fp32 256.
template <typename T> struct Layout {
  static constexpr int TH = 8, TW = 16;              // pixel tile
  static constexpr int BM = TH * TW;                 // pixels a block
  static constexpr int THREADS = sizeof(T) == 2 ? 4 * BM : 2 * BM;
  static constexpr int KC = 128 / sizeof(T);         // input channels a K chunk (one tap)
  static constexpr int HH = TH + 2 * kR + 3, HW = TW + 2 * kR + 3;   // halo rows, columns
  static constexpr int V = 16 / sizeof(T);           // elements a 16-byte vector
  static constexpr int AS = KC + V;                  // A row stride (elements)
  static constexpr int BS = kBN + V;                 // B row stride (elements)
  static constexpr size_t kTable = (size_t)9 * BM * (sizeof(int4) + sizeof(Weights4<T>));
  static constexpr size_t kHalo = (size_t)HH * HW * KC * sizeof(T);
  static constexpr size_t kA = (size_t)BM * AS * sizeof(T);
  static constexpr size_t kB = (size_t)KC * BS * sizeof(T);
  static constexpr size_t kBytes = kTable + kHalo + 2 * kA + 2 * kB;
};

// The block's [BM x kBN] sums and their contraction over one K chunk.
template <typename T> struct Tile;

// bf16: warp (wm, wn) = (warp % WM, warp / WM) takes pixels 32 wm .. +32
// and a quarter of the 8-channel tiles (NT at most), on mma.sync m16n8k16
template <> struct Tile<__nv_bfloat16> {
  using L = Layout<__nv_bfloat16>;
  static constexpr int WM = L::BM / 32, WN = L::THREADS / 32 / WM, NT = kBN / 8 / WN;
  float acc[2][NT][4];
  int nt0, nt1;
  __device__ __forceinline__ void init(int nb) {
    const int warp = threadIdx.x >> 5, ntiles = nb / 8, part = (ntiles + WN - 1) / WN;
    nt0 = (warp / WM) * part;
    nt1 = min(ntiles, nt0 + part);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.f;
  }
  __device__ __forceinline__ void mma(int mi, int j, const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(acc[mi][j][0]), "+f"(acc[mi][j][1]), "+f"(acc[mi][j][2]), "+f"(acc[mi][j][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ __forceinline__ void contract(const __nv_bfloat16* A, const __nv_bfloat16* B) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wm = warp % WM;
#pragma unroll
    for (int ks = 0; ks < L::KC; ks += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const __nv_bfloat16* pa =
            A + (wm * 32 + mi * 16 + (lane & 15)) * L::AS + ks + (lane >> 4) * 8;
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                     : "=r"(a[mi][0]), "=r"(a[mi][1]), "=r"(a[mi][2]), "=r"(a[mi][3])
                     : "r"(smem_addr(pa)));
      }
      // B (16 k x 8 channels) of two channel tiles at once, transposed:
      // lanes 0-15 address the first tile's 16 rows, lanes 16-31 the next's
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        const int nt = nt0 + j;
        if (nt + 1 < nt1) {
          uint32_t b[4];
          const __nv_bfloat16* pb = B + (ks + (lane & 15)) * L::BS + (nt + (lane >> 4)) * 8;
          asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                       : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
                       : "r"(smem_addr(pb)));
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma(mi, j, a[mi], b[0], b[1]);
            mma(mi, j + 1, a[mi], b[2], b[3]);
          }
        } else if (nt < nt1) {
          uint32_t b[2];
          const __nv_bfloat16* pb = B + (ks + (lane & 15)) * L::BS + nt * 8;
          asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
                       : "=r"(b[0]), "=r"(b[1])
                       : "r"(smem_addr(pb)));
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma(mi, j, a[mi], b[0], b[1]);
        }
      }
    }
  }
  // each sum rounded to bf16, the bias added in bf16; rows of pixels
  // outside the image are not written
  __device__ __forceinline__ void store(const FParams& p, int b, int ty0, int tx0, int oc0) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wm = warp % WM;
    const int g = lane >> 2, tig = lane & 3;
    const __nv_bfloat16* bias = static_cast<const __nv_bfloat16*>(p.bias);
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int pix = wm * 32 + mi * 16 + hh * 8 + g;
        const int yy = ty0 + pix / L::TW, xx = tx0 + pix % L::TW;
        if (yy >= p.h || xx >= p.w) continue;
        __nv_bfloat16* o = out + (((int64_t)b * p.h + yy) * p.w + xx) * p.c_out + oc0;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int nt = nt0 + j;
          if (nt < nt1) {
            const int col = nt * 8 + tig * 2;
            const float v0 = __fadd_rn(round_to<__nv_bfloat16>(acc[mi][j][hh * 2]),
                                       __bfloat162float(bias[oc0 + col]));
            const float v1 = __fadd_rn(round_to<__nv_bfloat16>(acc[mi][j][hh * 2 + 1]),
                                       __bfloat162float(bias[oc0 + col + 1]));
            *reinterpret_cast<__nv_bfloat162*>(o + col) = __floats2bfloat162_rn(v0, v1);
          }
        }
      }
  }
};

// fp32: thread (tr, tc) = (tid / 16, tid % 16) takes pixels 8 tr .. +8 and
// channels 8 tc .. +8, with fp32 FMAs over K in order
template <> struct Tile<float> {
  using L = Layout<float>;
  float acc[8][8];
  int nb;
  __device__ __forceinline__ void init(int nb_) {
    nb = nb_;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  __device__ __forceinline__ void contract(const float* A, const float* B) {
    const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
    if (tc * 8 >= nb) return;
#pragma unroll 4
    for (int k = 0; k < L::KC; ++k) {
      float a[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = A[(tr * 8 + i) * L::AS + k];
      const float4 b0 = *reinterpret_cast<const float4*>(B + k * L::BS + tc * 8);
      const float4 b1 = *reinterpret_cast<const float4*>(B + k * L::BS + tc * 8 + 4);
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
      bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
  }
  __device__ __forceinline__ void store(const FParams& p, int b, int ty0, int tx0, int oc0) {
    const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
    const float* bias = static_cast<const float*>(p.bias);
    float* out = static_cast<float*>(p.out);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int pix = tr * 8 + i;
      const int yy = ty0 + pix / L::TW, xx = tx0 + pix % L::TW;
      if (yy >= p.h || xx >= p.w) continue;
      float* o = out + (((int64_t)b * p.h + yy) * p.w + xx) * p.c_out + oc0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tc * 8 + j;
        if (col < nb) o[col] = __fadd_rn(acc[i][j], bias[oc0 + col]);
      }
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(Layout<T>::THREADS, 1) deform_conv_kernel(const FParams p) {
  using L = Layout<T>;
  constexpr int V = L::V, BM = L::BM, TW = L::TW, THREADS = L::THREADS, KC = L::KC;
  extern __shared__ __align__(16) unsigned char smem[];
  int4* tsrc = reinterpret_cast<int4*>(smem);                           // [9][BM] corner sources
  Weights4<T>* twt = reinterpret_cast<Weights4<T>*>(tsrc + 9 * BM);     // [9][BM] corner weights
  T* halo = reinterpret_cast<T*>(twt + 9 * BM);                         // [HH * HW][KC]
  T* As = halo + L::HH * L::HW * KC;                                    // [2][BM][AS]
  T* Bs = As + 2 * BM * L::AS;                                          // [2][KC][BS]
  const int tid = threadIdx.x;

  const int tiles_x = (p.w + TW - 1) / TW;
  const int ty0 = (blockIdx.x / tiles_x) * L::TH, tx0 = (blockIdx.x % tiles_x) * TW;
  const int n_ntiles = (p.og + kBN - 1) / kBN;
  const int grp = blockIdx.y / n_ntiles, n0 = (blockIdx.y % n_ntiles) * kBN;
  const int nb = min(kBN, p.og - n0);
  const int b = blockIdx.z;
  const int hy0 = max(0, ty0 - 1 - kR), hy1 = min(p.h, ty0 + L::TH + kR + 2);
  const int hx0 = max(0, tx0 - 1 - kR), hx1 = min(p.w, tx0 + TW + kR + 2);
  const int hcols = hx1 - hx0;
  // this image's group channels, and this group's weights
  const T* xg = static_cast<const T*>(p.x) + (int64_t)b * p.h * p.w * p.c + grp * p.cg;
  const T* wg = static_cast<const T*>(p.wgt) + (int64_t)grp * 9 * p.cg * p.og + n0;

  const int nk = (p.cg + KC - 1) / KC * 9;
  constexpr int vpa = KC / V;   // 16-byte vectors of a chunk row
  auto load_b = [&](int kt, int buf) {
    const int tap = kt % 9, c0 = kt / 9 * KC;
    T* dst = Bs + buf * KC * L::BS;
    constexpr int vpb = kBN / V;
    for (int i = tid; i < KC * vpb; i += THREADS) {
      const int r = i / vpb, n = i % vpb * V;
      const bool ok = c0 + r < p.cg && n < nb;
      cp_async16(dst + r * L::BS + n, ok ? wg + (int64_t)(tap * p.cg + c0 + r) * p.og + n : wg,
                 ok ? 16 : 0);
    }
  };
  auto load_halo = [&](int c0) {
    const int nvalid = min(KC, p.cg - c0) / V;
    const int n = (hy1 - hy0) * hcols * vpa;
    for (int i = tid; i < n; i += THREADS) {
      const int hp = i / vpa, v = i % vpa;
      if (v >= nvalid) continue;   // channels past cg: the A-tile takes zeros there
      const int yy = hy0 + hp / hcols, xx = hx0 + hp % hcols;
      cp_async16(halo + hp * KC + v * V, xg + ((int64_t)yy * p.w + xx) * p.c + c0 + v * V, 16);
    }
  };
  // the first chunk's halo and B-tile are copied while the table is made
  load_halo(0);
  load_b(0, 0);
  cp_async_commit();

  // the corner table: for each (tap, pixel) the four corners' sources (a
  // halo pixel >= 0, or -1 - the image pixel) and rounded weights
  unsigned from_l2 = 0, n_corners = 0;
  for (int i = tid; i < 9 * BM; i += THREADS) {
    const int t = i / BM, pix = i % BM;
    const int yy = ty0 + pix / TW, xx = tx0 + pix % TW;
    int src[4] = {0, 0, 0, 0};
    float cw[4] = {0.f, 0.f, 0.f, 0.f};
    if (yy < p.h && xx < p.w) {
      int yc[4], xc[4];
      tap_corners<T>(yy, xx, t, p.off + (((int64_t)b * p.h + yy) * p.w + xx) * 18 + 2 * t, p.h,
                     p.w, yc, xc, cw);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool in_halo = yc[k] >= hy0 && yc[k] < hy1 && xc[k] >= hx0 && xc[k] < hx1;
        src[k] = in_halo ? (yc[k] - hy0) * hcols + (xc[k] - hx0) : -1 - (yc[k] * p.w + xc[k]);
        from_l2 += !in_halo;
      }
      n_corners += 4;
    }
    tsrc[i] = make_int4(src[0], src[1], src[2], src[3]);
    Weights4<T> w4;
#pragma unroll
    for (int k = 0; k < 4; ++k) w4.w[k] = from_float<T>(cw[k]);
    twt[i] = w4;
  }
  if (p.corners && blockIdx.y == 0 && n_corners) {   // once for all groups
    atomicAdd(p.corners, (unsigned long long)from_l2);
    atomicAdd(p.corners + 1, (unsigned long long)n_corners);
  }

  cp_async_wait_all();
  __syncthreads();

  // each thread builds 16-byte vectors of the chunk row of a pixel, the 8
  // threads of a quarter warp one row: each corner read of theirs is one
  // 128-byte halo row, on distinct banks
  auto build_a = [&](int kt, int buf) {
    const int tap = kt % 9, c0 = kt / 9 * KC;
    const int nvalid = min(KC, p.cg - c0) / V;
    T* dst = As + buf * BM * L::AS;
#pragma unroll
    for (int it = 0; it < BM * vpa / THREADS; ++it) {
      const int i = tid + it * THREADS;
      const int pix = i / vpa, v = i % vpa;
      const int yy = ty0 + pix / TW, xx = tx0 + pix % TW;
      Pack<T, V> acc = zero_pack<T, V>();
      if (yy < p.h && xx < p.w && v < nvalid) {
        const int4 s4 = tsrc[tap * BM + pix];
        const Weights4<T> w4 = twt[tap * BM + pix];
        const int src[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const Pack<T, V> r =
              src[k] >= 0 ? *reinterpret_cast<const Pack<T, V>*>(halo + src[k] * KC + v * V)
                          : ldg_pack<T, V>(xg + (int64_t)(-1 - src[k]) * p.c + c0 + v * V);
          blend_add(acc, r, to_float(w4.w[k]));
        }
      }
      *reinterpret_cast<Pack<T, V>*>(dst + pix * L::AS + v * V) = acc;
    }
  };

  Tile<T> tile;
  tile.init(nb);
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt % 9 == 0 && kt > 0) {
      // a new channel chunk: every A-tile of the last one was built before
      // the last iteration's barrier, so the halo is free
      load_halo(kt / 9 * KC);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
    }
    build_a(kt, buf);
    cp_async_wait_all();   // this chunk's B-tile
    __syncthreads();       // A and B of kt ready; every warp is done with kt - 1
    if (kt + 1 < nk) {
      load_b(kt + 1, buf ^ 1);
      cp_async_commit();
    }
    tile.contract(As + buf * BM * L::AS, Bs + buf * KC * L::BS);
  }
  tile.store(p, b, ty0, tx0, grp * p.og + n0);
}

template <typename T>
int launch_fused(const FParams& p, int b, int groups, cudaStream_t st) {
  using L = Layout<T>;
  const size_t smem = L::kBytes;
  cudaError_t e = cudaFuncSetAttribute(deform_conv_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(((p.h + L::TH - 1) / L::TH) * ((p.w + L::TW - 1) / L::TW)),
                  (unsigned)(groups * ((p.og + kBN - 1) / kBN)), (unsigned)b);
  deform_conv_kernel<T><<<grid, L::THREADS, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, H, W, C] (dtype 0 = float32, 1 = bfloat16), off [B, H, W, 18] fp32
// (dy, dx per tap), cols [B, H*W, 9, C] of x's dtype. vec = 1: x and cols
// are 16-byte aligned and C is a multiple of 16 bytes' worth of elements.
// Returns the cudaError_t of the launch.
extern "C" int deform_sample(int dtype, const void* x, const float* off, void* cols,
                             long long b, int h, int w, int c, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t rows = b * (int64_t)h * w * 9;
  if (rows == 0 || c == 0) return 0;
  if (dtype == 0) {
    if (vec) launch_sample<float, 4>(x, off, cols, rows, h, w, c, st);
    else launch_sample<float, 1>(x, off, cols, rows, h, w, c, st);
  } else if (dtype == 1) {
    if (vec) launch_sample<__nv_bfloat16, 8>(x, off, cols, rows, h, w, c, st);
    else launch_sample<__nv_bfloat16, 1>(x, off, cols, rows, h, w, c, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x [B, H, W, C] 16-byte aligned, off [B, H, W, 18] fp32, wgt [groups,
// 9 * C/groups, C_out/groups] (row tap * C/g + c), bias [C_out] and out
// [B, H, W, C_out], all of x's dtype (0 = float32, 1 = bfloat16), each
// contiguous; C/g and C_out/g multiples of 8. corners: null, or two uint64
// the launch adds (corners read from L2, corners sampled) to. Returns the
// cudaError_t.
extern "C" int deform_conv3x3(int dtype, const void* x, const float* off, const void* wgt,
                              const void* bias, void* out, int b, int h, int w, int c,
                              int groups, int c_out, unsigned long long* corners,
                              void* stream) {
  if (groups < 1 || c % groups || c_out % groups || (c / groups) % 8 || (c_out / groups) % 8 ||
      b < 0 || b > 65535 || h < 0 || w < 0)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || h == 0 || w == 0 || c_out == 0) return 0;
  const FParams p{x, off, wgt, bias, out, h, w, c, c / groups, c_out / groups, c_out, corners};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fused<float>(p, b, groups, st);
  if (dtype == 1) return launch_fused<__nv_bfloat16>(p, b, groups, st);
  return (int)cudaErrorInvalidValue;
}

// The gradient of the columns (deform_sample) for dcols [groups, B*H*W,
// 9 * C/groups] (row tap * C/g + c) of x's dtype: d x [B, H, W, C] and d off
// [B, H, W, 18] fp32 (written whole). x and dcols contiguous; acc float32
// [B, H, W, C], 16-byte aligned, zeroed here: d x itself for float32 (dx
// null), else a scratch rounded into dx (bf16). vec = 1: x and dcols 16-byte
// aligned and C/g a multiple of 16 bytes' worth of elements. Returns the
// cudaError_t.
extern "C" int deform_sample_backward(int dtype, const void* x, const float* off,
                                      const void* dcols, float* acc, void* dx, float* doff,
                                      long long b, int h, int w, int c, int groups, int vec,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t bhw = b * (int64_t)h * w, rows = bhw * 9;
  if (rows == 0 || c == 0) return 0;
  if (groups < 1 || c % groups || (dtype == 1) != (dx != nullptr)) return (int)cudaErrorInvalidValue;
  const int cg = c / groups;
  const int64_t n = bhw * c;
  cudaError_t e = cudaMemsetAsync(acc, 0, (size_t)n * sizeof(float), st);
  if (e != cudaSuccess) return (int)e;
  if (dtype == 0) {
    if (vec) launch_sample_backward<float, 4>(x, off, dcols, acc, doff, rows, bhw, h, w, c, cg, st);
    else launch_sample_backward<float, 1>(x, off, dcols, acc, doff, rows, bhw, h, w, c, cg, st);
  } else if (dtype == 1) {
    if (vec) launch_sample_backward<__nv_bfloat16, 8>(x, off, dcols, acc, doff, rows, bhw, h, w, c,
                                                      cg, st);
    else launch_sample_backward<__nv_bfloat16, 1>(x, off, dcols, acc, doff, rows, bhw, h, w, c,
                                                  cg, st);
    const int64_t items = n / 4 + (n % 4);
    round_bf16_kernel<<<(unsigned)((items + 255) / 256), 256, 0, st>>>(
        acc, static_cast<__nv_bfloat16*>(dx), n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
