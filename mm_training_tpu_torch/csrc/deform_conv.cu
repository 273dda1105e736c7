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
// Rounding, shared by every kernel (tap_corners, blend_add): as the JAX
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
// channel vector). On no path since the fused kernels, which build the
// same columns in shared memory.
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
//
// deform_conv3x3_backward, kernel K5': the whole backward, replacing XLA's
// autodiff of the same formulation (the JAX package has no TPU kernel for
// it). With d cols = dY W^T per group (the columns' gradient, [pixel, tap,
// C/g]):
//   d x[corner_k]  += cw_k * d cols          (the four corners inside the image)
//   d cw_k          = sum_c d cols[c] * x[corner_k, c]
//   d offsets       through cw_00 = (1 - wy)(1 - wx), ..., cw_11 = wy wx
//                   (floor has no gradient: at a whole pixel the one-sided
//                   difference of the corners)
//   d W[g, t*cg + c, o] = sum over pixels of cols[p, t, c] * dY[p, o]
//   d bias          = sum over pixels of dY
// Bound by operations: the two grouped products, 4 x B*H*W x 9 x C x C_out/g,
// 132.9 GFLOP at the B=4 camera train step ([16, 44, 80, 512] bf16, 4
// groups; 0.134 ms on the tensor cores), against ~0.18 GB of x, dY, the
// offsets and the weights read and the gradients written. No column tensor
// ([B, H*W, 9, C], 0.52 GB in bf16 at B=4) is ever written. Two launches:
//   deform_bwd_input_kernel (cooperative, a persistent grid of co-resident
//   blocks, one an SM): zero d x's float32 sums; grid barrier; a pixel tile
//   (8 x 16) at a time:
//     - the tile's corner table (sources, rounded weights; kOutside for
//       corners outside the image, which pass no gradient; a zero weight
//       inside the image still enters d offsets), and a counting sort of
//       the corners that weigh and fall in the halo (R = 3, as the forward)
//       by (halo pixel, tap): integer shared-memory atomics count, a block
//       scan places;
//     - for each group its dY tile [128 px x og], and for each step (three
//       taps of a 64-byte channel chunk): d cols [128 px x 3 x KC] = dY .
//       W_step^T on the tensor cores (bf16 mma.sync, fp32 sums; fp32 takes
//       fp32 FMAs), each entry rounded once to x's dtype, as JAX's einsum
//       transpose leaves it, into shared memory (never to device memory);
//     - d offsets: each (pixel, corner)'s dot of d cols with the corner
//       row, read from the staged halo or from L2 beyond it, four threads a
//       pixel summed by shuffles and added per (tap, pixel) in step order:
//       a fixed order, each d offset written once at the end of the tile;
//     - d x: a thread owns (halo pixel, 8 channels) and gathers its
//       bucket's terms (corner weight x d cols) in registers over a chunk's
//       nine taps, then adds them to device memory, one 16-byte atomic add
//       4 channels (halos of neighbouring tiles overlap); corners beyond
//       the halo add to device memory directly. Shared-memory float
//       atomics, which a first version of this kernel used, ran far slower
//       on the H100 than L2's vector atomics (PERF.md section 6);
//     - the next step's W, the next group's dY and the next chunk's halo
//       are copied (cp.async) while a step's work runs;
//   grid barrier; d x rounded once to bf16 (a float32 x is its sums).
//   deform_bwd_weight_kernel: a block is (split, group, KW input channels)
//   and walks the pixel tiles split, split + splits, ...: it stages the
//   tile's halo and dY and builds the nine A-tiles [128 px x KW] the
//   forward's way (corner_table, sample_vec: the columns bit for bit),
//   then contracts them with dY on the tensor cores into [9 taps x KW x
//   og] float32 sums in registers (fp32: FMAs over the pixels in order).
//   Each block writes its sums, and d bias's (the group's first chunk,
//   dY's column sums), as float32 partials; the last block of a (group,
//   chunk) to finish (a counter) adds every split's partials in split
//   order and casts: deterministic, no atomics on d W.
// d x's sums meet by atomics (no fixed order); d offsets, d W and d bias
// are the same bits on every call. C/g and C_out/g multiples of 8,
// C_out/g up to 128 (the dY tile holds a group's output channels).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
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

// ---- the sampling, shared by every kernel

constexpr int kBN = 128;                // output channels a block (C_out/g up to kBN backward)
constexpr int kR = 3;                   // halo reach beyond the 3x3 window, px

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

// ---- deform_conv3x3: the fused op

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

// ldmatrix (x4, x4 transposed, x2 transposed) and the bf16 tensor-core
// product m16n8k16 with fp32 sums
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* q) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(q)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* q) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(q)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* q) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(q)));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the four corner weights of a (tap, pixel), rounded to T
template <typename T> struct alignas(4 * sizeof(T)) Weights4 {
  T w[4];
};

constexpr int kTH = 8, kTW = 16, kBM = kTH * kTW;   // pixel tile of every kernel below

// The pixels staged for a tile at (ty0, tx0): the tile plus 1 + kR on the
// top and left and 2 + kR on the bottom and right, inside the image.
struct Halo {
  int y0, y1, x0, x1, cols;
  __device__ __forceinline__ Halo(int ty0, int tx0, int h, int w)
      : y0(max(0, ty0 - 1 - kR)), y1(min(h, ty0 + kTH + kR + 2)), x0(max(0, tx0 - 1 - kR)),
        x1(min(w, tx0 + kTW + kR + 2)), cols(x1 - x0) {}
  __device__ __forceinline__ bool holds(int y, int x) const {
    return y >= y0 && y < y1 && x >= x0 && x < x1;
  }
  __device__ __forceinline__ int index(int y, int x) const { return (y - y0) * cols + (x - x0); }
  __device__ __forceinline__ int pixels() const { return (y1 - y0) * cols; }
};

// The corner table the columns are built from, for the tile of image b at
// (ty0, tx0): for each (tap, pixel) the four corners' sources (a halo pixel
// >= 0, or -1 - the image pixel of the clamped corner) and their weights
// rounded to T (zero outside the image), in blockDim.x strides. Counts the
// corners read beyond the halo and the corners sampled.
template <typename T>
__device__ __forceinline__ void corner_table(const float* off, int b, int h, int w, int ty0,
                                             int tx0, const Halo& hl, int4* tsrc,
                                             Weights4<T>* twt, unsigned& from_l2,
                                             unsigned& n_corners) {
  for (int i = threadIdx.x; i < 9 * kBM; i += blockDim.x) {
    const int t = i / kBM, pix = i % kBM;
    const int yy = ty0 + pix / kTW, xx = tx0 + pix % kTW;
    int src[4] = {0, 0, 0, 0};
    float cw[4] = {0.f, 0.f, 0.f, 0.f};
    if (yy < h && xx < w) {
      int yc[4], xc[4];
      tap_corners<T>(yy, xx, t, off + (((int64_t)b * h + yy) * w + xx) * 18 + 2 * t, h, w, yc, xc,
                     cw);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool in_halo = hl.holds(yc[k], xc[k]);
        src[k] = in_halo ? hl.index(yc[k], xc[k]) : -1 - (yc[k] * w + xc[k]);
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
}

// One 16-byte vector of a column: the blend of a table entry's four corner
// rows, each read from the halo (rows of hs elements) or from L2 (xg, the
// image's channels of the chunk at c0v, rows of c elements).
template <typename T, int V>
__device__ __forceinline__ Pack<T, V> sample_vec(const int4 s4, const Weights4<T> w4,
                                                 const T* halo_v, int hs, const T* xg_v, int c) {
  const int src[4] = {s4.x, s4.y, s4.z, s4.w};
  Pack<T, V> acc = zero_pack<T, V>();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const Pack<T, V> r = src[k] >= 0
        ? *reinterpret_cast<const Pack<T, V>*>(halo_v + src[k] * hs)
        : ldg_pack<T, V>(xg_v + (int64_t)(-1 - src[k]) * c);
    blend_add(acc, r, to_float(w4.w[k]));
  }
  return acc;
}

// Tile geometry and shared memory: 8 x 16 pixels a block, one block an SM.
// A K chunk is 128 bytes of channels of one tap (64 bf16, 32 fp32), so the
// 8 threads of a quarter warp read one corner row of one pixel, one
// shared-memory wavefront, whatever the offsets; bf16 takes 512 threads
// (16 warps of 32 pixels x 32 channels), fp32 256.
template <typename T> struct Layout {
  static constexpr int TH = kTH, TW = kTW;           // pixel tile
  static constexpr int BM = kBM;                     // pixels a block
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
  __device__ __forceinline__ void contract(const __nv_bfloat16* A, const __nv_bfloat16* B) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wm = warp % WM;
#pragma unroll
    for (int ks = 0; ks < L::KC; ks += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        ldsm_x4(a[mi], A + (wm * 32 + mi * 16 + (lane & 15)) * L::AS + ks + (lane >> 4) * 8);
      }
      // B (16 k x 8 channels) of two channel tiles at once, transposed:
      // lanes 0-15 address the first tile's 16 rows, lanes 16-31 the next's
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        const int nt = nt0 + j;
        if (nt + 1 < nt1) {
          uint32_t b[4];
          ldsm_x4_t(b, B + (ks + (lane & 15)) * L::BS + (nt + (lane >> 4)) * 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_bf16(acc[mi][j], a[mi], b[0], b[1]);
            mma_bf16(acc[mi][j + 1], a[mi], b[2], b[3]);
          }
        } else if (nt < nt1) {
          uint32_t b[2];
          ldsm_x2_t(b, B + (ks + (lane & 15)) * L::BS + nt * 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][j], a[mi], b[0], b[1]);
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
  const Halo hl(ty0, tx0, p.h, p.w);
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
    const int n = hl.pixels() * vpa;
    for (int i = tid; i < n; i += THREADS) {
      const int hp = i / vpa, v = i % vpa;
      if (v >= nvalid) continue;   // channels past cg: the A-tile takes zeros there
      const int yy = hl.y0 + hp / hl.cols, xx = hl.x0 + hp % hl.cols;
      cp_async16(halo + hp * KC + v * V, xg + ((int64_t)yy * p.w + xx) * p.c + c0 + v * V, 16);
    }
  };
  // the first chunk's halo and B-tile are copied while the table is made
  load_halo(0);
  load_b(0, 0);
  cp_async_commit();

  // the corner table
  unsigned from_l2 = 0, n_corners = 0;
  corner_table<T>(p.off, b, p.h, p.w, ty0, tx0, hl, tsrc, twt, from_l2, n_corners);
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
      if (yy < p.h && xx < p.w && v < nvalid)
        acc = sample_vec<T, V>(tsrc[tap * BM + pix], twt[tap * BM + pix], halo + v * V, KC,
                               xg + c0 + v * V, p.c);
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


// ---- the backward: d x and d offsets (deform_bwd_input_kernel), then d
// weight and d bias (deform_bwd_weight_kernel). See the top of this file.

constexpr int kOutside = -2147483647 - 1;   // a corner source outside the image

// 8 consecutive values as floats, from shared memory (load8) or from global
// memory through the read-only path (ldg8); 16-byte aligned
__device__ __forceinline__ void unpack8(const uint4 u, float (&v)[8]) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(q[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack8(const float4 a, const float4 b, float (&v)[8]) {
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* q, float (&v)[8]) {
  unpack8(*reinterpret_cast<const uint4*>(q), v);
}
__device__ __forceinline__ void load8(const float* q, float (&v)[8]) {
  unpack8(reinterpret_cast<const float4*>(q)[0], reinterpret_cast<const float4*>(q)[1], v);
}
__device__ __forceinline__ void ldg8(const __nv_bfloat16* q, float (&v)[8]) {
  unpack8(__ldg(reinterpret_cast<const uint4*>(q)), v);
}
__device__ __forceinline__ void ldg8(const float* q, float (&v)[8]) {
  unpack8(__ldg(reinterpret_cast<const float4*>(q)), __ldg(reinterpret_cast<const float4*>(q) + 1),
          v);
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

struct BParams {
  const void* x;        // [B, H, W, C] T
  const float* off;     // [B, H, W, 18]
  const void* wgt;      // [g, 9 * cg, og] T
  const void* dy;       // [B, H, W, g * og] T
  float* dx_acc;        // [B, H, W, C] float32 sums of d x: d x itself for T = float
  void* dx;             // [B, H, W, C] T, or null (T = float)
  float* doff;          // [B, H, W, 18]
  void* dw;             // [g, 9 * cg, og] T
  void* db;             // [g * og] T
  float* partials;      // [splits][g][9 * cg][og], then [splits][g * og], float32
  unsigned* barrier;    // [2], zero before the first call (every call leaves them so)
  unsigned* counters;   // [g * chunks], likewise
  int b, h, w, c, groups, cg, og, c_out, splits;
};

// d x and d offsets. A chunk is KC input channels of a group (64 bytes), a
// step TPS taps of a chunk; bf16 takes 512 threads, fp32 256.
template <typename T> struct XLayout {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int KC = 64 / sizeof(T);               // input channels a chunk
  static constexpr int TPS = sizeof(T) == 2 ? 3 : 1;      // taps a step
  static constexpr int THREADS = sizeof(T) == 2 ? 4 * kBM : 2 * kBM;
  static constexpr int PARTS = THREADS / kBM;             // threads a pixel's dots, 8 channels each
  static constexpr int NH = (kTH + 2 * kR + 3) * (kTW + 2 * kR + 3);   // halo pixels
  static constexpr int VPI = KC / 8;                      // 8-channel vectors a halo pixel
  static constexpr int ITEMS = (NH * VPI + THREADS - 1) / THREADS;   // (halo pixel, vector)s a thread
  static constexpr int NB = 9 * NH;                       // buckets: (halo pixel, tap)
  static constexpr int DS = kBN + V;                      // dY and W row stride (elements)
  static constexpr int CS = KC + V;                       // d cols and halo row stride: 80 bytes
  static constexpr size_t kTable =
      (size_t)9 * kBM * (sizeof(int4) + sizeof(Weights4<T>) + 4 * sizeof(float));
  static constexpr size_t kSort = (size_t)(NB + 8) / 8 * 16 + (size_t)9 * kBM * 4 * (2 + sizeof(T));
  static constexpr size_t kW = (size_t)2 * TPS * KC * DS * sizeof(T);
  static constexpr size_t kBytes = kTable + kSort + (size_t)kBM * DS * sizeof(T) + kW +
                                   (size_t)NH * CS * sizeof(T) + (size_t)TPS * kBM * CS * sizeof(T);
  static_assert(kW >= (size_t)NB * sizeof(int), "the bucket counts live in the W buffers");
};

// The d cols of a step, dY [kBM x og] . W_step^T [og x TPS*KC], each entry
// rounded once to T, into dcs [TPS][kBM][CS] (W_step's row n is tap n / KC,
// channel n % KC).
template <typename T> struct DCols;

// bf16: warp (wm, wn) = (warp % 8, warp / 8) takes pixels 16 wm .. +16 and
// the step's columns 48 wn .. +48 (six 8-column tiles), mma.sync m16n8k16
// over og padded to 16
template <> struct DCols<__nv_bfloat16> {
  using L = XLayout<__nv_bfloat16>;
  static __device__ __forceinline__ void run(const __nv_bfloat16* dys, const __nv_bfloat16* ws,
                                             __nv_bfloat16* dcs, int og) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wm = warp & 7, wn = warp >> 3;
    float acc[6][4];
#pragma unroll
    for (int j = 0; j < 6; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    // A: dY rows (pixels), og contiguous; B: W rows (columns), og
    // contiguous, two 8-column tiles a load
    const __nv_bfloat16* pa = dys + (wm * 16 + (lane & 15)) * L::DS + (lane >> 4) * 8;
    const __nv_bfloat16* pb =
        ws + (wn * 48 + (lane & 7) + ((lane >> 4) << 3)) * L::DS + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int k0 = 0; k0 < kBN; k0 += 16) {
      if (k0 >= og) break;
      uint32_t a[4];
      ldsm_x4(a, pa + k0);
#pragma unroll
      for (int jj = 0; jj < 3; ++jj) {
        uint32_t b[4];
        ldsm_x4(b, pb + jj * 16 * L::DS + k0);
        mma_bf16(acc[2 * jj], a, b[0], b[1]);
        mma_bf16(acc[2 * jj + 1], a, b[2], b[3]);
      }
    }
    const int g = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int n = wn * 48 + j * 8 + 2 * tig;
      __nv_bfloat16* o = dcs + ((n / L::KC) * kBM + wm * 16 + g) * L::CS + n % L::KC;
      *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(acc[j][0], acc[j][1]);
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * L::CS) =
          __floats2bfloat162_rn(acc[j][2], acc[j][3]);
    }
  }
};

// fp32 (one tap a step): thread (pixel, half) = (tid / 2, tid % 2) takes
// channels 8 half .. +8, fp32 FMAs over og in order, never TF32
template <> struct DCols<float> {
  using L = XLayout<float>;
  static __device__ __forceinline__ void run(const float* dys, const float* ws, float* dcs,
                                             int og) {
    const int pix = threadIdx.x >> 1, c8 = (threadIdx.x & 1) * 8;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const float* a = dys + pix * L::DS;
    const float* wr = ws + c8 * L::DS;
    for (int k = 0; k < og; k += 4) {
      const float4 av = *reinterpret_cast<const float4*>(a + k);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 bv = *reinterpret_cast<const float4*>(wr + j * L::DS + k);
        acc[j] = fmaf(av.x, bv.x, acc[j]);
        acc[j] = fmaf(av.y, bv.y, acc[j]);
        acc[j] = fmaf(av.z, bv.z, acc[j]);
        acc[j] = fmaf(av.w, bv.w, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) dcs[pix * L::CS + c8 + j] = acc[j];
  }
};

// off[0 .. n] = the exclusive prefix sums of cnt[0 .. n), off[n] the total;
// all of the block's threads, the result visible after the last barrier
__device__ __forceinline__ void block_scan(const int* cnt, int n, unsigned short* off) {
  __shared__ int warp_sum[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (n + blockDim.x - 1) / blockDim.x, i0 = threadIdx.x * per;
  const int i1 = min(n, i0 + per);
  int s = 0;
  for (int i = i0; i < i1; ++i) s += cnt[i];
  int x = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  int base = x - s;
  for (int wv = 0; wv < warp; ++wv) base += warp_sum[wv];
  for (int i = i0; i < i1; ++i) {
    off[i] = (unsigned short)base;
    base += cnt[i];
  }
  if (i0 < n && i1 == n) off[n] = (unsigned short)base;
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(XLayout<T>::THREADS, 1) deform_bwd_input_kernel(const BParams p) {
  using L = XLayout<T>;
  constexpr int V = L::V, KC = L::KC, TPS = L::TPS, PARTS = L::PARTS, THREADS = L::THREADS;
  constexpr int VPI = L::VPI, ITEMS = L::ITEMS, NB = L::NB, NH = L::NH;
  static_assert(PARTS * 8 == KC, "a pixel's dots: PARTS threads of 8 channels");
  extern __shared__ __align__(16) unsigned char smem[];
  int4* tsrc = reinterpret_cast<int4*>(smem);                          // [9][kBM] corner sources
  Weights4<T>* tcw = reinterpret_cast<Weights4<T>*>(tsrc + 9 * kBM);   // [9][kBM] corner weights
  float* dcw = reinterpret_cast<float*>(tcw + 9 * kBM);                // [9][4][kBM] d corner weights
  unsigned short* boff = reinterpret_cast<unsigned short*>(dcw + 9 * 4 * kBM);   // [NB + 1]
  unsigned short* bent = boff + (NB + 8) / 8 * 8;           // [9 * kBM * 4] (tap, pixel, corner)s
  T* bw = reinterpret_cast<T*>(bent + 9 * kBM * 4);         // [9 * kBM * 4] their weights
  T* dys = bw + 9 * kBM * 4;                                // [kBM][DS] dY of the group
  T* ws = dys + kBM * L::DS;                                // [2][TPS * KC][DS] W of a step
  T* halo = ws + 2 * TPS * KC * L::DS;                      // [NH][CS] x of a chunk
  T* dcs = halo + NH * L::CS;                               // [TPS][kBM][CS] d cols of a step
  int* cnt = reinterpret_cast<int*>(ws);                    // [NB] while the buckets are made
  const int tid = threadIdx.x;
  const int h = p.h, w = p.w, c = p.c, cg = p.cg, og = p.og;

  // --- 0: zero the float32 sums of d x
  const int64_t n4 = (int64_t)p.b * h * w * c / 4;
  float4* acc4 = reinterpret_cast<float4*>(p.dx_acc);
  for (int64_t i = (int64_t)blockIdx.x * THREADS + tid; i < n4; i += (int64_t)gridDim.x * THREADS)
    acc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  grid_barrier(p.barrier);

  // --- 1: a pixel tile at a time
  const int tiles_x = (w + kTW - 1) / kTW, tiles = tiles_x * ((h + kTH - 1) / kTH);
  const int nk = (cg + KC - 1) / KC * (9 / TPS), steps = p.groups * nk;
  const int vrow = (og + 15) / 16 * 16 / V;   // vectors of a dY or W row, og padded to 16
  for (int task = blockIdx.x; task < tiles * p.b; task += gridDim.x) {
    const int bi = task / tiles, tt = task % tiles;
    const int ty0 = tt / tiles_x * kTH, tx0 = tt % tiles_x * kTW;
    const Halo hl(ty0, tx0, h, w);
    const int nhp = hl.pixels();
    const T* xb = static_cast<const T*>(p.x) + (int64_t)bi * h * w * c;
    float* accb = p.dx_acc + (int64_t)bi * h * w * c;
    __syncthreads();   // the last tile is done with shared memory
    for (int i = tid; i < NB; i += THREADS) cnt[i] = 0;
    __syncthreads();
    // the table: each corner's source (kOutside outside the image: it
    // passes no gradient; inside the image, a zero weight still enters d
    // offsets) and rounded weight; the halo corners that weigh count into
    // their (halo pixel, tap) bucket
    for (int i = tid; i < 9 * kBM; i += THREADS) {
      const int t = i / kBM, pix = i % kBM;
      const int yy = ty0 + pix / kTW, xx = tx0 + pix % kTW;
      int src[4] = {kOutside, kOutside, kOutside, kOutside};
      float cw[4] = {0.f, 0.f, 0.f, 0.f};
      if (yy < h && xx < w) {
        const float* o = p.off + (((int64_t)bi * h + yy) * w + xx) * 18 + 2 * t;
        int yc[4], xc[4];
        tap_corners<T>(yy, xx, t, o, h, w, yc, xc, cw);
        const TapPoint tp = tap_point(yy, xx, t, o);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (corner_inside(tp, k, h, w)) {
            src[k] = hl.holds(yc[k], xc[k]) ? hl.index(yc[k], xc[k]) : -1 - (yc[k] * w + xc[k]);
            if (src[k] >= 0 && cw[k] != 0.f) atomicAdd(cnt + src[k] * 9 + t, 1);
          }
      }
      tsrc[i] = make_int4(src[0], src[1], src[2], src[3]);
      Weights4<T> w4;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        w4.w[k] = from_float<T>(cw[k]);   // exact: cw is rounded to T
        dcw[(t * 4 + k) * kBM + pix] = 0.f;
      }
      tcw[i] = w4;
    }
    __syncthreads();
    // the buckets: a counting sort of the weighing halo corners by (halo
    // pixel, tap), so a thread can own a halo pixel's channels and gather
    // its terms, (tap, pixel, corner) and weight, with no shared-memory
    // atomics on floats
    block_scan(cnt, NB, boff);
    for (int i = tid; i < NB; i += THREADS) cnt[i] = boff[i];
    __syncthreads();
    for (int i = tid; i < 9 * kBM; i += THREADS) {
      const int t = i / kBM, pix = i % kBM;
      const int4 s4 = tsrc[i];
      const Weights4<T> w4 = tcw[i];
      const int src[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (src[k] >= 0 && to_float(w4.w[k]) != 0.f) {
          const int e = atomicAdd(cnt + src[k] * 9 + t, 1);
          bent[e] = (unsigned short)((t << 9) | (pix << 2) | k);
          bw[e] = w4.w[k];
        }
    }
    __syncthreads();   // the buckets are made; the W buffers are free again
    auto load_w = [&](int st, int buf) {     // step st's TPS taps' rows; zeros past cg and og
      const int grp = st / nk, kt = st % nk;
      const int t0 = kt % (9 / TPS) * TPS, c0 = kt / (9 / TPS) * KC;
      const T* wg = static_cast<const T*>(p.wgt) + (int64_t)grp * 9 * cg * og;
      T* dst = ws + buf * TPS * KC * L::DS;
      for (int i = tid; i < TPS * KC * vrow; i += THREADS) {
        const int n = i / vrow, v = i % vrow, tl = n / KC, r = n % KC;
        const bool ok = c0 + r < cg && v * V < og;
        cp_async16(dst + n * L::DS + v * V,
                   ok ? wg + (int64_t)((t0 + tl) * cg + c0 + r) * og + v * V : wg, ok ? 16 : 0);
      }
    };
    auto load_halo = [&](int st) {           // step st's chunk; zeros past cg
      constexpr int vpa = KC / V;
      const int grp = st / nk, c0 = st % nk / (9 / TPS) * KC;
      const int nvalid = min(KC, cg - c0) / V;
      const T* xg = xb + grp * cg;
      for (int i = tid; i < nhp * vpa; i += THREADS) {
        const int hp = i / vpa, v = i % vpa;
        const int yy = hl.y0 + hp / hl.cols, xx = hl.x0 + hp % hl.cols;
        const bool ok = v < nvalid;
        cp_async16(halo + hp * L::CS + v * V,
                   ok ? xg + ((int64_t)yy * w + xx) * c + c0 + v * V : xg, ok ? 16 : 0);
      }
    };
    auto load_dy = [&](int grp) {            // zero rows for pixels outside the image
      const T* dyg = static_cast<const T*>(p.dy) + (int64_t)bi * h * w * p.c_out + grp * og;
      for (int i = tid; i < kBM * vrow; i += THREADS) {
        const int pix = i / vrow, v = i % vrow;
        const int yy = ty0 + pix / kTW, xx = tx0 + pix % kTW;
        const bool ok = yy < h && xx < w && v * V < og;
        cp_async16(dys + pix * L::DS + v * V,
                   ok ? dyg + ((int64_t)yy * w + xx) * p.c_out + v * V : dyg, ok ? 16 : 0);
      }
    };
    load_dy(0);
    load_w(0, 0);
    load_halo(0);
    cp_async_commit();
    float gx[ITEMS][8];   // d x of the halo pixels' channels this thread owns, over a chunk
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) gx[j][e] = 0.f;
    // the steps of every group: the next step's W, the next group's dY and
    // the next chunk's halo are copied while this one's work runs
    for (int st = 0; st < steps; ++st) {
      const int grp = st / nk, kt = st % nk;
      const int t0 = kt % (9 / TPS) * TPS, c0 = kt / (9 / TPS) * KC, buf = st & 1;
      const int nc = min(KC, cg - c0);   // the chunk's channels
      const bool chunk_end = t0 + TPS == 9;
      const T* xg = xb + grp * cg;
      cp_async_wait_all();
      __syncthreads();   // this step's copies landed; the last step's readers are done
      if (st + 1 < steps) {
        load_w(st + 1, buf ^ 1);
        cp_async_commit();
      }
      DCols<T>::run(dys, ws + buf * TPS * KC * L::DS, dcs, og);
      __syncthreads();   // the step's d cols; dY is free
      if (kt == nk - 1 && grp + 1 < p.groups) {
        load_dy(grp + 1);
        cp_async_commit();
      }
      // d offsets: PARTS threads a pixel, 8 channels each: the pixel's d
      // cols read once, each corner row's dot summed over the parts by
      // shuffles (a fixed order); corners beyond the halo also add their d x
      // to device memory
#pragma unroll
      for (int tl = 0; tl < TPS; ++tl) {
        const int tap = t0 + tl, pix = tid / PARTS, part = tid % PARTS, j0 = part * 8;
        const int4 s4 = tsrc[tap * kBM + pix];
        const Weights4<T> w4 = tcw[tap * kBM + pix];
        const int srcs[4] = {s4.x, s4.y, s4.z, s4.w};
        float d8[8];
        load8(dcs + (tl * kBM + pix) * L::CS + j0, d8);
        float dot[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int src = srcs[k];
          dot[k] = 0.f;
          if (src == kOutside || j0 >= nc) continue;
          float x8[8];
          if (src >= 0) load8(halo + src * L::CS + j0, x8);
          else ldg8(xg + (int64_t)(-1 - src) * c + c0 + j0, x8);
#pragma unroll
          for (int e = 0; e < 8; ++e) dot[k] = fmaf(d8[e], x8[e], dot[k]);
          const float cw = to_float(w4.w[k]);
          if (src < 0 && cw != 0.f) {
            float4* a4 = reinterpret_cast<float4*>(accb + (int64_t)(-1 - src) * c + grp * cg + c0 + j0);
            atomicAdd(a4, make_float4(__fmul_rn(cw, d8[0]), __fmul_rn(cw, d8[1]),
                                      __fmul_rn(cw, d8[2]), __fmul_rn(cw, d8[3])));
            atomicAdd(a4 + 1, make_float4(__fmul_rn(cw, d8[4]), __fmul_rn(cw, d8[5]),
                                          __fmul_rn(cw, d8[6]), __fmul_rn(cw, d8[7])));
          }
        }
#pragma unroll
        for (int sh = 1; sh < PARTS; sh <<= 1)
#pragma unroll
          for (int k = 0; k < 4; ++k) dot[k] += __shfl_xor_sync(0xffffffffu, dot[k], sh);
        if (part == 0)
#pragma unroll
          for (int k = 0; k < 4; ++k) dcw[(tap * 4 + k) * kBM + pix] += dot[k];
      }
      if (chunk_end) {
        __syncthreads();   // every thread is done with the halo
        if (st + 1 < steps) {
          load_halo(st + 1);
          cp_async_commit();
        }
      }
      // d x inside the halo: each (halo pixel, 8 channels) this thread owns
      // gathers its bucket's terms of the step's taps, weight x d cols
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        const int it = tid + j * THREADS, q = it / VPI, v = it % VPI;
        if (q >= nhp) break;
        const int e1 = boff[q * 9 + t0 + TPS];
        for (int e = boff[q * 9 + t0]; e < e1; ++e) {
          const int pk = bent[e];
          const float cw = to_float(bw[e]);
          float d8[8];
          load8(dcs + (((pk >> 9) - t0) * kBM + ((pk >> 2) & 127)) * L::CS + v * 8, d8);
#pragma unroll
          for (int i = 0; i < 8; ++i) gx[j][i] = fmaf(cw, d8[i], gx[j][i]);
        }
      }
      if (chunk_end) {
        // the chunk's d x: into device memory, two 16-byte adds a halo
        // pixel's 8 channels (halos of neighbouring tiles overlap), only
        // where a term arrived
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) {
          const int it = tid + j * THREADS, q = it / VPI, v = it % VPI;
          if (q >= nhp) break;
          if (boff[q * 9] != boff[q * 9 + 9] && v * 8 < nc) {
            const int yy = hl.y0 + q / hl.cols, xx = hl.x0 + q % hl.cols;
            float4* a = reinterpret_cast<float4*>(accb + ((int64_t)yy * w + xx) * c + grp * cg +
                                                  c0 + v * 8);
            atomicAdd(a, make_float4(gx[j][0], gx[j][1], gx[j][2], gx[j][3]));
            atomicAdd(a + 1, make_float4(gx[j][4], gx[j][5], gx[j][6], gx[j][7]));
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) gx[j][e] = 0.f;
        }
      }
    }
    // d offsets, each written once (dcw is complete since the last chunk's
    // barrier): through cw_00 = (1 - wy)(1 - wx), cw_01 = (1 - wy) wx, cw_10
    // = wy (1 - wx), cw_11 = wy wx (floor has no gradient: at a whole pixel
    // the one-sided difference)
    for (int i = tid; i < 9 * kBM; i += THREADS) {
      const int t = i / kBM, pix = i % kBM;
      const int yy = ty0 + pix / kTW, xx = tx0 + pix % kTW;
      if (yy >= h || xx >= w) continue;
      const TapPoint tp =
          tap_point(yy, xx, t, p.off + (((int64_t)bi * h + yy) * w + xx) * 18 + 2 * t);
      const float* d = dcw + t * 4 * kBM + pix;
      const float omy = __fsub_rn(1.f, tp.wy), omx = __fsub_rn(1.f, tp.wx);
      const float d_omy = __fadd_rn(__fmul_rn(d[0], omx), __fmul_rn(d[kBM], tp.wx));
      const float d_wy = __fadd_rn(__fmul_rn(d[2 * kBM], omx), __fmul_rn(d[3 * kBM], tp.wx));
      const float d_omx = __fadd_rn(__fmul_rn(d[0], omy), __fmul_rn(d[2 * kBM], tp.wy));
      const float d_wx = __fadd_rn(__fmul_rn(d[kBM], omy), __fmul_rn(d[3 * kBM], tp.wy));
      float* o = p.doff + (((int64_t)bi * h + yy) * w + xx) * 18 + 2 * t;
      o[0] = __fsub_rn(d_wy, d_omy);
      o[1] = __fsub_rn(d_wx, d_omx);
    }
  }
  grid_barrier(p.barrier);

  // --- 2: d x rounded once to bf16 (the sums come from L2: read past L1)
  if (p.dx) {
    for (int64_t i = (int64_t)blockIdx.x * THREADS + tid; i < n4;
         i += (int64_t)gridDim.x * THREADS) {
      const float4 v = __ldcg(acc4 + i);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      uint2 pk;
      pk.x = *reinterpret_cast<const unsigned*>(&lo);
      pk.y = *reinterpret_cast<const unsigned*>(&hi);
      reinterpret_cast<uint2*>(p.dx)[i] = pk;
    }
  }
}

// d weight and d bias. A block is (split s, group, KW input channels) and
// walks the pixel tiles s, s + splits, ...
template <typename T> struct WLayout {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int KW = sizeof(T) == 2 ? 32 : 16;     // input channels a block
  static constexpr int THREADS = sizeof(T) == 2 ? 384 : 256;
  static constexpr int NH = (kTH + 2 * kR + 3) * (kTW + 2 * kR + 3);
  static constexpr int AS = KW + V;                       // A-tile row stride (elements)
  static constexpr int DS = kBN + V;                      // dY row stride
  static constexpr size_t kBytes = (size_t)9 * kBM * (sizeof(int4) + sizeof(Weights4<T>)) +
                                   (size_t)NH * KW * sizeof(T) +
                                   (size_t)9 * kBM * AS * sizeof(T) + (size_t)kBM * DS * sizeof(T);
};

// The block's dW rows [9 taps][KW][og] and their products over a pixel tile.
template <typename T> struct WTile;

// bf16: warp (wm, wn) = (warp % 3, warp / 3) takes taps wm, wm + 3, wm + 6
// and the 8-channel output tiles 4 wn .. +4; mma.sync m16n8k16 with the
// A-tiles (transposed: rows are input channels, k the pixels) and dY
template <> struct WTile<__nv_bfloat16> {
  using L = WLayout<__nv_bfloat16>;
  float acc[3][2][4][4];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[t][mi][j][0] = acc[t][mi][j][1] = acc[t][mi][j][2] = acc[t][mi][j][3] = 0.f;
  }
  __device__ __forceinline__ void contract(const __nv_bfloat16* As, const __nv_bfloat16* dys,
                                           int og) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wm = warp % 3, wn = warp / 3;
    const int nto = og / 8;
    if (wn * 4 >= nto) return;
#pragma unroll 2
    for (int k0 = 0; k0 < kBM; k0 += 16) {
      uint32_t b[4][2] = {{0u, 0u}, {0u, 0u}, {0u, 0u}, {0u, 0u}};
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        const int nt = wn * 4 + j;
        const __nv_bfloat16* pb = dys + (k0 + (lane & 15)) * L::DS;
        if (nt + 1 < nto) {
          uint32_t r[4];
          ldsm_x4_t(r, pb + (nt + (lane >> 4)) * 8);
          b[j][0] = r[0];
          b[j][1] = r[1];
          b[j + 1][0] = r[2];
          b[j + 1][1] = r[3];
        } else if (nt < nto) {
          ldsm_x2_t(b[j], pb + nt * 8);
        }
      }
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const int tap = wm + 3 * t;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          uint32_t a[4];
          ldsm_x4_t(a, As + (tap * kBM + k0 + (lane & 7) + ((lane >> 4) << 3)) * L::AS + mi * 16 +
                           ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (wn * 4 + j < nto) mma_bf16(acc[t][mi][j], a, b[j][0], b[j][1]);
        }
      }
    }
  }
  // rows tap * cg + c0 + c of this block's partial [9 * cg][og]
  __device__ __forceinline__ void store(float* part, int cg, int c0, int og) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wm = warp % 3, wn = warp / 3;
    const int g = lane >> 2, tig = lane & 3, nto = og / 8;
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int nt = wn * 4 + j;
          if (nt >= nto) continue;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int cc = c0 + mi * 16 + hh * 8 + g;
            if (cc >= cg) continue;
            *reinterpret_cast<float2*>(part + (int64_t)((wm + 3 * t) * cg + cc) * og + nt * 8 +
                                       2 * tig) =
                make_float2(acc[t][mi][j][2 * hh], acc[t][mi][j][2 * hh + 1]);
          }
        }
  }
};

// fp32: thread (row group, lane) = (warp, lane) takes rows 18 warp .. +18
// of the (tap, channel) rows and output channels 4 lane .. +4, fp32 FMAs
// over a tile's pixels in order, each tile's sums then added to the
// block's: two levels, so no sum runs over more than a tile or the tiles
template <> struct WTile<float> {
  using L = WLayout<float>;
  float acc[18][4];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < 18; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }
  __device__ __forceinline__ void contract(const float* As, const float* dys, int og) {
    const int rg = threadIdx.x >> 5, o4 = (threadIdx.x & 31) * 4;
    if (o4 >= og) return;
    float t[18][4];
#pragma unroll
    for (int i = 0; i < 18; ++i) t[i][0] = t[i][1] = t[i][2] = t[i][3] = 0.f;
    for (int px = 0; px < kBM; ++px) {
      const float4 d = *reinterpret_cast<const float4*>(dys + px * L::DS + o4);
#pragma unroll
      for (int i = 0; i < 18; ++i) {
        const int r = rg * 18 + i;   // tap r / 16, channel r % 16
        const float a = As[((r >> 4) * kBM + px) * L::AS + (r & 15)];
        t[i][0] = fmaf(a, d.x, t[i][0]);
        t[i][1] = fmaf(a, d.y, t[i][1]);
        t[i][2] = fmaf(a, d.z, t[i][2]);
        t[i][3] = fmaf(a, d.w, t[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 18; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = __fadd_rn(acc[i][j], t[i][j]);
  }
  __device__ __forceinline__ void store(float* part, int cg, int c0, int og) const {
    const int rg = threadIdx.x >> 5, o4 = (threadIdx.x & 31) * 4;
    if (o4 >= og) return;
#pragma unroll
    for (int i = 0; i < 18; ++i) {
      const int r = rg * 18 + i, cc = c0 + (r & 15);
      if (cc >= cg) continue;
      *reinterpret_cast<float4*>(part + (int64_t)((r >> 4) * cg + cc) * og + o4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(WLayout<T>::THREADS, 1) deform_bwd_weight_kernel(const BParams p) {
  using L = WLayout<T>;
  constexpr int V = L::V, KW = L::KW, THREADS = L::THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool last;
  int4* tsrc = reinterpret_cast<int4*>(smem);                               // [9][kBM]
  Weights4<T>* twt = reinterpret_cast<Weights4<T>*>(tsrc + 9 * kBM);        // [9][kBM]
  T* halo = reinterpret_cast<T*>(twt + 9 * kBM);                            // [NH][KW]
  T* As = halo + L::NH * KW;                                                // [9][kBM][AS]
  T* dys = As + 9 * kBM * L::AS;                                            // [kBM][DS]
  const int tid = threadIdx.x;
  const int h = p.h, w = p.w, c = p.c, cg = p.cg, og = p.og;
  const int nch = (cg + KW - 1) / KW;
  const int s = blockIdx.x, grp = blockIdx.y / nch, c0 = blockIdx.y % nch * KW;
  const int nvalid = min(KW, cg - c0) / V;
  const int tiles_x = (w + kTW - 1) / kTW, tiles = tiles_x * ((h + kTH - 1) / kTH);
  const bool bias_thread = c0 == 0 && tid < og;   // d bias: the group's first chunk
  constexpr int vpa = KW / V;
  WTile<T> acc;
  acc.init();
  float bsum = 0.f;
  for (int task = s; task < tiles * p.b; task += p.splits) {
    const int bi = task / tiles, tt = task % tiles;
    const int ty0 = tt / tiles_x * kTH, tx0 = tt % tiles_x * kTW;
    const Halo hl(ty0, tx0, h, w);
    const T* xg = static_cast<const T*>(p.x) + (int64_t)bi * h * w * c + grp * cg;
    const T* dyg = static_cast<const T*>(p.dy) + (int64_t)bi * h * w * p.c_out + grp * og;
    __syncthreads();   // the last tile's products are done with shared memory
    // the chunk's halo and the group's dY by cp.async while the table is made
    for (int i = tid; i < hl.pixels() * vpa; i += THREADS) {
      const int hp = i / vpa, v = i % vpa;
      if (v >= nvalid) continue;   // channels past cg: the A-tiles take zeros there
      const int yy = hl.y0 + hp / hl.cols, xx = hl.x0 + hp % hl.cols;
      cp_async16(halo + hp * KW + v * V, xg + ((int64_t)yy * w + xx) * c + c0 + v * V, 16);
    }
    for (int i = tid; i < kBM * (og / V); i += THREADS) {
      const int pix = i / (og / V), v = i % (og / V);
      const int yy = ty0 + pix / kTW, xx = tx0 + pix % kTW;
      const bool ok = yy < h && xx < w;
      cp_async16(dys + pix * L::DS + v * V, ok ? dyg + ((int64_t)yy * w + xx) * p.c_out + v * V : dyg,
                 ok ? 16 : 0);
    }
    cp_async_commit();
    unsigned from_l2 = 0, n_corners = 0;
    corner_table<T>(p.off, bi, h, w, ty0, tx0, hl, tsrc, twt, from_l2, n_corners);
    cp_async_wait_all();
    __syncthreads();
    // the nine A-tiles [kBM x KW], the columns kernel's values bit for bit
    for (int i = tid; i < 9 * kBM * vpa; i += THREADS) {
      const int tap = i / (kBM * vpa), r = i % (kBM * vpa), pix = r / vpa, v = r % vpa;
      const int yy = ty0 + pix / kTW, xx = tx0 + pix % kTW;
      Pack<T, V> a = zero_pack<T, V>();
      if (yy < h && xx < w && v < nvalid)
        a = sample_vec<T, V>(tsrc[tap * kBM + pix], twt[tap * kBM + pix], halo + v * V, KW,
                             xg + c0 + v * V, c);
      *reinterpret_cast<Pack<T, V>*>(As + (tap * kBM + pix) * L::AS + v * V) = a;
    }
    __syncthreads();
    acc.contract(As, dys, og);
    if (bias_thread)
      for (int px = 0; px < kBM; ++px) bsum += to_float(dys[px * L::DS + tid]);
  }
  // this block's partials; the last block of the (group, chunk) to finish
  // sums every split's in split order and casts
  const int64_t nw = (int64_t)9 * cg * og;
  float* bparts = p.partials + (int64_t)p.splits * p.groups * nw;   // [splits][c_out]
  acc.store(p.partials + ((int64_t)s * p.groups + grp) * nw, cg, c0, og);
  if (bias_thread) bparts[(int64_t)s * p.c_out + grp * og + tid] = bsum;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(p.counters + blockIdx.y, 1u) == (unsigned)p.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int rows = min(KW, cg - c0);
  T* dw = static_cast<T*>(p.dw) + grp * nw;
  for (int e = tid; e < 9 * rows * og; e += THREADS) {
    const int tap = e / (rows * og), r = e % (rows * og);
    const int64_t at = (int64_t)(tap * cg + c0 + r / og) * og + r % og;
    float sum = 0.f;
    for (int sp = 0; sp < p.splits; ++sp)
      sum += __ldcg(p.partials + ((int64_t)sp * p.groups + grp) * nw + at);
    dw[at] = from_float<T>(sum);
  }
  if (c0 == 0)
    for (int o = tid; o < og; o += THREADS) {
      float sum = 0.f;
      for (int sp = 0; sp < p.splits; ++sp)
        sum += __ldcg(bparts + (int64_t)sp * p.c_out + grp * og + o);
      static_cast<T*>(p.db)[grp * og + o] = from_float<T>(sum);
    }
  if (tid == 0) atomicExch(p.counters + blockIdx.y, 0u);
}

// The splits of the pixel tiles for d weight: enough (split, group, chunk)
// blocks to fill the card once, at most one a tile.
template <typename T>
int weight_splits(int b, int h, int w, int cg, int groups, int* splits, int* chunks) {
  using L = WLayout<T>;
  cudaError_t e = cudaFuncSetAttribute(deform_bwd_weight_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  int dev = 0, sms = 0, occ = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, deform_bwd_weight_kernel<T>,
                                                      L::THREADS, L::kBytes);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  *chunks = (cg + L::KW - 1) / L::KW;
  const int tasks = b * ((h + kTH - 1) / kTH) * ((w + kTW - 1) / kTW);
  *splits = std::max(1, std::min(tasks, occ * sms / (groups * *chunks)));
  return 0;
}

template <typename T>
int launch_backward(BParams p, cudaStream_t st) {
  using X = XLayout<T>;
  int chunks = 0;
  int e = weight_splits<T>(p.b, p.h, p.w, p.cg, p.groups, &p.splits, &chunks);
  if (e) return e;
  cudaError_t err = cudaFuncSetAttribute(deform_bwd_input_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)X::kBytes);
  int dev = 0, sms = 0, occ = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, deform_bwd_input_kernel<T>,
                                                        X::THREADS, X::kBytes);
  if (err != cudaSuccess) return (int)err;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(deform_bwd_input_kernel<T>),
                                    dim3(occ * sms), dim3(X::THREADS), args, X::kBytes, st);
  if (err != cudaSuccess) return (int)err;
  deform_bwd_weight_kernel<T><<<dim3(p.splits, p.groups * chunks), WLayout<T>::THREADS,
                                WLayout<T>::kBytes, st>>>(p);
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

// The scratch the backward of deform_conv3x3 takes for these shapes (dtype
// 0 = float32, 1 = bfloat16): sizes[0] float32 values of d weight's
// partials, sizes[1] uint32 counters (zero before the first call). Returns
// the cudaError_t.
extern "C" int deform_conv3x3_backward_scratch(int dtype, int b, int h, int w, int c, int groups,
                                               int c_out, long long* sizes) {
  if (groups < 1 || c % groups || c_out % groups || b < 1 || h < 1 || w < 1)
    return (int)cudaErrorInvalidValue;
  int splits = 0, chunks = 0, e = 0;
  const int cg = c / groups;
  if (dtype == 0) e = weight_splits<float>(b, h, w, cg, groups, &splits, &chunks);
  else if (dtype == 1) e = weight_splits<__nv_bfloat16>(b, h, w, cg, groups, &splits, &chunks);
  else return (int)cudaErrorInvalidValue;
  if (e) return e;
  sizes[0] = (long long)splits * ((long long)9 * c * (c_out / groups) + c_out);
  sizes[1] = (long long)groups * chunks;
  return 0;
}

// The gradients of deform_conv3x3 for dy [B, H, W, C_out]: dx [B, H, W, C]
// (through the float32 sums dx_acc, [B, H, W, C]: dx itself for float32,
// dx null; rounded once into dx for bf16), doff [B, H, W, 18] float32, dw
// [groups, 9 * C/g, C_out/g] and db [C_out]; x, wgt, dy, dx, dw, db of
// x's dtype (0 = float32, 1 = bfloat16), all contiguous, x, wgt and dy
// 16-byte aligned; C/g and C_out/g multiples of 8, C_out/g up to 128.
// barrier: two uint32, partials and counters as
// deform_conv3x3_backward_scratch gives them; the uint32 are zero before
// the first call and every call leaves them so. Two launches: a
// cooperative one for dx and doff, then dw and db. Returns the
// cudaError_t.
extern "C" int deform_conv3x3_backward(int dtype, const void* x, const float* off,
                                       const void* wgt, const void* dy, float* dx_acc, void* dx,
                                       float* doff, void* dw, void* db, unsigned* barrier,
                                       float* partials, unsigned* counters, int b, int h, int w,
                                       int c, int groups, int c_out, void* stream) {
  if (groups < 1 || c % groups || c_out % groups || (c / groups) % 8 || (c_out / groups) % 8 ||
      c_out / groups > kBN || b < 1 || h < 1 || w < 1 || (dtype == 1) != (dx != nullptr))
    return (int)cudaErrorInvalidValue;
  const BParams p{x, off, wgt, dy, dx_acc, dx, doff, dw, db, partials, barrier, counters,
                  b, h, w, c, groups, c / groups, c_out / groups, c_out, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_backward<float>(p, st);
  if (dtype == 1) return launch_backward<__nv_bfloat16>(p, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
