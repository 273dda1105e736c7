// Kernel A: per-channel affine (+ residual) (+ ReLU) over a channels-last tensor.
//
//   out[i] = act(x[i] * s[c] + t[c] (+ r[i])),  c = i % C,  act = ReLU or identity
//
// and its masked form, the tail of the sparse-import LiDAR encoder's
// masked ConvBN and BasicBlock (mm_training_tpu/models/sparse_encoder.py:
// 81-90, 101-111), with one mask byte m[p] a pixel p = i / C:
//
//   out[i] = relu((x[i] * s[c] + t[c]) * m[p] (+ r[i]))
//
// Replaces the TPU kernel scripts/bn_elementwise_probe.py::_pallas_affine
// (kernel bodies _affine_relu_kernel and _affine_res_relu_kernel): the
// eval-mode BatchNorm tail of every ConvBN, BasicBlock, SECONDFPN deblock and
// SeparateHead branch on the serving path.
//
// Bound: device-memory bytes. It reads x (and r) once and writes out once,
// 2 or 3 x the tensor's bytes, at one multiply-add per element. Design for
// that: each thread moves 16 bytes per access (8 bf16 or 4 fp32 values) on
// neighbouring addresses, s and t stay in L1, and the arithmetic is fp32 with
// one rounding to the storage type at the store. The multiply and the adds
// round separately (no FMA contraction), as the plain PyTorch version does,
// so the two agree bit for bit. The masked form multiplies by the pixel's
// 0 or 1 (a multiply, not a select: NaN * 0 stays NaN, as in the JAX
// module), one more byte a pixel; the unmasked instantiations are unchanged.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, bool RES, bool RELU, bool MASK>
__device__ __forceinline__ T apply(T x, T r, float s, float t, float m) {
  float y = __fadd_rn(__fmul_rn(to_float(x), s), t);
  if (MASK) y = __fmul_rn(y, m);
  if (RES) y = __fadd_rn(y, to_float(r));
  if (RELU) y = (y < 0.f) ? 0.f : y;  // keeps NaN, like torch.relu
  return from_float<T>(y);
}

template <typename T, bool RES, bool RELU, bool MASK>
__global__ void affine_act_kernel(const T* __restrict__ x, const T* __restrict__ r,
                                  const float* __restrict__ s, const float* __restrict__ t,
                                  const unsigned char* __restrict__ mk, T* __restrict__ out,
                                  int64_t n, int c) {
  constexpr int VEC = 16 / sizeof(T);
  const int64_t nvec = n / VEC;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t v = first; v < nvec; v += stride) {
    uint4 xv = reinterpret_cast<const uint4*>(x)[v];
    uint4 rv = xv;
    if (RES) rv = reinterpret_cast<const uint4*>(r)[v];
    const T* xe = reinterpret_cast<const T*>(&xv);
    const T* re = reinterpret_cast<const T*>(&rv);
    uint4 ov;
    T* oe = reinterpret_cast<T*>(&ov);
    int ch = (int)((v * VEC) % c);
    int64_t px = MASK ? (v * VEC) / c : 0;   // the pixel of element j
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      oe[j] = apply<T, RES, RELU, MASK>(xe[j], re[j], s[ch], t[ch],
                                        MASK ? (mk[px] ? 1.f : 0.f) : 1.f);
      if (++ch == c) {
        ch = 0;
        if (MASK) ++px;
      }
    }
    reinterpret_cast<uint4*>(out)[v] = ov;
  }
  // ragged end: fewer than VEC elements, one per thread
  const int64_t i = nvec * VEC + first;
  if (i < n) {
    const int ch = (int)(i % c);
    out[i] = apply<T, RES, RELU, MASK>(x[i], RES ? r[i] : x[i], s[ch], t[ch],
                                       MASK ? (mk[i / c] ? 1.f : 0.f) : 1.f);
  }
}

template <typename T, bool RES, bool RELU, bool MASK>
void launch(const void* x, const void* r, const float* s, const float* t,
            const unsigned char* mk, void* out, int64_t n, int c, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int threads = 256;
  int64_t blocks = (n / VEC + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 8192) blocks = 8192;  // grid-stride beyond ~60 blocks per SM
  affine_act_kernel<T, RES, RELU, MASK><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), s, t, mk, static_cast<T*>(out), n, c);
}

template <typename T>
void dispatch(const void* x, const void* r, const float* s, const float* t,
              const unsigned char* mk, void* out, int64_t n, int c, int relu,
              cudaStream_t stream) {
  if (mk != nullptr) {   // the masked tails always end in a ReLU
    if (r != nullptr) launch<T, true, true, true>(x, r, s, t, mk, out, n, c, stream);
    else launch<T, false, true, true>(x, r, s, t, mk, out, n, c, stream);
  } else if (r != nullptr) {
    if (relu) launch<T, true, true, false>(x, r, s, t, mk, out, n, c, stream);
    else launch<T, true, false, false>(x, r, s, t, mk, out, n, c, stream);
  } else {
    if (relu) launch<T, false, true, false>(x, r, s, t, mk, out, n, c, stream);
    else launch<T, false, false, false>(x, r, s, t, mk, out, n, c, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. r may be null. mask: null, or one byte
// a pixel (n / c of them, 0 or not), then relu must be 1. Pointers of x, r
// and out must be 16-byte aligned. Returns the cudaError_t of the launch.
extern "C" int affine_act(int dtype, const void* x, const void* r, const float* s,
                          const float* t, const unsigned char* mask, void* out, long long n,
                          int c, int relu, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mask != nullptr && !relu) return (int)cudaErrorInvalidValue;
  if (dtype == 0) dispatch<float>(x, r, s, t, mask, out, n, c, relu, st);
  else if (dtype == 1) dispatch<__nv_bfloat16>(x, r, s, t, mask, out, n, c, relu, st);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
