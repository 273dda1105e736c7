// Kernel K3: circle NMS keep mask, one block per (batch, task) row.
//
// Replaces the JAX package's device formulation
// mm_training_tpu/ops/circle_nms.py::circle_nms_mask (a K x K distance matrix
// and a lax.fori_loop of K masked updates).
//
// The caller sorts each row by descending score (stable, invalid slots last)
// and passes the sorted centres and validity with the sort order. The block
//   1. loads the K sorted centres into shared memory;
//   2. builds the upper-triangular "close" bitmask, bit j of row i set when
//      j > i and the squared centre distance is <= the row's threshold (the
//      raw min_radius value, as CenterPoint compares it), one 32-bit word per
//      warp ballot;
//   3. sweeps once in order with one warp: box i survives when it is valid
//      and no earlier survivor marked it, and then ORs its row into the
//      removed set, held one word per lane in registers (so K <= 1024);
//   4. scatters the survivors back to slot order.
//
// Bound: operations. K(K-1)/2 fp32 distances per row against kilobytes of
// input; the K-step sweep is sequential by definition, so one row's latency
// is the floor, and rows run on separate SMs. Distances round each step
// (no FMA contraction) as the JAX and plain versions do, so the masks agree
// exactly.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void circle_nms_kernel(const float* __restrict__ centers,    // [R, K, 2] sorted
                                  const bool* __restrict__ valid,       // [R, K] sorted
                                  const int64_t* __restrict__ order,    // [R, K]
                                  const float* __restrict__ thresh,     // [R]
                                  bool* __restrict__ keep,              // [R, K] slot order
                                  int k) {
  extern __shared__ unsigned char smem[];
  const int nw = (k + 31) / 32;
  float* cx = reinterpret_cast<float*>(smem);
  float* cy = cx + k;
  unsigned* close = reinterpret_cast<unsigned*>(cy + k);  // [k, nw]
  unsigned* removed = close + (int64_t)k * nw;            // [nw]
  unsigned char* val = reinterpret_cast<unsigned char*>(removed + nw);  // [k]

  const int64_t row = blockIdx.x;
  const float* c = centers + row * k * 2;
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    cx[i] = c[2 * i];
    cy[i] = c[2 * i + 1];
    val[i] = valid[row * k + i] ? 1 : 0;
  }
  for (int w = threadIdx.x; w < nw; w += blockDim.x) removed[w] = 0u;
  __syncthreads();

  // one 32-bit word per warp step: lane b tests pair (i, 32w + b), so a
  // warp reads 32 neighbouring centres (no bank conflicts) and ballots them
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const float th = thresh[row];
  for (int e = warp; e < k * nw; e += nwarps) {
    const int i = e / nw;
    const int j0 = (e - i * nw) * 32;
    if (j0 + 31 <= i) {  // below the diagonal: nothing to test
      if (lane == 0) close[e] = 0u;
      continue;
    }
    const int j = j0 + lane;
    bool near = false;
    if (j > i && j < k) {
      const float dx = __fsub_rn(cx[i], cx[j]);
      const float dy = __fsub_rn(cy[i], cy[j]);
      near = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <= th;
    }
    const unsigned bits = __ballot_sync(0xffffffffu, near);
    if (lane == 0) close[e] = bits;
  }
  __syncthreads();

  if (warp == 0) {
    // lane w holds removed-word w in a register (K <= 1024: one word a lane);
    // box i's bit comes from its word's lane by shuffle, so the K sequential
    // steps carry no shared-memory read-modify-write from one to the next
    unsigned rem = 0u;
    for (int i = 0; i < k; ++i) {
      const unsigned word = __shfl_sync(0xffffffffu, rem, i >> 5);
      if (val[i] && !((word >> (i & 31)) & 1u) && lane < nw)
        rem |= close[(int64_t)i * nw + lane];
    }
    if (lane < nw) removed[lane] = rem;
  }
  __syncthreads();

  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const bool kept = val[j] && !((removed[j >> 5] >> (j & 31)) & 1u);
    keep[row * k + order[row * k + j]] = kept;
  }
}

}  // namespace

// K <= 1024. Returns the cudaError_t of the launch (cudaErrorInvalidValue
// for a larger K).
extern "C" int circle_nms(const float* centers, const bool* valid, const long long* order,
                          const float* thresh, bool* keep, long long rows, int k,
                          void* stream) {
  if (rows == 0 || k == 0) return 0;
  if (k > 1024) return (int)cudaErrorInvalidValue;
  const int nw = (k + 31) / 32;
  const size_t smem = sizeof(float) * 2 * k + sizeof(unsigned) * ((size_t)k * nw + nw) + k;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        circle_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  circle_nms_kernel<<<(unsigned)rows, 1024, smem, static_cast<cudaStream_t>(stream)>>>(
      centers, valid, reinterpret_cast<const int64_t*>(order), thresh, keep, k);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
