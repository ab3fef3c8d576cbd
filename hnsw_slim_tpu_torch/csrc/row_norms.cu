// Kξ row_norms: the squared norm of every row, ||x_r||^2, f32[N] from fp32
// or bfloat16 rows.
//
// Replaces (JAX): hnsw_slim_tpu/ops/distance.py sq_norms —
// jnp.sum(x * x, -1) under jax.jit, which XLA fuses into one reduction so
// that no [N, D] temporary exists (a 16M x 128 bfloat16 store would need
// 8 GB of fp32 upcast). It runs on every search's queries, inside every Kα
// call, on every build batch and over the whole store on build, load,
// union and set_dataset.
//
// What bounds it: bytes. Each row is read once (N * D * 4 B for fp32, 2 B
// for bf16) and one float a row is written; there are 2 flops an element.
// 1M x 128 fp32 is 516 MB: 0.154 ms at 3.35 TB/s.
//
// Design: one warp per row, consecutive rows on consecutive warps of a
// block, so a block's loads tile one contiguous span. Where D, the base and
// the row stride allow, a lane reads 16 bytes at a time (4 fp32 or 8 bf16
// elements; a 128-dim fp32 row is one load a lane), else one element.
// Nothing but the output is written, and the kernel keeps no state between
// rows, so a full card of resident warps keeps enough loads in flight.
//
// Summation order (fixed; the same for every launch): lane l takes the
// chunks c = l, l + 32, l + 64, ... of W consecutive elements (W = 4 fp32 or
// 8 bf16 on the 16-byte path, else W = 1) and adds each element's square in
// order, acc = acc + x * x, from 0, rounding the product and the sum
// separately (__fmul_rn, __fadd_rn: never contracted into an FMA). The 32
// lane sums then fold by an xor butterfly over offsets 16, 8, 4, 2, 1, each
// lane adding its partner's sum (every lane ends with the same value), and
// lane 0 writes it. A bf16 element widens to fp32 exactly.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;

__device__ __forceinline__ float sq_add(float acc, float v) {
  return __fadd_rn(acc, __fmul_rn(v, v));
}

// the squares of 16 bytes of a row, in element order
__device__ __forceinline__ float chunk_sq(const float* p, float acc) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  acc = sq_add(acc, f.x);
  acc = sq_add(acc, f.y);
  acc = sq_add(acc, f.z);
  return sq_add(acc, f.w);
}
__device__ __forceinline__ float chunk_sq(const __nv_bfloat16* p, float acc) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // element 2i is the low half of word i
    acc = sq_add(acc, __uint_as_float(w[i] << 16));
    acc = sq_add(acc, __uint_as_float(w[i] & 0xffff0000u));
  }
  return acc;
}

template <class T, bool VEC>
__global__ void __launch_bounds__(THREADS)
row_norms_kernel(const T* __restrict__ x, int n, int d, long long stride,
                 float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * NW + (threadIdx.x >> 5);
  if (r >= n) return;  // warp-uniform
  const T* row = x + r * stride;
  float acc = 0.f;
  if constexpr (VEC) {
    constexpr int W = 16 / sizeof(T);
    for (int e = lane * W; e < d; e += 32 * W) acc = chunk_sq(row + e, acc);
  } else {
    for (int e = lane; e < d; e += 32) acc = sq_add(acc, hs::load1(row + e));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(HS_FULL, acc, o));
  if (lane == 0) out[r] = acc;
}

template <class T>
int launch(const T* x, int n, int d, long long stride, float* out,
           void* stream) {
  if (n <= 0 || d < 0 || stride < d)
    return static_cast<int>(n == 0 ? cudaSuccess : cudaErrorInvalidValue);
  constexpr int W = 16 / sizeof(T);
  const bool vec = d % W == 0 && stride % W == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int grid = (n + NW - 1) / NW;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    row_norms_kernel<T, true><<<grid, THREADS, 0, st>>>(x, n, d, stride, out);
  else
    row_norms_kernel<T, false><<<grid, THREADS, 0, st>>>(x, n, d, stride, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: n rows of d elements, row r at x + r * stride (elements); out f32[n]
extern "C" int hs_row_norms(const float* x, int n, int d, long long stride,
                            float* out, void* stream) {
  return launch(x, n, d, stride, out, stream);
}

extern "C" int hs_row_norms_bf16(const __nv_bfloat16* x, int n, int d,
                                 long long stride, float* out, void* stream) {
  return launch(x, n, d, stride, out, stream);
}
