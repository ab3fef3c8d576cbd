// Kη fht_rotate: the FhtKac rotation, one warp per row; and beside it the
// per-query terms of the RaBitQ estimate (sum of the rotated query and the
// per-centroid g_add table).
//
// Replaces (JAX): hnsw_slim_tpu/quant/rotator.py _rotate / fht (four rounds
// of sign flip, log2(P) reshape-butterfly stages and a 1/sqrt(P) scale, one
// fused XLA program) and hnsw_slim_tpu/quant/estimator.py centroid_g_tables
// with the sum(q_rot) of index/slimq.py _slimq_search_jit.
//
// What bounds it: bytes. A row is read once (4 D bytes) and written once
// (4 P bytes); the 4 * log2(P) add/subtract passes over P values are far
// below the arithmetic rate. The table kernel reads B P + C P floats and
// writes B (C + 1).
//
// Design: the row sits in shared memory, P floats per warp, eight rows per
// block; the zero padding from D to P happens at the load, so no padded copy
// of the input is made. A stage pairs element i (bit h clear) with i + h and
// writes (a0 + a1, a0 - a1) — the reference's stage order h = 1, 2, .. P/2
// with exactly one rounded add or subtract per element and stage, so the
// result has the reference's bits (the sign flip multiplies by +-1, the
// scale is one rounded multiply; the intrinsics keep the compiler from
// contracting them into FMAs). Lanes of a warp synchronise with __syncwarp
// between stages; there is no block barrier.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
fht_kernel(const float* __restrict__ x, const float* __restrict__ signs,
           float fac, int B, int D, int P, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * NW + warp;
  if (b >= B) return;  // whole warp
  float* s = reinterpret_cast<float*>(smem) + (size_t)warp * P;
  for (int i = lane; i < P; i += 32)
    s[i] = i < D ? x[(size_t)b * D + i] : 0.f;
  __syncwarp();
  for (int r = 0; r < 4; ++r) {
    const float* sg = signs + (size_t)r * P;
    for (int i = lane; i < P; i += 32) s[i] = __fmul_rn(s[i], __ldg(sg + i));
    __syncwarp();
    for (int h = 1; h < P; h <<= 1) {
      for (int t = lane; t < P / 2; t += 32) {
        const int i = ((t / h) * 2 * h) + (t % h);
        const float a0 = s[i], a1 = s[i + h];
        s[i] = __fadd_rn(a0, a1);
        s[i + h] = __fsub_rn(a0, a1);
      }
      __syncwarp();
    }
    for (int i = lane; i < P; i += 32) s[i] = __fmul_rn(s[i], fac);
    __syncwarp();
  }
  for (int i = lane; i < P; i += 32) out[(size_t)b * P + i] = s[i];
}

// one block per query: sumq[b] = sum(q_rot[b]); g_add[b, c] = sum((q - c)^2)
// in the difference form (L2) or -<q, c> (IP), one warp per centroid
__global__ void __launch_bounds__(THREADS)
g_tables_kernel(const float* __restrict__ q_rot,
                const float* __restrict__ cent, int C, int P, int metric,
                float* __restrict__ sumq, float* __restrict__ g_add) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < P; i += THREADS)
    qs[i] = q_rot[(size_t)b * P + i];
  __syncthreads();
  if (warp == 0) {
    float s = 0.f;
    for (int i = lane; i < P; i += 32) s += qs[i];
    s = hs::warp_sum(s);
    if (lane == 0) sumq[b] = s;
  }
  for (int c = warp; c < C; c += NW) {
    const float* cr = cent + (size_t)c * P;
    float s = 0.f;
    for (int i = lane; i < P; i += 32) {
      const float cv = __ldg(cr + i);
      if (metric) {
        s = fmaf(qs[i], cv, s);
      } else {
        const float df = qs[i] - cv;
        s = fmaf(df, df, s);
      }
    }
    s = hs::warp_sum(s);
    if (lane == 0) g_add[(size_t)b * C + c] = metric ? -s : s;
  }
}

}  // namespace

extern "C" int hs_fht_rotate(const float* x, const float* signs, float fac,
                             int B, int D, int P, float* out, void* stream) {
  if (P < 64 || (P & (P - 1)) || D > P)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * P * NW;
  cudaError_t err = cudaFuncSetAttribute(
      fht_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fht_kernel<<<(B + NW - 1) / NW, THREADS, smem,
               static_cast<cudaStream_t>(stream)>>>(x, signs, fac, B, D, P,
                                                    out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hs_g_tables(const float* q_rot, const float* cent, int B,
                           int C, int P, int metric, float* sumq,
                           float* g_add, void* stream) {
  g_tables_kernel<<<B, THREADS, sizeof(float) * P,
                    static_cast<cudaStream_t>(stream)>>>(q_rot, cent, C, P,
                                                         metric, sumq, g_add);
  return static_cast<int>(cudaGetLastError());
}
