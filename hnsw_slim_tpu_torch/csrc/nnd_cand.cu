// Kλ nnd_cand: NN-descent candidate generation, one warp per node, in two
// modes.
//
// Replaces (JAX): hnsw_slim_tpu/graph/nnd.py _nnd_candidates / nnd_round —
// pivot mode: the pivot score, the per-row argsort and its take_along_axis
// (:152-156, :231-236), the forward 2-hop gather (:157-160, :237-240) and the
// clearing of the explored pivots' new flags (:162-164, :242-246); join mode:
// the local-join gathers (:179-183, :264-268) and the concatenation of
// [fwd, rev, join] (:185, :270).
//
// Pivot mode: score = rand (new entry) or rand + 2 (old entry), +inf for an
// empty slot; the row's k (score, position) pairs are sorted with a bitonic
// network inside the warp (k <= 64, two pairs a lane, padding positions >= k
// behind every real one). The position breaks ties, so the order is
// jnp.argsort's stable order. For the first s_fwd sorted positions (empty
// slots too, as in JAX): mid = ids[row, piv], cand[row, e] = ids[mid, r2] or
// -1, and the pivot's new flag is cleared in the output flags.
// Join mode: cand[row, s_fwd:s_fwd + r_rev] = rev[row], and
// cand[row, s_fwd + r_rev + e] = ids[jrev, r4] or -1 with jrev = rev[row, r3].
//
// What bounds it: bytes. A row reads its k ids, flags and scores and writes k
// flags; each candidate costs one gathered 4-byte id (a scattered read) and
// one write. The sort is 21 compare-exchange steps in registers.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;

__device__ __forceinline__ bool key_less(float sa, int pa, float sb, int pb) {
  return sa < sb || (sa == sb && pa < pb);
}

__global__ void __launch_bounds__(THREADS)
pivot_kernel(const int* __restrict__ ids, const int* __restrict__ newf,
             const float* __restrict__ rkey, const long long* __restrict__ r2,
             int n, int k, int s_fwd, int C, int* __restrict__ cand,
             int* __restrict__ newf_out) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * NW + (threadIdx.x >> 5);
  if (row >= n) return;
  const int* irow = ids + row * k;
  float s[2];
  int p[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int e = lane + 32 * j;
    p[j] = e;
    s[j] = HS_INF;
    if (e < k && irow[e] >= 0) {
      const float r = rkey[row * k + e];
      s[j] = newf[row * k + e] == 1 ? r : r + 2.0f;
    }
  }
  // bitonic sort of the 64 (score, position) pairs: element e = lane + 32 j
  for (int size = 2; size <= 64; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride == 32) {  // size 64: slot 0 against slot 1, ascending
        if (key_less(s[1], p[1], s[0], p[0])) {
          const float ts = s[0];
          const int tp = p[0];
          s[0] = s[1];
          p[0] = p[1];
          s[1] = ts;
          p[1] = tp;
        }
        continue;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = lane + 32 * j;
        const float os = __shfl_xor_sync(HS_FULL, s[j], stride);
        const int op = __shfl_xor_sync(HS_FULL, p[j], stride);
        const bool asc = (e & size) == 0;
        const bool lower = (e & stride) == 0;
        const bool other_less = key_less(os, op, s[j], p[j]);
        // the lower element of an ascending pair keeps the smaller one
        if (other_less == (lower == asc)) {
          s[j] = os;
          p[j] = op;
        }
      }
    }
  }
  unsigned lo = 0u, hi = 0u;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int e = lane + 32 * j;
    if (e < s_fwd) {
      const int piv = p[j];
      const int mid = irow[piv];
      cand[row * C + e] =
          mid >= 0 ? ids[(long long)mid * k + (int)r2[row * s_fwd + e]] : -1;
      if (piv < 32) lo |= 1u << piv; else hi |= 1u << (piv - 32);
    }
  }
  lo = __reduce_or_sync(HS_FULL, lo);
  hi = __reduce_or_sync(HS_FULL, hi);
  if (lane < k) newf_out[row * k + lane] = (lo >> lane) & 1u
      ? 0 : newf[row * k + lane];
  if (lane + 32 < k) newf_out[row * k + lane + 32] = (hi >> lane) & 1u
      ? 0 : newf[row * k + lane + 32];
}

__global__ void __launch_bounds__(THREADS)
join_kernel(const int* __restrict__ ids, const int* __restrict__ rev,
            const long long* __restrict__ r3, const long long* __restrict__ r4,
            int n, int k, int s_fwd, int r_rev, int C,
            int* __restrict__ cand) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * NW + (threadIdx.x >> 5);
  if (row >= n) return;
  const int* rrow = rev + row * r_rev;
  int* crow = cand + row * C + s_fwd;
  for (int j = lane; j < r_rev; j += 32) crow[j] = rrow[j];
  for (int e = lane; e < s_fwd; e += 32) {
    const int jrev = rrow[(int)r3[row * s_fwd + e]];
    crow[r_rev + e] =
        jrev >= 0 ? ids[(long long)jrev * k + (int)r4[row * s_fwd + e]] : -1;
  }
}

}  // namespace

extern "C" int hs_nnd_pivot(const int* ids, const int* newf, const float* rkey,
                            const long long* r2, int n, int k, int s_fwd,
                            int C, int* cand, int* newf_out, void* stream) {
  if (n > 0)
    pivot_kernel<<<(n + NW - 1) / NW, THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        ids, newf, rkey, r2, n, k, s_fwd, C, cand, newf_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hs_nnd_join(const int* ids, const int* rev, const long long* r3,
                           const long long* r4, int n, int k, int s_fwd,
                           int r_rev, int C, int* cand, void* stream) {
  if (n > 0)
    join_kernel<<<(n + NW - 1) / NW, THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        ids, rev, r3, r4, n, k, s_fwd, r_rev, C, cand);
  return static_cast<int>(cudaGetLastError());
}
