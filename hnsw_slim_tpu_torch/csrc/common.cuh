// Device helpers shared by the port's kernels (Kα–Kη).
//
// Every routine that takes a shared-memory array is called by ALL threads of
// the block (blockDim.x a multiple of 32) and ends with __syncthreads(); the
// caller syncs once between writing the input and calling.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <math_constants.h>
#include <stdint.h>

#define HS_FULL 0xffffffffu
#define HS_INF CUDART_INF_F

namespace hs {

constexpr int BIG = 1 << 30;  // "no id" sort key (ids are < 2^30)

__host__ __device__ __forceinline__ int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(HS_FULL, v, o);
  return v;
}

// (distance, id) lexicographic order: equal distances put the lower id first
__device__ __forceinline__ bool pair_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// Row element types of the vector store (HnswConfig.store_dtype): float, or
// __nv_bfloat16 for a bfloat16 store. A kernel that reads store rows is a
// template over the type; queries, norms and every sum stay fp32. A bf16
// element widens to fp32 exactly (its 16 bits are the high half of the
// float: the same value __bfloat162float gives), in registers, so the store
// is never copied to fp32.
__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}

// four consecutive elements as fp32: one 16-byte load (fp32) or one 8-byte
// load (bf16; element 0 is the low half of the first word)
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// whether rows of d elements starting at base can take load4: d % 4 == 0
// and the base aligned to four elements
template <class T>
__host__ __device__ __forceinline__ bool can_vec4(const T* base, int d) {
  return (d & 3) == 0 &&
         (reinterpret_cast<uintptr_t>(base) & (4 * sizeof(T) - 1)) == 0;
}

// This lane's share of dot(a, b) and of |b|^2 over d elements (lanes of one
// warp split the row; warp_sum completes both). b may be a global row of
// either row type, a is fp32 in shared memory. vec4 needs can_vec4 of the
// rows' base (a's rows are padded to four floats).
template <class T>
__device__ __forceinline__ void partial_dot(const float* a, const T* b,
                                            int d, bool vec4, float& s,
                                            float& n) {
  const int lane = threadIdx.x & 31;
  if (vec4) {
    for (int e = lane * 4; e < d; e += 128) {
      const float4 x = load4(b + e);
      const float4 y = *reinterpret_cast<const float4*>(a + e);
      s = fmaf(x.x, y.x, s); s = fmaf(x.y, y.y, s);
      s = fmaf(x.z, y.z, s); s = fmaf(x.w, y.w, s);
      n = fmaf(x.x, x.x, n); n = fmaf(x.y, x.y, n);
      n = fmaf(x.z, x.z, n); n = fmaf(x.w, x.w, n);
    }
  } else {
    for (int e = lane; e < d; e += 32) {
      const float x = load1(b + e);
      s = fmaf(x, a[e], s);
      n = fmaf(x, x, n);
    }
  }
}

// dot(a, b) over d elements by one warp (every lane gets the sum), and
// |b|^2 into *nrm when nrm is given; operands as for partial_dot.
template <class T>
__device__ __forceinline__ float warp_dot(const float* a, const T* b, int d,
                                          bool vec4, float* nrm) {
  float s = 0.f, n = 0.f;
  partial_dot(a, b, d, vec4, s, n);
  if (nrm) *nrm = warp_sum(n);
  return warp_sum(s);
}

// Same, with both operands in shared memory.
__device__ __forceinline__ float warp_dot_smem(const float* a, const float* b,
                                               int d) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int e = lane; e < d; e += 32) s = fmaf(a[e], b[e], s);
  return warp_sum(s);
}

// Bitonic sort of n (a power of two) int keys, ascending.
__device__ inline void sort_int(int* a, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int p = i ^ j;
        if (p > i) {
          const int x = a[i], y = a[p];
          const bool up = (i & k) == 0;
          if ((x > y) == up && x != y) { a[i] = y; a[p] = x; }
        }
      }
      __syncthreads();
    }
  }
}

// Bitonic sort of n (a power of two) (d, id) pairs by pair_less, ascending.
__device__ inline void sort_pairs(float* d, int* id, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int p = i ^ j;
        if (p > i) {
          const float da = d[i], db = d[p];
          const int ia = id[i], ib = id[p];
          const bool up = (i & k) == 0;
          const bool swap = up ? pair_less(db, ib, da, ia)
                               : pair_less(da, ia, db, ib);
          if (swap) { d[i] = db; d[p] = da; id[i] = ib; id[p] = ia; }
        }
      }
      __syncthreads();
    }
  }
}

// Stream compaction: for lanes t in [0, n) in order, keep(t, &v) decides and
// gives the value; kept values go to out[0, limit). Returns the number
// written (the same in every thread). scratch holds >= 32 ints.
template <class Keep>
__device__ int compact(int n, Keep keep, int* out, int* scratch, int limit) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int base = 0;
  for (int c0 = 0; c0 < n; c0 += blockDim.x) {
    const int t = c0 + threadIdx.x;
    int v = 0;
    const bool f = t < n && keep(t, v);
    const unsigned m = __ballot_sync(HS_FULL, f);
    if (lane == 0) scratch[warp] = __popc(m);
    __syncthreads();
    int off = 0, tot = 0;
    for (int u = 0; u < nw; ++u) {
      const int c = scratch[u];
      off += (u < warp) ? c : 0;
      tot += c;
    }
    const int r = base + off + __popc(m & ((1u << lane) - 1u));
    if (f && r < limit) out[r] = v;
    base += tot;
    __syncthreads();
  }
  return base < limit ? base : limit;
}

// number of a[0, n) (ascending) strictly below v / at or below v
__device__ __forceinline__ int count_below(const float* a, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}
__device__ __forceinline__ int count_at_or_below(const float* a, int n,
                                                 float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// first index of ascending a[0, n) whose value is >= v / > v
__device__ __forceinline__ int lower_bound(const int* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}
__device__ __forceinline__ int upper_bound(const int* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// binary search for v in ascending a[0, n)
__device__ __forceinline__ bool member(const int* a, int n, int v) {
  const int lo = lower_bound(a, n, v);
  return lo < n && a[lo] == v;
}

// Neighbor-row fetch forms (graph/search.py Fetch), the three ways the JAX
// package reads node v's level row (make_dense_fetch, make_rank_fetch,
// make_chal_fetch):
//   dense: rows i32[N, W];
//   rank:  aux = rank i32[N] (-1 = no row at this level), rows = i32[R, W];
//   CHAL:  rows = nbr i32[E], aux = lvl_off i32[N, stride]; the row is the
//          slice nbr[lvl_off[v, level] : lvl_off[v, level + 1]], cut at W.
enum { FETCH_DENSE = 0, FETCH_RANK = 1, FETCH_CHAL = 2 };
struct Fetch {
  const int* rows;
  const int* aux;
  int mode, W, level, stride;
};

// Node v's row: pointer to its first lane and, in cnt, how many lanes
// (<= W) it has; lanes at or past cnt read as -1. A lane may itself hold -1.
__device__ __forceinline__ const int* fetch_row(const Fetch& f, int v,
                                                int& cnt) {
  if (f.mode == FETCH_DENSE) {
    cnt = f.W;
    return f.rows + (size_t)v * f.W;
  }
  if (f.mode == FETCH_RANK) {
    const int r = __ldg(f.aux + v);
    cnt = r >= 0 ? f.W : 0;
    return f.rows + (size_t)(r >= 0 ? r : 0) * f.W;
  }
  const int* off = f.aux + (size_t)v * f.stride + f.level;
  const int start = __ldg(off), end = __ldg(off + 1);
  cnt = min(max(end - start, 0), f.W);
  return f.rows + start;
}


// RaBitQ estimate scorer (quant/estimator.py QuantScorer; JAX:
// quant/estimator.py est_dist_1bit / est_dist_ex over the packed rows of
// index/slimq.py pack_code_rows). A node's row of `stride` u32 words is
//   [bin (nb) | ex planes (ex_bits * nb) | f_add | f_rescale | f_add_ex |
//    f_rescale_ex (f32 bits) | cluster id],
// bit j of word w of a plane being dimension 32 * w + j. The per-query terms
// are the rotated query q_rot f32[B, 32 * nb], sumq = sum(q_rot) and the
// g_add row f32[C] of the query, indexed by the node's cluster id.
struct Quant {
  const uint32_t* rows;
  int stride, nb, ex_bits, use_ex;
  const float* q_rot;
  const float* sumq;
  const float* g_add;
  int C;
};

// Estimated distance of node `id` by one warp (every lane gets it). qr: the
// query's q_rot (shared or global memory), ga: its g_add row. Lane j owns
// dimension j of every word: the word is broadcast from the lane that
// loaded it and lane j adds q_rot[32 w + j] where bit j is set.
//   1-bit: f_add + g_add + f_rescale * (<q, bin> - sumq / 2)
//   ex:    f_add_ex + g_add + f_rescale_ex *
//          (2^ex <q, bin> + sum_b 2^b <q, ex_b> - (2^ex - 1/2) sumq)
__device__ __forceinline__ float quant_score(const Quant& z, const float* qr,
                                             const float* ga, float sumq,
                                             int id) {
  const int lane = threadIdx.x & 31;
  const uint32_t* row = z.rows + (size_t)id * z.stride;
  const int nb = z.nb;
  const int planes = z.use_ex ? 1 + z.ex_bits : 1;
  float a_bin = 0.f, a_ex = 0.f;
  for (int p = 0; p < planes; ++p) {
    const float wgt = p ? (float)(1 << (p - 1)) : 1.f;
    float acc = 0.f;
    for (int w0 = 0; w0 < nb; w0 += 32) {
      const int cnt = min(32, nb - w0);
      const uint32_t mine = lane < cnt ? __ldg(row + p * nb + w0 + lane) : 0u;
      for (int w = 0; w < cnt; ++w) {
        const uint32_t word = __shfl_sync(HS_FULL, mine, w);
        if ((word >> lane) & 1u) acc += qr[(w0 + w) * 32 + lane];
      }
    }
    if (p) a_ex = fmaf(wgt, acc, a_ex); else a_bin = acc;
  }
  const uint32_t* tail = row + nb * (1 + z.ex_bits);
  const float f_add = __uint_as_float(__ldg(tail + (z.use_ex ? 2 : 0)));
  const float f_rescale = __uint_as_float(__ldg(tail + (z.use_ex ? 3 : 1)));
  const int cid = static_cast<int>(__ldg(tail + 4));
  const float g = ga[cid];
  const float ip_bin = warp_sum(a_bin);
  if (!z.use_ex) return (f_add + g) + f_rescale * (ip_bin - 0.5f * sumq);
  const float ip_ex = warp_sum(a_ex);
  const float two_ex = (float)(1 << z.ex_bits);
  return (f_add + g) +
         f_rescale * ((two_ex * ip_bin + ip_ex) - (two_ex - 0.5f) * sumq);
}


// Rerank track of the quantized beam (graph/search.py PopTrack; JAX: the
// pop_hook of index/slimq.py _slimq_search_jit): every popped node's exact
// distance to an external dataset enters a sorted list of kk (distance, id)
// that comes in and goes out whole, so a caller carries it across levels.
struct PopTrack {
  const float* data;    // f32[N, D] raw vectors; nullptr = no track
  int D, kk;
  const float* q_raw;   // f32[B, D]
  const float* qn_raw;  // f32[B] squared norms (L2 only)
  const float* d_in;    // f32[B, kk]
  const int* id_in;     // i32[B, kk]
  float* d_out;
  int* id_out;
};

}  // namespace hs
