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

// One compare-exchange step of a bitonic sort held in registers: lane
// element idx (its index in the array) and its partner idx ^ j (j < 32, in
// the same warp) of a merge of size k; both lanes keep what the shared-memory
// step of sort_pairs would leave at their index.
__device__ __forceinline__ void shfl_cas(float& v, int& i, int idx, int k,
                                         int j) {
  const float ov = __shfl_xor_sync(HS_FULL, v, j);
  const int oi = __shfl_xor_sync(HS_FULL, i, j);
  const bool keep_small = ((idx & k) == 0) == ((idx & j) == 0);
  if (keep_small ? pair_less(ov, oi, v, i) : pair_less(v, i, ov, oi)) {
    v = ov;
    i = oi;
  }
}

// sort_pairs for n a power of two >= 32: the steps that compare elements
// fewer than 32 apart run in registers with warp shuffles, so a sort of
// 2^p pairs waits at (p - 5)(p - 4) / 2 + p - 4 block barriers instead of
// p (p + 1) / 2. Pairs equal in both fields are interchangeable, so the
// result is the one sort_pairs gives.
__device__ inline void sort_pairs_shfl(float* d, int* id, int n) {
  const int lane = threadIdx.x & 31;
  for (int b = threadIdx.x & ~31; b < n; b += blockDim.x) {
    const int x = b + lane;
    float v = d[x];
    int i = id[x];
    for (int k = 2; k <= 32; k <<= 1)
      for (int j = k >> 1; j > 0; j >>= 1) shfl_cas(v, i, x, k, j);
    d[x] = v;
    id[x] = i;
  }
  __syncthreads();
  for (int k = 64; k <= n; k <<= 1) {
    for (int j = k >> 1; j >= 32; j >>= 1) {
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
    for (int b = threadIdx.x & ~31; b < n; b += blockDim.x) {
      const int x = b + lane;
      float v = d[x];
      int i = id[x];
      for (int j = 16; j > 0; j >>= 1) shfl_cas(v, i, x, k, j);
      d[x] = v;
      id[x] = i;
    }
    __syncthreads();
  }
}

// A set of ids (>= 0) in shared memory, open addressing with linear
// probing, emptied without a pass over it: a slot holds
// (generation << 32 | id) and counts as empty unless its generation is the
// caller's. A table of a power-of-two size, zeroed once, serves generation
// 1, 2, ...; each generation's ids must leave at least one slot empty.
__device__ __forceinline__ unsigned set_slot(int v, unsigned mask) {
  unsigned h = static_cast<unsigned>(v) * 0x9E3779B1u;
  return (h ^ (h >> 16)) & mask;
}

// Adds v to generation g; true if it was not there yet (safe under
// concurrent inserts of the same generation).
__device__ __forceinline__ bool set_insert(unsigned long long* t,
                                           unsigned mask, unsigned g, int v) {
  const unsigned long long want =
      (static_cast<unsigned long long>(g) << 32) | static_cast<unsigned>(v);
  for (unsigned s = set_slot(v, mask);; s = (s + 1) & mask) {
    unsigned long long cur = t[s];
    while (static_cast<unsigned>(cur >> 32) != g) {
      const unsigned long long prev = atomicCAS(t + s, cur, want);
      if (prev == cur) return true;
      cur = prev;
    }
    if (static_cast<int>(static_cast<unsigned>(cur)) == v) return false;
  }
}

__device__ __forceinline__ bool set_has(const unsigned long long* t,
                                        unsigned mask, unsigned g, int v) {
  for (unsigned s = set_slot(v, mask);; s = (s + 1) & mask) {
    const unsigned long long cur = t[s];
    if (static_cast<unsigned>(cur >> 32) != g) return false;
    if (static_cast<int>(static_cast<unsigned>(cur)) == v) return true;
  }
}

// The k-th smallest (1-based, with multiplicity) of the values of a[0, n)
// other than BIG, all below 2^nbits; the caller ensures that more than k
// such values exist. *tk gets how many values equal to it are among the k
// smallest. Needs blockDim.x == 256. hist: 256 ints, zero on entry and
// again on return; list: room for n ints; sm: 16 ints. One radix pass over
// the top 8 of the nbits bits (a 256-bin histogram in shared memory), then
// warp 0 resolves the low bits bit by bit over the chosen bin's values
// alone: five block barriers in all.
__device__ inline int select_kth(const int* a, int n, int k, int nbits,
                                 int* hist, int* list, int* sm, int* tk) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sh = nbits > 8 ? nbits - 8 : 0;
  for (int i = tid; i < n; i += blockDim.x) {
    const int v = a[i];
    if (v != BIG) atomicAdd(hist + (v >> sh), 1);
  }
  __syncthreads();
  const int c = hist[tid];
  int incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(HS_FULL, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) sm[8 + warp] = incl;
  __syncthreads();
  for (int u = 0; u < warp; ++u) incl += sm[8 + u];
  hist[tid] = 0;
  if (incl - c < k && k <= incl) {
    sm[0] = tid;
    sm[1] = k - (incl - c);
    sm[2] = 0;
  }
  __syncthreads();
  const int dig = sm[0];
  for (int i = tid; i < n; i += blockDim.x) {
    const int v = a[i];
    if (v != BIG && (v >> sh) == dig) list[atomicAdd(sm + 2, 1)] = v;
  }
  __syncthreads();
  if (warp == 0) {
    const int cnt = sm[2], kin = sm[1];
    int t = dig << sh;
    for (int bit = sh - 1; bit >= 0; --bit) {
      const int probe = t + (1 << bit);
      int below = 0;
      for (int i = lane; i < cnt; i += 32) below += list[i] < probe;
      if (__reduce_add_sync(HS_FULL, below) < kin) t = probe;
    }
    int lt = 0;
    for (int i = lane; i < cnt; i += 32) lt += list[i] < t;
    lt = __reduce_add_sync(HS_FULL, lt);
    if (lane == 0) {
      sm[3] = t;
      sm[4] = kin - lt;
    }
  }
  __syncthreads();
  *tk = sm[4];
  return sm[3];
}

// The butterfly sums of a warp (warp_sum's tree: at offset o a lane adds
// its partner's value, o = 16 .. 1) of R values per lane at once, R a power
// of two <= 32: while a lane holds more than one value, each step keeps half
// of them and adds the partner's half (one shuffle a kept value), so R sums
// cost R - 1 + 5 - log2 R shuffles instead of 5 R. Every sum adds the same
// operands in the same order as warp_sum, so it is bit-equal to warp_sum's.
// On return v[0] of lane l holds the sum of value l / (32 / R).
template <int R>
__device__ __forceinline__ void warp_sum_rows(float (&v)[R]) {
  const int lane = threadIdx.x & 31;
  int o = 16;
#pragma unroll
  for (int h = R / 2; h >= 1; h >>= 1, o >>= 1) {
    const bool up = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = up ? v[i] : v[i + h];
      const float keep = up ? v[i + h] : v[i];
      v[i] = keep + __shfl_xor_sync(HS_FULL, send, o);
    }
  }
  for (; o > 0; o >>= 1) v[0] += __shfl_xor_sync(HS_FULL, v[0], o);
}

// dot(a, b_r) and |b_r|^2 of R rows b_r at once by one warp: the loads of
// all R rows are issued before any is summed, so a warp has R random rows
// in flight instead of one. Each row's lane sums run in partial_dot's order
// and are reduced by warp_sum_rows, so each result is bit-equal to
// warp_dot's. On return lane l holds, in s and n, the sums of row
// l / (32 / R). Rows r >= nr are not read. With st_r given, row r is also
// stored widened to fp32 at st_r (scalar stores: any alignment). a is fp32
// in shared memory.
template <int R, class T>
__device__ __forceinline__ void warp_dot_rows(const float* a,
                                              const T* const (&b)[R], int nr,
                                              int d, bool vec4, float& s_out,
                                              float& n_out,
                                              float* const (&st)[R]) {
  const int lane = threadIdx.x & 31;
  float s[R], n[R];
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = n[r] = 0.f;
  if (vec4) {
    for (int e = lane * 4; e < d; e += 128) {
      float4 x[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        x[r] = r < nr ? load4(b[r] + e) : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 y = *reinterpret_cast<const float4*>(a + e);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        s[r] = fmaf(x[r].x, y.x, s[r]); s[r] = fmaf(x[r].y, y.y, s[r]);
        s[r] = fmaf(x[r].z, y.z, s[r]); s[r] = fmaf(x[r].w, y.w, s[r]);
        n[r] = fmaf(x[r].x, x[r].x, n[r]); n[r] = fmaf(x[r].y, x[r].y, n[r]);
        n[r] = fmaf(x[r].z, x[r].z, n[r]); n[r] = fmaf(x[r].w, x[r].w, n[r]);
        if (st[r] != nullptr && r < nr) {
          st[r][e] = x[r].x; st[r][e + 1] = x[r].y;
          st[r][e + 2] = x[r].z; st[r][e + 3] = x[r].w;
        }
      }
    }
  } else {
    for (int e = lane; e < d; e += 32) {
      const float y = a[e];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < nr) {
          const float x = load1(b[r] + e);
          s[r] = fmaf(x, y, s[r]);
          n[r] = fmaf(x, x, n[r]);
          if (st[r] != nullptr) st[r][e] = x;
        }
      }
    }
  }
  warp_sum_rows<R>(s);
  warp_sum_rows<R>(n);
  s_out = s[0];
  n_out = n[0];
}

// warp_dot_rows over fp32 rows in shared memory (16-byte aligned, d % 4 ==
// 0): the same vec4 lane order, so each sum is bit-equal to warp_dot's of
// the same row in device memory. Returns the dot of row lane / (32 / R).
template <int R>
__device__ __forceinline__ float warp_dot_rows_smem(const float* a,
                                                    const float* const (&b)[R],
                                                    int nr, int d) {
  const int lane = threadIdx.x & 31;
  float s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = 0.f;
  for (int e = lane * 4; e < d; e += 128) {
    const float4 y = *reinterpret_cast<const float4*>(a + e);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nr) {
        const float4 x = *reinterpret_cast<const float4*>(b[r] + e);
        s[r] = fmaf(x.x, y.x, s[r]); s[r] = fmaf(x.y, y.y, s[r]);
        s[r] = fmaf(x.z, y.z, s[r]); s[r] = fmaf(x.w, y.w, s[r]);
      }
    }
  }
  warp_sum_rows<R>(s);
  return s[0];
}

// Up to 32 dots of one shared-memory row a with shared-memory rows b_j,
// j < nb, by one warp: lane j passes b_j as its float offset from base and
// gets dot(a, b_j) back, in the lane-strided order (lane l sums elements
// e = l, l + 32, ... with fmaf(a[e], b[e], .), then warp_sum's tree) that
// a warp computing one dot at a time would use. Each lane keeps its
// elements of a in registers and sums eight rows at a time; warp_sum_rows
// adds the lane sums as warp_sum does. So each row is read once (no bank
// clash: lanes read consecutive elements) and 32 dots cost 4 x 9 + 4
// shuffles, not 160.
__device__ __forceinline__ float warp_dots_smem(const float* a,
                                                const float* base, int off,
                                                int nb, int d) {
  const int lane = threadIdx.x & 31;
  float res = 0.f;
  for (int q0 = 0; q0 < nb; q0 += 8) {
    float s[8];
    int o[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      s[r] = 0.f;
      o[r] = __shfl_sync(HS_FULL, off, q0 + r);
    }
    for (int e0 = 0; e0 < d; e0 += 128) {
      float av[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = e0 + lane + 32 * k;
        av[k] = e < d ? a[e] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (q0 + r < nb) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int e = e0 + lane + 32 * k;
            if (e < d) s[r] = fmaf(av[k], base[o[r] + e], s[r]);
          }
        }
      }
    }
    warp_sum_rows<8>(s);  // lane l: row q0 + l / 4
    const float v = __shfl_sync(HS_FULL, s[0], 4 * (lane & 7));
    if ((lane >> 3) == (q0 >> 3)) res = v;
  }
  return res;
}

// 16-byte asynchronous copies from device to shared memory (cp.async,
// sm_80+), committed as one group; cp_async_wait_all waits for all of
// this thread's groups (a block barrier then makes them visible to all).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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

// Words of each code row that one gather round of quant_score_rows takes
// (quant/estimator.py ROUND_WORDS): R rows' share of a round is R words a
// lane, and a warp's stage holds QUANT_ROUND_WORDS * R words.
constexpr int QUANT_ROUND_WORDS = 32;

// Estimated distances of R nodes ids[r] (r < nr; rows r >= nr are not
// read) by one warp, lane l returning the estimate of row l / (32 / R).
// qr: the query's q_rot (shared or global memory), ga: its g_add row,
// stage: the warp's QUANT_ROUND_WORDS * R words of shared memory, 16-byte
// aligned.
//
// Gather once, then compute. A row's words that the estimate reads — the
// bin plane, the ex planes in the full-code mode, then the five words of
// factors and cluster id — are numbered u = 0, 1, ... The warp loads
// QUANT_ROUND_WORDS of them of every row in one round, all in flight
// together before any is summed: lane l loads the words u = u0 + (32 / R) k
// + l / R of row l % R (32 / R consecutive words of a row a load: one
// coalesced piece of each row) and stores them to the stage, word u of row
// r at (u - u0) R + r. A row whose words exceed a round (wide P, many ex
// bits) takes as many rounds as it needs; at P = 128 and 1 + 3 bits a row
// is 21 words, one round (and the 1-bit mode 9). Then each lane reads word
// u of all R rows with one broadcast load (16 bytes at R = 4; a broadcast
// load instead of R shuffles, which bound the scorer's issue rate): lane j
// adds q_rot[32 w + j] where bit j of a plane word is set, and takes its
// own row's factors and cluster id. The sums run in the one-row order —
// each plane's words in order, fmaf(2^(p-1), plane sum, ex sum) a plane,
// warp_sum_rows' tree — so every estimate is bit-equal for every R.
//   1-bit: f_add + g_add + f_rescale * (<q, bin> - sumq / 2)
//   ex:    f_add_ex + g_add + f_rescale_ex *
//          (2^ex <q, bin> + sum_b 2^b <q, ex_b> - (2^ex - 1/2) sumq)
template <int R>
__device__ __forceinline__ float quant_score_rows(const Quant& z,
                                                  const float* qr,
                                                  const float* ga, float sumq,
                                                  const int (&ids)[R],
                                                  int nr, uint32_t* stage) {
  static_assert(R >= 1 && R <= 32 && (32 % R) == 0, "R divides 32");
  constexpr int PER = 32 / R;  // words of each row in a slot
  const int lane = threadIdx.x & 31;
  const int nb = z.nb;
  const int ncode = (z.use_ex ? 1 + z.ex_bits : 1) * nb;  // plane words read
  const int nw = ncode + 5;
  const int tail = nb * (1 + z.ex_bits);  // the five words' place in a row
  const int t_add = z.use_ex ? 2 : 0;     // f_add (ex: f_add_ex), f_rescale
  // the row this lane loads, and the row whose estimate it returns
  const int r_ld = lane % R, me = lane / PER;
  int id_ld = ids[0];
#pragma unroll
  for (int r = 1; r < R; ++r)
    if (r == r_ld) id_ld = ids[r];
  const uint32_t* row = z.rows + (size_t)id_ld * z.stride;
  float a_bin[R], a_ex[R], acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) a_bin[r] = a_ex[r] = acc[r] = 0.f;
  uint32_t f_add_w = 0u, f_rescale_w = 0u, cid_w = 0u;
  int p = 0, w = 0;  // plane and word of the next plane word
  for (int u0 = 0; u0 < nw; u0 += QUANT_ROUND_WORDS) {
    const int un = min(nw, u0 + QUANT_ROUND_WORDS);
    uint32_t v[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int u = u0 + k * PER + lane / R;
      v[k] = (r_ld < nr && u < un)
                 ? __ldg(row + (u < ncode ? u : tail + (u - ncode)))
                 : 0u;
    }
    __syncwarp();  // the stage's last reads are done
#pragma unroll
    for (int k = 0; k < R; ++k) stage[k * 32 + lane] = v[k];
    __syncwarp();
    for (int u = u0; u < un; ++u) {
      const uint32_t* wr = stage + (u - u0) * R;  // word u of rows 0..R-1
      if (u < ncode) {
        const float qe = qr[w * 32 + lane];
        uint32_t wd[R];
        if constexpr (R % 4 == 0) {
#pragma unroll
          for (int r = 0; r < R; r += 4) {
            const uint4 x = *reinterpret_cast<const uint4*>(wr + r);
            wd[r] = x.x;
            wd[r + 1] = x.y;
            wd[r + 2] = x.z;
            wd[r + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int r = 0; r < R; ++r) wd[r] = wr[r];
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
          if ((wd[r] >> lane) & 1u) acc[r] += qe;
        if (++w == nb) {
          const float wgt = p ? (float)(1 << (p - 1)) : 1.f;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (p) a_ex[r] = fmaf(wgt, acc[r], a_ex[r]);
            else a_bin[r] = acc[r];
            acc[r] = 0.f;
          }
          w = 0;
          ++p;
        }
      } else {
        const int t = u - ncode;
        const uint32_t word = wr[me];
        if (t == t_add) f_add_w = word;
        else if (t == t_add + 1) f_rescale_w = word;
        else if (t == 4) cid_w = word;
      }
    }
  }
  const bool ok = me < nr;
  const float f_add = ok ? __uint_as_float(f_add_w) : 0.f;
  const float f_rescale = ok ? __uint_as_float(f_rescale_w) : 0.f;
  const int cid = ok ? static_cast<int>(cid_w) : 0;
  const float g = ga[cid];
  // Each rounding is spelled out (f_rescale's product fused into the last
  // add, the sumq term's product rounded on its own), so every kernel that
  // inlines the scorer rounds alike instead of as its compiler contracts.
  // Products by 2^ex and 1/2 are exact.
  warp_sum_rows<R>(a_bin);
  const float ip_bin = a_bin[0];
  if (!z.use_ex) return fmaf(f_rescale, ip_bin - 0.5f * sumq, f_add + g);
  warp_sum_rows<R>(a_ex);
  const float ip_ex = a_ex[0];
  const float two_ex = (float)(1 << z.ex_bits);
  return fmaf(f_rescale,
              (two_ex * ip_bin + ip_ex) - __fmul_rn(two_ex - 0.5f, sumq),
              f_add + g);
}

// The estimate of one node `id` by one warp (every lane gets it); stage
// as for quant_score_rows<1>.
__device__ __forceinline__ float quant_score(const Quant& z, const float* qr,
                                             const float* ga, float sumq,
                                             int id, uint32_t* stage) {
  const int ids[1] = {id};
  return quant_score_rows<1>(z, qr, ga, sumq, ids, 1, stage);
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
