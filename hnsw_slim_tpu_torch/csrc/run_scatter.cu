// Kμ run_scatter: the rank of each element within its run of a sorted key
// array, and the scatter of the first R of each run into rows; a dedup mode
// marks repeated (key, value) pairs.
//
// Replaces (JAX): hnsw_slim_tpu/graph/nnd.py sorted_run_rank (:33-42) with the
// reverse-edge scatter of _nnd_candidates / nnd_round (:172-177, :254-259),
// and in hnsw_slim_tpu/graph/build.py mutual_union the adjacent-duplicate mark
// (:233-236) and the ranked scatter (:241-248).
//
// Scatter mode: keys i32[E] sorted ascending, payload i32[E]. Element i has
// rank = i - (first index of its run), counted over the whole run before any
// test, as the JAX code counts it; it is kept when rank < R, key < n and
// payload < n_valid, and then rows[key, rank] = payload in an i32[n, R] buffer
// the caller filled with -1. Kept elements have distinct (key, rank), so the
// writes never collide and nothing is read back to the host.
// Dedup mode: keys and values sorted by (key, value); out[i] = n where
// (key, value) equals the pair before it, else key.
//
// What bounds it: bytes, 8 B an element read and at most 4 B written; the run
// start costs a few more reads of the same cache lines.
//
// Design: one thread per element. The run start is found by a galloping
// search backwards (steps 1, 2, 4 ... until a smaller key, then a binary
// search in the last step), so a short run costs one or two reads and a hub's
// long run log2 of its length; Kζ's run rank is a binary search over the
// whole array.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

// first index j <= i with a[j] == a[i] (a ascending)
__device__ __forceinline__ long long run_start(const int* __restrict__ a,
                                               long long i, int v) {
  long long known = i, probe = i - 1, step = 1;
  while (probe >= 0 && a[probe] == v) {
    known = probe;
    step <<= 1;
    probe = i - step;
  }
  long long lo = probe < 0 ? 0 : probe + 1, hi = known;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
scatter_kernel(const int* __restrict__ keys, const int* __restrict__ pay,
               int E, int n, int R, int n_valid, int* __restrict__ rows) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= E) return;
  const int key = keys[i];
  if (key < 0 || key >= n) return;
  const long long rank = i - run_start(keys, i, key);
  const int v = pay[i];
  if (rank < R && v < n_valid) rows[(size_t)key * R + rank] = v;
}

__global__ void __launch_bounds__(THREADS)
dedup_kernel(const int* __restrict__ keys, const int* __restrict__ vals, int E,
             int n, int* __restrict__ out) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= E) return;
  const int key = keys[i];
  out[i] = (i > 0 && keys[i - 1] == key && vals[i - 1] == vals[i]) ? n : key;
}

}  // namespace

extern "C" int hs_run_scatter(const int* keys, const int* pay, int E, int n,
                              int R, int n_valid, int* rows, void* stream) {
  if (E > 0)
    scatter_kernel<<<(E + THREADS - 1) / THREADS, THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(keys, pay, E, n, R,
                                                          n_valid, rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hs_run_dedup(const int* keys, const int* vals, int E, int n,
                            int* out, void* stream) {
  if (E > 0)
    dedup_kernel<<<(E + THREADS - 1) / THREADS, THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(keys, vals, E, n, out);
  return static_cast<int>(cudaGetLastError());
}
