// Kν rp_window: the random-projection warm start's window candidates.
//
// Replaces (JAX): hnsw_slim_tpu/graph/nnd.py rp_init's per-projection
// inverse permutation, window gather and padding mask (:117-120) and the
// concatenation with the random fill (:124).
//
// For projection p and sorted position i: node = order[p, i] and
// cand[node, p * 2w + j] = order[p, clamp(i + off_j, 0, n - 1)], or -1 where
// that id is >= n_valid (a padding row), with off = -w..-1, 1..w. Because
// order is a permutation, writing by sorted position gives exactly the JAX
// result of gathering by rank = argsort(order), without forming rank. The
// launch for p = 0 also copies the random fill rnd i64[n, R] into the last R
// columns.
//
// What bounds it: bytes. Each order entry is read 2w + 1 times from
// neighbouring addresses (one pass over order through the cache), and every
// candidate word is written once, scattered by node.
//
// Design: one thread per (sorted position, projection), projections on the
// grid's y dimension.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
window_kernel(const int* __restrict__ order, const long long* __restrict__ rnd,
              int n, int n_valid, int w, int R, int C,
              int* __restrict__ cand) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int p = blockIdx.y;
  const int* ord = order + (long long)p * n;
  const long long node = ord[i];
  int* crow = cand + node * C + p * 2 * w;
  for (int j = 0; j < 2 * w; ++j) {
    const long long off = j < w ? j - w : j - w + 1;
    long long pos = i + off;
    pos = pos < 0 ? 0 : (pos > n - 1 ? n - 1 : pos);
    const int c = ord[pos];
    crow[j] = c < n_valid ? c : -1;
  }
  if (p == 0) {
    int* frow = cand + i * C + (long long)gridDim.y * 2 * w;
    for (int j = 0; j < R; ++j) frow[j] = (int)rnd[i * R + j];
  }
}

}  // namespace

// order: i32[P, n] (each row a permutation of 0..n-1); cand: i32[n, C] with
// C = P * 2w + R
extern "C" int hs_rp_window(const int* order, const long long* rnd, int n,
                            int n_valid, int P, int w, int R, int C, int* cand,
                            void* stream) {
  if (n > 0 && P > 0) {
    const dim3 grid((n + THREADS - 1) / THREADS, P);
    window_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        order, rnd, n, n_valid, w, R, C, cand);
  }
  return static_cast<int>(cudaGetLastError());
}
