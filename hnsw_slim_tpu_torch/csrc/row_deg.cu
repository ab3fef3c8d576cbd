// Kθ row_deg: the occupancy of every adjacency row.
//
// Replaces (JAX): hnsw_slim_tpu/index/hnsw.py _row_deg —
// deg[r] = #{c : a[r, c] >= 0} for a level's adjacency i32[N, cap], the
// degree array the fused insert apply appends against (every writer keeps
// rows left-packed, so occupancy is the count of ids).
//
// What bounds it: bytes. Each adjacency word is read once (N * cap * 4 B) and
// one count per row is written; there is one compare per word.
//
// Design: one warp per row. The rows of a block are consecutive in memory, so
// its warps' loads tile one contiguous span; a lane counts its columns and a
// shuffle sum folds the warp.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
row_deg_kernel(const int* __restrict__ a, int n, int cap,
               int* __restrict__ deg) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * NW + (threadIdx.x >> 5);
  if (r >= n) return;
  const int* row = a + r * cap;
  int c = 0;
  for (int j = lane; j < cap; j += 32) c += row[j] >= 0;
  for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(HS_FULL, c, o);
  if (lane == 0) deg[r] = c;
}

}  // namespace

extern "C" int hs_row_deg(const int* a, int n, int cap, int* deg,
                          void* stream) {
  const int grid = (n + NW - 1) / NW;
  row_deg_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, n, cap, deg);
  return static_cast<int>(cudaGetLastError());
}
