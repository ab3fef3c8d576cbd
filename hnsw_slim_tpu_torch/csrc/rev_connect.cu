// Kζ rev_connect: the reverse-connect steps of the fused insert apply, all
// but its two RNG prunes (those run on Kγ).
//
// Replaces (JAX): hnsw_slim_tpu/graph/revconn.py apply_insert steps 3-5 —
// the per-edge run rank (searchsorted over the target-sorted reverse-edge
// list), the fitting appends adj[u, deg[u] + rank] = p with the degree
// update, the candidate rows {row ∪ first new_w new edges} of the overflow
// targets, and the scatter of their re-pruned rows (mutuallyConnectNewElement,
// hnswalg.h:618-687, batched).
//
// What bounds it: bytes, and few of them. A batch reads its edge list (8 B an
// edge) and the degree of each edge's target and writes 4 B per appended
// edge; an overflow target reads its row and writes cap + new_w ints. The
// accesses are scattered 4-byte words, so transactions and launch latency
// rule, not bandwidth.
//
// Design, in the JAX program's order, on the sorted edge list (us ascending,
// ps the inserter of each edge; targets >= 2^30 are padding):
//   append:  one thread per edge finds the start of its target's run by
//            binary search, reads deg[u] and writes the edge at column
//            deg[u] + rank when that is below cap; otherwise it flags the
//            edge as overflowing;
//   degree:  a second launch, so that every deg read of the first launch
//            precedes every write: the first edge of each run sets
//            deg[u] = min(deg[u] + run length, cap);
//   rows:    one warp per overflow target copies the target's row and its
//            first new_w overflow edges (binary search in the sorted
//            overflow list) into a candidate row for Kγ; a padding target
//            gets an empty row and base id 0;
//   write:   one warp per valid target writes the re-pruned row and count.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
append_kernel(const int* __restrict__ us, const int* __restrict__ ps, int E,
              const int* __restrict__ deg, int* __restrict__ adj, int cap,
              unsigned char* __restrict__ ovf) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= E) return;
  const int u = us[e];
  if (u >= hs::BIG) {
    ovf[e] = 0;
    return;
  }
  const int rank = e - hs::lower_bound(us, e, u);
  const int col = deg[u] + rank;
  if (col < cap) adj[(size_t)u * cap + col] = ps[e];
  ovf[e] = col >= cap;
}

__global__ void __launch_bounds__(THREADS)
degree_kernel(const int* __restrict__ us, int E, int* __restrict__ deg,
              int cap) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= E) return;
  const int u = us[e];
  if (u >= hs::BIG || (e > 0 && us[e - 1] == u)) return;
  const int len = hs::upper_bound(us + e, E - e, u);
  deg[u] = min(deg[u] + len, cap);
}

__global__ void __launch_bounds__(THREADS)
rows_kernel(const int* __restrict__ adj, int cap, const int* __restrict__ of_u,
            const int* __restrict__ of_p, int E, const int* __restrict__ ut,
            int T, int new_w, int* __restrict__ base,
            int* __restrict__ ocand) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * NW + (threadIdx.x >> 5);
  if (t >= T) return;
  const int u = ut[t];
  const int width = cap + new_w;
  int* orow = ocand + (size_t)t * width;
  if (u >= hs::BIG) {
    for (int j = lane; j < width; j += 32) orow[j] = -1;
    if (lane == 0) base[t] = 0;
    return;
  }
  const int start = hs::lower_bound(of_u, E, u);
  const int take = min(hs::upper_bound(of_u, E, u) - start, new_w);
  for (int j = lane; j < cap; j += 32) orow[j] = adj[(size_t)u * cap + j];
  for (int j = lane; j < new_w; j += 32)
    orow[cap + j] = j < take ? of_p[start + j] : -1;
  if (lane == 0) base[t] = u;
}

__global__ void __launch_bounds__(THREADS)
write_kernel(int* __restrict__ adj, int* __restrict__ deg, int cap,
             const int* __restrict__ ut, int T, const int* __restrict__ osel,
             const int* __restrict__ ocnt) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * NW + (threadIdx.x >> 5);
  if (t >= T) return;
  const int u = ut[t];
  if (u >= hs::BIG) return;
  for (int j = lane; j < cap; j += 32)
    adj[(size_t)u * cap + j] = osel[(size_t)t * cap + j];
  if (lane == 0) deg[u] = ocnt[t];
}

}  // namespace

extern "C" int hs_rev_append(const int* us, const int* ps, int E, int* adj,
                             int* deg, int cap, unsigned char* ovf,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (E + THREADS - 1) / THREADS;
  append_kernel<<<grid, THREADS, 0, s>>>(us, ps, E, deg, adj, cap, ovf);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  degree_kernel<<<grid, THREADS, 0, s>>>(us, E, deg, cap);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hs_rev_overflow_rows(const int* adj, int cap, const int* of_u,
                                    const int* of_p, int E, const int* ut,
                                    int T, int new_w, int* base, int* ocand,
                                    void* stream) {
  const int grid = (T + NW - 1) / NW;
  rows_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      adj, cap, of_u, of_p, E, ut, T, new_w, base, ocand);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hs_rev_write_rows(int* adj, int* deg, int cap, const int* ut,
                                 int T, const int* osel, const int* ocnt,
                                 void* stream) {
  const int grid = (T + NW - 1) / NW;
  write_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      adj, deg, cap, ut, T, osel, ocnt);
  return static_cast<int>(cudaGetLastError());
}
