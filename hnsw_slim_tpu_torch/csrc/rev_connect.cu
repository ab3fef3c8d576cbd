// Kζ rev_connect: the reverse-connect steps of the fused insert apply, all
// but its two RNG prunes (those run on Kγ).
//
// Replaces (JAX): hnsw_slim_tpu/graph/revconn.py apply_insert steps 3-5 —
// the per-edge run rank (searchsorted over the target-sorted reverse-edge
// list), the fitting appends adj[u, deg[u] + rank] = p with the degree
// update, the overflow edges sorted by target and the first-of-run targets
// sorted again (two lax.sort programs), the candidate rows {row ∪ first
// new_w new edges} of the first of_t overflow targets, and the scatter of
// their re-pruned rows (mutuallyConnectNewElement, hnswalg.h:618-687,
// batched).
//
// What bounds it: launches and host work, not bytes. A batch reads its edge
// list (8 B an edge) and the degree of each edge's target and writes 4 B per
// appended edge; an overflow target reads its row and writes cap + new_w
// ints. A 4096-insert level-0 apply moves about 2 MB: under a microsecond at
// the card's memory rate, against several microseconds a launch.
//
// Design: the whole step between the forward prune and the overflow prune is
// one C entry point of two launches, and the write-back a third. The input
// is the edge list sorted by target (us ascending, ps the inserter of each
// edge, equal targets in inserter order; targets >= 2^30 are padding).
// Target u's edges form one run; the run's edge of rank r lands at column
// deg[u] + r, so it overflows exactly when r >= fit = cap - deg[u]: the
// overflow edges of u are the tail of its run. Hence no second sort: the
// JAX program's sort of the overflow edges by target is a stable partition
// of an already sorted list, and its sort of the first-of-run targets
// orders targets that already ascend.
//   A, append: one thread per edge finds the start of its target's run by
//      binary search, reads deg[u] and writes the edge at column
//      deg[u] + rank when that is below cap. The same launch fills the
//      outputs of B with their padding (every candidate row -1, every
//      target 2^30 and base id 0, coalesced 16-byte stores over the grid)
//      and zeroes B's tile ticket and look-back words.
//   B, settle: tiles of 1024 edges (256 threads x 4 consecutive edges),
//      the tile id from an atomic ticket so that a tile only waits on tiles
//      whose blocks already run. The first edge of each run (its leader)
//      reads deg[u] — nothing else reads it in B, so no write can race —,
//      finds the run's length by binary search (a run may span many
//      tiles: the leader's tile owns it), sets deg[u] = min(deg[u] + len,
//      cap) and counts its target and its len - fit overflow edges when
//      there are any. A block scan in edge order and a decoupled look-back
//      over the tiles' (targets, edges) counts (one 64-bit word a tile: a
//      2-bit status, 31 bits each) number the overflow targets in
//      ascending id order; target number t < T writes ut[t] = base[t] = u
//      and its candidate row: adj[u] after A's appends, then its first
//      new_w overflow edges read straight from ps at start + fit. The
//      block's warps write one row each at a time, from a list of the
//      tile's numbered targets in shared memory. The last tile writes the
//      two counters (overflow edges, overflow targets).
//   C, write: one warp per valid target writes the re-pruned row and count.
// Every output is an integer and equals the plain version's, which is the
// JAX program's composition (graph/revconn.py append_overflow_plain).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr int ITEMS = 4;                 // consecutive edges a thread of B
constexpr int TILE = THREADS * ITEMS;    // edges a tile of B
constexpr unsigned long long FLAG_A = 1ull << 62;  // the tile's own counts
constexpr unsigned long long FLAG_P = 2ull << 62;  // counts through the tile
constexpr unsigned long long COUNTS = FLAG_A - 1ull;
constexpr unsigned long long EDGES = (1ull << 31) - 1ull;  // low field

__global__ void __launch_bounds__(THREADS)
append_kernel(const int* __restrict__ us, const int* __restrict__ ps, int E,
              const int* __restrict__ deg, int* __restrict__ adj, int cap,
              int* __restrict__ ocand, long long fill, int* __restrict__ ut,
              int* __restrict__ base, int T,
              unsigned long long* __restrict__ status, int tiles,
              unsigned* __restrict__ ticket) {
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = g; i < E; i += stride) {
    const int e = (int)i;
    const int u = us[e];
    if (u < hs::BIG) {
      const int col = deg[u] + e - hs::lower_bound(us, e, u);
      if (col < cap) adj[(size_t)u * cap + col] = ps[e];
    }
  }
  // B's outputs start as padding; B overwrites the rows of real targets
  const long long f4 = fill >> 2;
  int4* o4 = reinterpret_cast<int4*>(ocand);
  for (long long i = g; i < f4; i += stride) o4[i] = make_int4(-1, -1, -1, -1);
  for (long long i = 4 * f4 + g; i < fill; i += stride) ocand[i] = -1;
  for (long long i = g; i < T; i += stride) {
    ut[i] = hs::BIG;
    base[i] = 0;
  }
  for (long long i = g; i < tiles; i += stride) status[i] = 0ull;
  if (g == 0) *ticket = 0u;
}

__device__ __forceinline__ unsigned long long ld_volatile(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void st_volatile(unsigned long long* p,
                                            unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

__global__ void __launch_bounds__(THREADS)
settle_kernel(const int* __restrict__ us, const int* __restrict__ ps, int E,
              int* __restrict__ deg, const int* __restrict__ adj, int cap,
              int T, int new_w, int* __restrict__ ut, int* __restrict__ base,
              int* __restrict__ ocand, unsigned long long* status,
              unsigned* ticket, int tiles, int* __restrict__ counters) {
  __shared__ int s_tile;
  __shared__ unsigned long long s_warp[NW];
  __shared__ unsigned long long s_excl;  // counts before this tile
  // the tile's numbered targets: (target, run start + fit, overflow edges)
  __shared__ int s_u[TILE], s_src[TILE], s_nov[TILE];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = (int)atomicAdd(ticket, 1u);
  __syncthreads();
  const int tile = s_tile;
  const int e0 = tile * TILE + threadIdx.x * ITEMS;

  // the leaders among this thread's edges: settle deg, count overflow
  int lu[ITEMS], lsrc[ITEMS], lnov[ITEMS];
  int n_t = 0;
  unsigned long long n_e = 0ull;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int e = e0 + j;
    lnov[j] = 0;
    if (e >= E) continue;
    const int u = us[e];
    if (u >= hs::BIG || (e > 0 && us[e - 1] == u)) continue;
    const int d0 = deg[u];
    const int len = hs::upper_bound(us + e, E - e, u);
    deg[u] = min(d0 + len, cap);
    const int fit = max(cap - d0, 0);
    if (len > fit) {
      lu[j] = u;
      lsrc[j] = e + fit;
      lnov[j] = len - fit;
      ++n_t;
      n_e += (unsigned long long)(len - fit);
    }
  }

  // exclusive scan of (targets << 31 | edges) over the block, edge order
  const unsigned long long mine = ((unsigned long long)n_t << 31) | n_e;
  unsigned long long x = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_up_sync(HS_FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[w] = x;
  __syncthreads();
  unsigned long long pre = 0ull, total = 0ull;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    if (i < w) pre += s_warp[i];
    total += s_warp[i];
  }
  pre += x - mine;

  // decoupled look-back over earlier tiles, one thread
  if (threadIdx.x == 0) {
    st_volatile(&status[tile], (tile ? FLAG_A : FLAG_P) | total);
    unsigned long long excl = 0ull;
    unsigned spins = 0u;
    for (int t = tile - 1; t >= 0;) {
      const unsigned long long v = ld_volatile(&status[t]);
      if ((v & ~COUNTS) == 0ull) {  // not published yet: read it again
        // an earlier tile's block already runs, so it publishes within
        // microseconds; fail the launch rather than hang if it never does
        if (++spins == (1u << 24)) __trap();
        continue;
      }
      excl += v & COUNTS;
      if (v & FLAG_P) break;
      --t;
    }
    if (tile) st_volatile(&status[tile], FLAG_P | (excl + total));
    if (tile == tiles - 1) {  // the counts through the last tile: all
      counters[0] = (int)((excl + total) & EDGES);
      counters[1] = (int)((excl + total) >> 31);
    }
    s_excl = excl;
  }
  __syncthreads();

  // number this thread's targets; list those below T for the warps
  const int t0 = (int)(s_excl >> 31);
  int rank = (int)(pre >> 31);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (lnov[j] == 0) continue;
    if (t0 + rank < T) {
      s_u[rank] = lu[j];
      s_src[rank] = lsrc[j];
      s_nov[rank] = lnov[j];
    }
    ++rank;
  }
  __syncthreads();
  const int listed = max(0, min((int)(total >> 31), T - t0));
  const int width = cap + new_w;
  for (int i = w; i < listed; i += NW) {
    const int u = s_u[i], src = s_src[i], take = min(s_nov[i], new_w);
    const int t = t0 + i;
    int* orow = ocand + (size_t)t * width;
    for (int j = lane; j < cap; j += 32) orow[j] = adj[(size_t)u * cap + j];
    for (int j = lane; j < new_w; j += 32)
      orow[cap + j] = j < take ? ps[src + j] : -1;
    if (lane == 0) {
      ut[t] = u;
      base[t] = u;
    }
  }
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

// A then B. us, ps: the target-sorted edge list, E edges; adj i32[N, cap],
// deg i32[N] (updated in place); T = min(of_t, E) target rows of new_w new
// edges each: ut i32[T], base i32[T], ocand i32[T, cap + new_w] (16-byte
// aligned); B's scratch: ticket u32, status u64[tiles] with
// tiles = max(1, ceil(E / 1024)); counters i32[2]: overflow edges, overflow
// targets.
extern "C" int hs_rev_apply(const int* us, const int* ps, int E, int* adj,
                            int* deg, int cap, int T, int new_w, int* ut,
                            int* base, int* ocand, unsigned* ticket,
                            unsigned long long* status, int tiles,
                            int* counters, void* stream) {
  if (E < 0 || T < 0 || T > E || new_w < 0 ||
      tiles != (E > 0 ? (E + TILE - 1) / TILE : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // A: a thread an edge, and at least a 16-byte store a thread of the fill
  const long long fill = (long long)T * (cap + new_w);
  long long blocks = ((long long)E + THREADS - 1) / THREADS;
  const long long fill_blocks = (fill / 4 + THREADS * 4 - 1) / (THREADS * 4);
  if (blocks < fill_blocks) blocks = fill_blocks;
  if (blocks < 1) blocks = 1;
  if (blocks > 65535) blocks = 65535;  // both loops stride over the grid
  append_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
      us, ps, E, deg, adj, cap, ocand, fill, ut, base, T, status, tiles,
      ticket);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  settle_kernel<<<tiles, THREADS, 0, s>>>(us, ps, E, deg, adj, cap, T, new_w,
                                          ut, base, ocand, status, ticket,
                                          tiles, counters);
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
