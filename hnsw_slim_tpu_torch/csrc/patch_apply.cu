// Kπ patch_apply: a decoded patch chunk applied to the flat CHAL arrays on
// the card (persist/patch.py apply_patch_device, the client's sync_patches).
//
// Replaces no TPU kernel: the JAX package applies a patch on the host
// (hnsw_slim_tpu/persist/patch.py apply_patch: the graph pulled to numpy,
// every level-0 row sorted, dense [n, width] rows per level, the records
// written in a Python loop, pack_chal_arrays). The port did the same, and
// at 1M nodes that host pass took seconds per chunk. Here the new arrays
// are one streaming pass over the old ones.
//
// What bounds it: bytes. Each node's old offsets and ids are read twice
// (once to count, once to copy) and its new offsets and ids written once;
// a patched node reads its shipped record instead. At 1M nodes that is
// about 2 x (28 + 34) + 62 MB: ~0.06 ms at the card's memory rate. The sort
// of each untouched segment (the host path writes them ascending) costs
// shuffles, not bytes.
//
// Design: three launches.
//   map: one thread a record; rec_of[id] = the largest record index that
//      names it (atomicMax: the last record wins, as the host path's dict,
//      whatever order the threads run in). The entry point also zeroes the
//      scan's tile ticket and look-back words.
//   scan: tiles of 1024 nodes (256 threads x 4 consecutive nodes), the tile
//      id from an atomic ticket. A thread sets each node's new level (the
//      record's, else the old one, else 0 past the old count) and counts
//      its new ids: a patched node's shipped ids >= 0, an untouched node's
//      old ids that are >= 0 and not INT_MAX among the first `width` of each
//      level it holds (the host path's _rows_for keeps those). A block scan
//      and a decoupled look-back over the tiles' (nodes with level >= 0,
//      ids) counts give each node's first offset; the last tile writes both
//      totals. The host reads them back once, to size nbr.
//   copy: one warp a node writes its offsets level by level and its ids:
//      a patched node's shipped rows as shipped (negative ids dropped, as
//      pack_chal_arrays drops them); an untouched node's old segments
//      ascending: a segment of up to 32 ids is sorted in registers (a
//      bitonic network over the lanes' shuffles), a longer one in the
//      warp's slice of shared memory. The grid also fills nbr past the
//      total with -1 up to its padded length.
// Every output is an integer and equals the host path's (the plain version
// is persist/patch.py repack_plain).
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr int ITEMS = 4;               // consecutive nodes a thread of scan
constexpr int TILE = THREADS * ITEMS;  // nodes a tile of scan
constexpr unsigned long long FLAG_A = 1ull << 62;  // the tile's own counts
constexpr unsigned long long FLAG_P = 2ull << 62;  // counts through the tile
constexpr unsigned long long COUNTS = FLAG_A - 1ull;
constexpr unsigned long long IDS = (1ull << 31) - 1ull;  // low field
constexpr int NONE = INT_MAX;  // an empty slot of a sorted segment

struct Records {   // the staged chunk (rs columns of rel)
  const int* lv;     // i32[R] level of each record
  const int* rel;    // i32[R, rs] end of each level's ids, from the start
  int rs;
  const int* start;  // i32[R + 1] first id of each record in nbr
  const int* nbr;    // i32[T] the records' ids, concatenated
};

struct Old {       // the graph before the chunk
  const int* nbr;
  const int* off;    // i32[N_pad, stride]
  int stride;
  const int* level;  // i32[N_pad]
  int prev;          // logical node count
  int max_level;
  int width;         // max(cap0, cap): ids a level row holds
};

__global__ void __launch_bounds__(THREADS)
map_kernel(const int* __restrict__ ids, int R, int* __restrict__ rec_of) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r < R) atomicMax(&rec_of[ids[r]], r);
}

__device__ __forceinline__ bool kept(int x) { return x >= 0 && x != NONE; }

// node v's new level and its count of new ids
__device__ __forceinline__ int node_count(int v, const int* rec_of,
                                          const Records& rc, const Old& o,
                                          int& level) {
  int c = 0;
  const int r = rec_of[v];
  if (r >= 0) {
    const int lv = rc.lv[r];
    const int* rel = rc.rel + (size_t)r * rc.rs;
    const int* ids = rc.nbr + rc.start[r];
    int s = 0;
    for (int l = 0; l <= lv; ++l) {
      const int e = rel[l];
      for (int j = s; j < e; ++j) c += ids[j] >= 0;
      s = e;
    }
    level = lv;
  } else if (v < o.prev) {
    const int lv = o.level[v];
    const int top = min(lv, o.max_level);
    const int* off = o.off + (size_t)v * o.stride;
    for (int l = 0; l <= top; ++l) {
      const int a = off[l];
      const int m = min(off[l + 1] - a, o.width);
      for (int j = 0; j < m; ++j) c += kept(o.nbr[a + j]);
    }
    level = lv;
  } else {
    level = 0;
  }
  return c;
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
scan_kernel(const int* __restrict__ rec_of, Records rc, Old o, int n_total,
            int* __restrict__ level_new, int* __restrict__ off_new,
            int new_stride, unsigned long long* status, int tiles,
            int* __restrict__ counters) {
  __shared__ int s_tile;
  __shared__ unsigned long long s_warp[NW];
  __shared__ unsigned long long s_excl;  // counts before this tile
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  unsigned* ticket = reinterpret_cast<unsigned*>(status + tiles);
  if (threadIdx.x == 0) s_tile = (int)atomicAdd(ticket, 1u);
  __syncthreads();
  const int tile = s_tile;
  const int v0 = tile * TILE + threadIdx.x * ITEMS;

  int cnt[ITEMS];
  unsigned long long n_real = 0ull, n_ids = 0ull;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int v = v0 + j;
    cnt[j] = 0;
    if (v >= n_total) continue;
    int lv;
    cnt[j] = node_count(v, rec_of, rc, o, lv);
    level_new[v] = lv;
    n_real += lv >= 0;
    n_ids += (unsigned long long)cnt[j];
  }

  // exclusive scan of (nodes << 31 | ids) over the block, node order
  const unsigned long long mine = (n_real << 31) | n_ids;
  unsigned long long x = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long y = __shfl_up_sync(HS_FULL, x, d);
    if (lane >= d) x += y;
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
      counters[0] = (int)((excl + total) & IDS);
      counters[1] = (int)((excl + total) >> 31);
    }
    s_excl = excl;
  }
  __syncthreads();

  int at = (int)((s_excl + pre) & IDS);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int v = v0 + j;
    if (v >= n_total) break;
    off_new[(size_t)v * new_stride] = at;
    at += cnt[j];
  }
}

// ascending bitonic sort of one value a lane across the warp
__device__ __forceinline__ int warp_sort32(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int y = __shfl_xor_sync(HS_FULL, x, j);
      const bool up = (lane & k) == 0, lower = (lane & j) == 0;
      x = lower == up ? min(x, y) : max(x, y);
    }
  }
  return x;
}

// ascending bitonic sort of buf[0, p) (p a power of two > 32) by one warp
__device__ __forceinline__ void warp_sort_smem(int* buf, int p) {
  const int lane = threadIdx.x & 31;
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = lane; i < p; i += 32) {
        const int q = i ^ j;
        if (q > i) {
          const int a = buf[i], b = buf[q];
          if ((a > b) == ((i & k) == 0)) {
            buf[i] = b;
            buf[q] = a;
          }
        }
      }
      __syncwarp();
    }
  }
}

// an untouched node's old segment old[0, m) ascending into out, without
// its negative and INT_MAX ids; returns how many it wrote
__device__ __forceinline__ int copy_sorted(const int* old, int m, int* out,
                                           int* buf) {
  const int lane = threadIdx.x & 31;
  if (m <= 32) {
    int x = lane < m ? old[lane] : NONE;
    x = warp_sort32(kept(x) ? x : NONE);
    const int c = __popc(__ballot_sync(HS_FULL, x != NONE));
    if (lane < c) out[lane] = x;
    return c;
  }
  const int p = hs::next_pow2(m);
  for (int i = lane; i < p; i += 32) {
    const int x = i < m ? old[i] : NONE;
    buf[i] = kept(x) ? x : NONE;
  }
  __syncwarp();
  warp_sort_smem(buf, p);
  int c = 0;
  for (int i = lane; i < p; i += 32) {  // the kept ids come first
    const int x = buf[i];
    if (x != NONE) out[i] = x;
    c += __popc(__ballot_sync(HS_FULL, x != NONE));
  }
  __syncwarp();  // buf is read before the next segment refills it
  return c;
}

// a patched node's shipped level ids[s, e) in order into out, without its
// negative ids; returns how many it wrote
__device__ __forceinline__ int copy_shipped(const int* ids, int s, int e,
                                            int* out) {
  const int lane = threadIdx.x & 31;
  int c = 0;
  for (int j0 = s; j0 < e; j0 += 32) {
    const int j = j0 + lane;
    const int x = j < e ? ids[j] : -1;
    const unsigned bal = __ballot_sync(HS_FULL, x >= 0);
    if (x >= 0) out[c + __popc(bal & ((1u << lane) - 1u))] = x;
    c += __popc(bal);
  }
  return c;
}

__global__ void __launch_bounds__(THREADS)
copy_kernel(const int* __restrict__ rec_of, Records rc, Old o, int n_total,
            const int* __restrict__ level_new, int* __restrict__ off_new,
            int new_stride, int lmax_new, int* __restrict__ nbr_new,
            long long total, long long e_pad, int smem_row) {
  extern __shared__ int s_buf[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = total + g; i < e_pad; i += stride) nbr_new[i] = -1;

  const int v = blockIdx.x * NW + w;
  if (v >= n_total) return;
  int* off = off_new + (size_t)v * new_stride;
  int pos = off[0];
  const int r = rec_of[v];
  if (r >= 0) {
    const int lv = rc.lv[r];
    const int* rel = rc.rel + (size_t)r * rc.rs;
    const int* ids = rc.nbr + rc.start[r];
    int s = 0;
    for (int l = 0; l <= lmax_new; ++l) {
      if (l <= lv) {
        const int e = rel[l];
        pos += copy_shipped(ids, s, e, nbr_new + pos);
        s = e;
      }
      if (lane == 0) off[l + 1] = pos;
    }
  } else {
    const int top = v < o.prev ? min(level_new[v], o.max_level) : -1;
    const int* old_off = o.off + (size_t)v * o.stride;
    int* buf = s_buf + w * smem_row;
    for (int l = 0; l <= lmax_new; ++l) {
      if (l <= top) {
        const int a = old_off[l];
        const int m = max(0, min(old_off[l + 1] - a, o.width));
        pos += copy_sorted(o.nbr + a, m, nbr_new + pos, buf);
      }
      if (lane == 0) off[l + 1] = pos;
    }
  }
}

}  // namespace

// map: rec_of i32[n_total] set to -1, then to each node's last record;
// status u64[tiles + 1] (the scan's look-back words, then its ticket)
// zeroed, tiles = max(1, ceil(n_total / 1024)).
extern "C" int hs_patch_map(const int* ids, int R, int* rec_of, int n_total,
                            unsigned long long* status, int tiles,
                            void* stream) {
  if (R < 0 || n_total < 0 ||
      tiles != (n_total > 0 ? (n_total + TILE - 1) / TILE : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      status, 0, sizeof(unsigned long long) * (tiles + 1), s);
  if (err == cudaSuccess && n_total > 0)
    err = cudaMemsetAsync(rec_of, 0xff, sizeof(int) * n_total, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R > 0)
    map_kernel<<<(R + THREADS - 1) / THREADS, THREADS, 0, s>>>(ids, R,
                                                               rec_of);
  return static_cast<int>(cudaGetLastError());
}

// scan: level_new i32[n_total], off_new[:, 0] of i32[n_total, new_stride],
// counters i32[2]: the new ids' total, the nodes with level >= 0.
extern "C" int hs_patch_scan(const int* rec_of, const int* rec_lv,
                             const int* rec_rel, int rs, const int* rec_start,
                             const int* rec_nbr, const int* old_nbr,
                             const int* old_off, int old_stride,
                             const int* old_level, int prev, int old_max,
                             int width, int n_total, int* level_new,
                             int* off_new, int new_stride,
                             unsigned long long* status, int tiles,
                             int* counters, void* stream) {
  if (n_total < 0 || prev < 0 || width < 1 ||
      tiles != (n_total > 0 ? (n_total + TILE - 1) / TILE : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Records rc{rec_lv, rec_rel, rs, rec_start, rec_nbr};
  const Old o{old_nbr, old_off, old_stride, old_level, prev, old_max, width};
  scan_kernel<<<tiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      rec_of, rc, o, n_total, level_new, off_new, new_stride, status, tiles,
      counters);
  return static_cast<int>(cudaGetLastError());
}

// copy: off_new[:, 1:] and nbr_new i32[e_pad] (ids, then -1 from total on).
// width <= 1024: a longer segment than 32 ids sorts in shared memory.
extern "C" int hs_patch_copy(const int* rec_of, const int* rec_lv,
                             const int* rec_rel, int rs, const int* rec_start,
                             const int* rec_nbr, const int* old_nbr,
                             const int* old_off, int old_stride,
                             const int* old_level, int prev, int old_max,
                             int width, int n_total, const int* level_new,
                             int* off_new, int new_stride, int lmax_new,
                             int* nbr_new, long long total, long long e_pad,
                             void* stream) {
  if (n_total < 0 || width < 1 || width > 1024 || total > e_pad)
    return static_cast<int>(cudaErrorInvalidValue);
  const Records rc{rec_lv, rec_rel, rs, rec_start, rec_nbr};
  const Old o{old_nbr, old_off, old_stride, old_level, prev, old_max, width};
  const int smem_row = width > 32 ? hs::next_pow2(width) : 0;
  long long blocks = ((long long)n_total + NW - 1) / NW;
  if (blocks < 1) blocks = 1;
  copy_kernel<<<(unsigned)blocks, THREADS, sizeof(int) * NW * smem_row,
                static_cast<cudaStream_t>(stream)>>>(
      rec_of, rc, o, n_total, level_new, off_new, new_stride, lmax_new,
      nbr_new, total, e_pad, smem_row);
  return static_cast<int>(cudaGetLastError());
}
