// K19 shard_merge: the S-way merge of per-shard top-k lists, one warp per
// query.
//
// Replaces (JAX): hnsw_slim_tpu/parallel/sharded.py _local_search's id map
// (local id -> global id through gids, +inf where the global id is < 0, so
// padded nodes never surface) and the merge of _sharded_search_jit (all
// shards' lists concatenated shard-major to [b, S*k], lax.sort by distance,
// the first k kept; hops and dcomp summed over shards, the psum); the host
// merge of parallel/flat_union.py search with seed_width 0 is the same
// function.
//
// What bounds it: nothing but the launch at serving shapes. The function
// reads 8 bytes per list entry plus one gid lookup, and writes 8 per output
// slot: about 2.5 MB at S = 4, B = 4096, k = 10, under a microsecond at
// 3.35 TB/s.
//
// Design: a shard's list comes sorted ascending (chal_search returns its
// beam buffer), and dropping its entries that become +inf (a -1 local id, a
// padded node, an infinite distance) leaves it sorted. So lane s holds the
// head of shard s's finite entries, and each output slot takes the smallest
// (distance, shard) head by a butterfly argmin, the winner lane advancing:
// ties go to the lower shard, and within a shard to the earlier entry, as a
// stable sort of the shard-major concatenation orders them. When every
// finite entry is out, the rest of the slots take the +inf entries in
// shard-major order (their global id, -1 for a padded or missing one), as
// the stable sort leaves them at the end. S <= 32. The inputs are read
// through strides, so a [B, S, k] layout (the union's replicated queries,
// query-major) needs no copy; the gid table is per shard (row s of
// gid[S, n_per], shard_stride = n_per) or one table for all (stride 0).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
shard_merge_kernel(const float* __restrict__ d, const int* __restrict__ ids,
                   long long s_stride, long long b_stride,
                   const int* __restrict__ gid, long long gid_stride,
                   const int* __restrict__ hops, const int* __restrict__ dcomp,
                   long long hs_stride, long long hb_stride, int S, int B,
                   int k, float* __restrict__ out_d, int* __restrict__ out_id,
                   int* __restrict__ out_hops, int* __restrict__ out_dcomp) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * NW + (threadIdx.x >> 5);
  if (b >= B) return;  // whole warp; no block barrier
  const bool mine = lane < S;
  const float* ld = d + lane * s_stride + b * b_stride;
  const int* li = ids + lane * s_stride + b * b_stride;
  const int* lg = gid + lane * gid_stride;
  float* od = out_d + (size_t)b * k;
  int* oi = out_id + (size_t)b * k;

  // global id of entry j of this lane's list, -1 for a missing one
  auto global = [&](int j) {
    const int l = li[j];
    return l >= 0 ? lg[l] : -1;
  };
  // first finite entry at or after j: (position, distance, global id)
  int pos = 0, hg = -1;
  float hd = HS_INF;
  auto seek = [&](int j) {
    for (; j < k; ++j) {
      const float v = ld[j];
      const int g = global(j);
      if (g >= 0 && v < HS_INF) {
        pos = j; hd = v; hg = g;
        return;
      }
    }
    pos = k; hd = HS_INF; hg = -1;
  };
  if (mine) seek(0);

  int t = 0;
  for (; t < k; ++t) {
    float bd = mine ? hd : HS_INF;
    int bs = mine && pos < k ? lane : hs::BIG;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float od_ = __shfl_xor_sync(HS_FULL, bd, o);
      const int os = __shfl_xor_sync(HS_FULL, bs, o);
      if (od_ < bd || (od_ == bd && os < bs)) { bd = od_; bs = os; }
    }
    if (bs == hs::BIG) break;  // every finite entry is out
    if (lane == bs) {
      od[t] = hd;
      oi[t] = hg;
      seek(pos + 1);
    }
  }
  // the +inf entries in shard-major order fill the rest
  for (int f0 = 0; f0 < S * k && t < k; f0 += 32) {
    const int f = f0 + lane;
    int g = -1;
    bool fill = false;
    if (f < S * k) {
      const int s = f / k, j = f - s * k;
      const int l = ids[s * s_stride + b * b_stride + j];
      g = l >= 0 ? gid[s * gid_stride + l] : -1;
      fill = !(g >= 0 && d[s * s_stride + b * b_stride + j] < HS_INF);
    }
    const unsigned m = __ballot_sync(HS_FULL, fill);
    const int r = t + __popc(m & ((1u << lane) - 1u));
    if (fill && r < k) {
      od[r] = HS_INF;
      oi[r] = g;
    }
    t += __popc(m);
  }
  // hops and dcomp summed over shards
  int h = mine ? hops[lane * hs_stride + b * hb_stride] : 0;
  int c = mine ? dcomp[lane * hs_stride + b * hb_stride] : 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    h += __shfl_xor_sync(HS_FULL, h, o);
    c += __shfl_xor_sync(HS_FULL, c, o);
  }
  if (lane == 0) {
    out_hops[b] = h;
    out_dcomp[b] = c;
  }
}

}  // namespace

// d f32 / ids i32 with entry (s, b, j) at s * s_stride + b * b_stride + j;
// gid i32, shard s's table at s * gid_stride; hops / dcomp i32 with entry
// (s, b) at s * hs_stride + b * hb_stride; outputs d f32[B, k], ids
// i32[B, k], hops i32[B], dcomp i32[B]
extern "C" int hs_shard_merge(const float* d, const int* ids,
                              long long s_stride, long long b_stride,
                              const int* gid, long long gid_stride,
                              const int* hops, const int* dcomp,
                              long long hs_stride, long long hb_stride, int S,
                              int B, int k, float* out_d, int* out_id,
                              int* out_hops, int* out_dcomp, void* stream) {
  if (S < 1 || S > 32 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  shard_merge_kernel<<<(B + NW - 1) / NW, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      d, ids, s_stride, b_stride, gid, gid_stride, hops, dcomp, hs_stride,
      hb_stride, S, B, k, out_d, out_id, out_hops, out_dcomp);
  return static_cast<int>(cudaGetLastError());
}
