// Kα topk_dist: fused distance + running top-k, no [B, N] matrix in memory.
//
// Replaces (JAX): hnsw_slim_tpu/index/bruteforce.py _bf_topk / exact_topk
// (chunked distance matmul + running lax.top_k), the exact seed block of
// graph/search.py chal_search (top-S over all level>=1 vectors) and
// graph/build.py _exact_knn_subset (self-masked subset kNN).
//
// What bounds it: B*N*D fp32 FMAs (true fp32, no TF32: the JAX code runs
// these at Precision.HIGHEST) — 1.07e12 FMA-flops for 4096 queries over
// 1M x 128 — and, at small B, streaming x (512 MB at 1M x 128) through L2;
// for the KMeans shape (262144 queries over 16 centroids) the 134 MB of
// queries.
//
// Design: an SGEMM-class scan. A block owns a tile of BQ queries and a
// contiguous range of rows (grid.y splits N so that small query batches
// still fill every SM). The query tile stays resident in shared memory for
// the whole range, stored dimension-major (zero padded to a multiple of 32
// dims), so it is read from device memory once. Rows too wide for any
// resident tile take U, which stages its query tile in chunks of Dq dims
// (the most whole slabs the plan's shared bytes hold), each reloaded when
// a row tile's slabs reach it, so any width runs; the other tiles are
// compiled without that reload, which slowed them by 0.7-2.7% on an H100
// (scripts/scan_descent_ab.py). Rows stream in tiles of BN,
// one 32-dim slab at a time through two shared-memory buffers: the next
// slab's loads are in registers while this one is multiplied, then stored
// transposed (dimension-major, no bank conflict) behind one barrier. Each of
// the 256 threads holds a TQ x TN register micro-tile (8 x 8 for large
// batches) and reads its operands as 16-byte shared loads, queries strided
// so that a quarter-warp reads one broadcast word and rows so that it reads
// 128 contiguous bytes. Four tile shapes (index/bruteforce.py scan_plan
// picks one, with the splits and the shared bytes): L 128 x 128 (8 x 8, one
// block an SM) and M 64 x 128 (4 x 8, two blocks an SM, so one block's fold
// overlaps the other's FMAs: the larger k), U 16 x 128 (1 x 8) for batches
// of at most 64 queries and for rows too wide for the others, T 64 x 32
// (4 x 2) for tables of at most 32 rows (KMeans' centroids).
//
// Every (query, row) accumulator is one fmaf chain over d = 0 .. Dp-1 in
// order, starting at 0 (the padding adds fmaf(0, 0, acc)), held in
// registers across query chunks, and the epilogues are the expressions of
// the 32 x 64-tile scan this replaced, so each distance is bit-equal to it;
// a tile shape changes which thread owns a chain, never the chain. The epilogue writes the BQ x BN distance tile to
// shared memory (over the slab buffers, idle then) and, in registers, tests
// each distance against its query's threshold: the k-th entry of the
// query's top-k list (k <= 128 in 32, 64 or 128 slots, ordered by
// (distance, row), in shared memory), flagging the queries with a row that
// passes. After the first tiles almost nothing passes, and a warp folds
// only its flagged queries: the list goes into registers (2 entries a lane,
// 4 for a list of 128) and takes a 32-row chunk's
// passing rows one at a time (ballot for the position, shuffle-up to
// shift), in one bitonic merge when the chunk brings four or more (k <=
// 32), or by a warp argmin when k = 1. The lists keep the k smallest by
// (distance, row) whatever order the rows come in, so the results equal the
// old scan's. With splits > 1 the splits of a query share a threshold: a
// split whose list is full publishes its k-th entry (atomicMin of a u64 key
// ordered as (distance, row)), and every split takes the best published one
// when it is ahead of its own — a row behind it is behind k rows of another
// split, so out of the query's top k — and the merged result is unchanged
// while the inserts stay near those of one list over all rows. A second
// kernel merges the per-split lists, one warp per query.
//
// Strata mode (chal_search's stratified seeds, seed_strata > 1): the table is
// cut into `strata` equal segments; the scan runs with one split per segment
// and k = seeds per segment, and a second kernel sorts each query's
// strata * k picks by (distance, segment-major position) — JAX's stable sort
// of the per-segment argmin picks — and maps rows to ids (inf gives -1).
//
// Estimate mode (EST; the seed block of the SlimQ search, JAX
// index/slimq.py _slimq_search_jit: the 1-bit RaBitQ estimate to every
// level>=1 node as two matmuls over unpacked bit planes and a cluster
// one-hot, then lax.top_k): the table is the nodes' packed code rows
// (common.cuh Quant). A 32-dim slab of a row is one u32 word, unpacked to
// {0, 1} as the slab enters shared memory, so the same micro-tiles
// accumulate <q_rot, bits>; the epilogue forms f_add + g_add[query,
// cluster] + f_rescale * (<q_rot, bits> - sumq / 2) from the row's own
// factors — always the 1-bit pair — with the tile's g_add rows in shared
// memory. Neither the unpacked planes nor the [B, rows] estimates reach
// device memory.
//
// bfloat16 rows (hs_topk_dist_bf16, hs_topk_strata_bf16: a bf16 store, or
// the seed table gathered from one, as the JAX union's seed table is): the
// slab is loaded from bf16 (8 bytes a thread) and widened to fp32 as it
// enters shared memory, so the micro-tiles, norms and lists are as above
// and the scan streams half the bytes.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BK = 32, THREADS = 256, NWARP = THREADS / 32;
constexpr int MERGE_AT = 4;  // candidates of a chunk that take the merge
constexpr int SMEM_MAX = 232448;  // dynamic shared bytes a block may take
constexpr int MAX_K = 128;  // the longest top-k list

// slots of a query's top-k list in shared memory: 32, 64 or 128
__host__ __device__ constexpr int list_slots(int k) {
  return k <= 32 ? 32 : k <= 64 ? 64 : 128;
}

template <int BQ_, int BN_, int TQ_, int TN_, int MINB_, bool CHUNK_ = false>
struct Tile {
  static constexpr int BQ = BQ_, BN = BN_, TQ = TQ_, TN = TN_;
  static constexpr int MINB = MINB_;  // blocks an SM the registers allow
  static constexpr bool CHUNK = CHUNK_;  // the query tile may be chunked
  static constexpr int TY = BQ / TQ, TX = BN / TN;
  // takes 128-slot lists (k > 64): M and U; the plan gives L only k <= 16
  // and T only k <= 64, so their folds are compiled for 32 and 64 alone
  static constexpr bool K128 = BQ <= 64 && BN == 128;
  static constexpr int WX = TX < 8 ? TX : 8;  // lanes of a warp along rows
  static constexpr int WXN = TX / WX;         // warps along rows
  // the slab buffers and, over them, the distance tile
  static constexpr int U0 = 2 * BK * BN > BQ * (BN + 1) ? 2 * BK * BN
                                                         : BQ * (BN + 1);
  static constexpr int U = (U0 + 3) / 4 * 4;
  static_assert(TY * TX == THREADS, "a tile is 256 threads");
  static_assert((TY / (32 / WX)) * WXN == NWARP, "warp shape");
  static_assert(BN >= 32 && BN * (BK / 4) % THREADS == 0, "slab chunks");
};
using TileL = Tile<128, 128, 8, 8, 1>;
using TileM = Tile<64, 128, 4, 8, 2>;
using TileU = Tile<16, 128, 1, 8, 2, true>;
using TileT = Tile<64, 32, 4, 2, 3>;

// shared bytes of a tile: the query tile (Dq dims), the slab buffers / the
// distance tile, the lists (KL slots a query), the thresholds and pass
// flags, and in estimate mode the tile's g_add rows (C floats a query)
template <class TL>
constexpr size_t scan_smem(int Dq, int KL, int C) {
  return sizeof(float) * ((size_t)Dq * TL::BQ + TL::U + 2 * TL::BQ * KL +
                          3 * TL::BQ + (size_t)TL::BQ * C);
}

// element i of the T a thread owns along an extent E: groups of four
// consecutive, strided by E / (T / 4), or T consecutive when T < 4
template <int T, int E>
__device__ __forceinline__ int fidx(int t, int i) {
  if constexpr (T >= 4)
    return (i >> 2) * (E / (T / 4)) + t * 4 + (i & 3);
  else
    return t * T + i;
}

template <int T, int E>
__device__ __forceinline__ void frag(const float* row, int t, float (&v)[T]) {
  if constexpr (T >= 4) {
#pragma unroll
    for (int g = 0; g < T / 4; ++g) {
      const float4 f =
          *reinterpret_cast<const float4*>(row + g * (E / (T / 4)) + t * 4);
      v[4 * g] = f.x;
      v[4 * g + 1] = f.y;
      v[4 * g + 2] = f.z;
      v[4 * g + 3] = f.w;
    }
  } else if constexpr (T == 2) {
    const float2 f = *reinterpret_cast<const float2*>(row + t * 2);
    v[0] = f.x;
    v[1] = f.y;
  } else {
    v[0] = row[t];
  }
}

// four dims d..d+3 of a row of D elements as fp32, zero past D
template <class T>
__device__ __forceinline__ float4 load_dims(const T* p, int d, int D,
                                            bool vec4) {
  if (vec4) return d < D ? hs::load4(p + d) : make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(d < D ? hs::load1(p + d) : 0.f,
                     d + 1 < D ? hs::load1(p + d + 1) : 0.f,
                     d + 2 < D ? hs::load1(p + d + 2) : 0.f,
                     d + 3 < D ? hs::load1(p + d + 3) : 0.f);
}

// insert (cd, ci) into a lane-distributed sorted list of NS slots a lane
// (slot s of lane l is entry s*32 + l); entries past k are don't-care
template <int NS>
__device__ __forceinline__ void list_insert(float (&ld)[NS], int (&li)[NS],
                                            float cd, int ci, int lane) {
  int p = 0;
#pragma unroll
  for (int s = 0; s < NS; ++s)
    p += __popc(__ballot_sync(HS_FULL, hs::pair_less(ld[s], li[s], cd, ci)));
  float ud[NS], ed[NS];
  int ui[NS], ei[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    ud[s] = __shfl_up_sync(HS_FULL, ld[s], 1);
    ui[s] = __shfl_up_sync(HS_FULL, li[s], 1);
    ed[s] = __shfl_sync(HS_FULL, ld[s], 31);  // the slot's last entry
    ei[s] = __shfl_sync(HS_FULL, li[s], 31);
  }
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int at = s * 32 + lane;
    if (at == p) {
      ld[s] = cd;
      li[s] = ci;
    } else if (at > p) {  // shift by one: lane 0 takes the slot before's last
      ld[s] = s == 0 || lane ? ud[s] : ed[s > 0 ? s - 1 : 0];
      li[s] = s == 0 || lane ? ui[s] : ei[s > 0 ? s - 1 : 0];
    }
  }
}

template <int NS>
__device__ __forceinline__ void list_kth(const float (&ld)[NS],
                                         const int (&li)[NS], int k, float& td,
                                         int& ti) {
  const int s = (k - 1) >> 5, l = (k - 1) & 31;
  float vd = ld[0];
  int vi = li[0];
#pragma unroll
  for (int j = 1; j < NS; ++j)
    if (s == j) {
      vd = ld[j];
      vi = li[j];
    }
  td = __shfl_sync(HS_FULL, vd, l);
  ti = __shfl_sync(HS_FULL, vi, l);
}

// offer one candidate per lane (in lane order) to the list
template <int NS>
__device__ __forceinline__ void list_offer(float (&ld)[NS], int (&li)[NS],
                                           float cd, int ci, int k, int lane) {
  float td;
  int ti;
  list_kth(ld, li, k, td, ti);
  unsigned m = __ballot_sync(HS_FULL, hs::pair_less(cd, ci, td, ti));
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const float vd = __shfl_sync(HS_FULL, cd, src);
    const int vi = __shfl_sync(HS_FULL, ci, src);
    if (hs::pair_less(vd, vi, td, ti)) {
      list_insert(ld, li, vd, vi, lane);
      list_kth(ld, li, k, td, ti);
    }
  }
}

// (distance, row) as one u64 whose unsigned order is pair_less's: the
// distance's bits made order-preserving (-0 taken as +0), then the row
__device__ __forceinline__ unsigned long long pair_key(float d, int row) {
  unsigned u = __float_as_uint(d + 0.f);
  u ^= (u >> 31) ? 0xffffffffu : 0x80000000u;
  return (static_cast<unsigned long long>(u) << 32) | static_cast<unsigned>(row);
}
__device__ __forceinline__ void pair_of_key(unsigned long long key, float& d,
                                            int& row) {
  const unsigned u = static_cast<unsigned>(key >> 32);
  d = __uint_as_float((u >> 31) ? u ^ 0x80000000u : ~u);
  row = static_cast<int>(static_cast<unsigned>(key));
}

// Offer one candidate per lane to a list of at most 32 (slot 0; k <= 32)
// in one merge: the candidates are sorted across the warp (bitonic, in
// registers), reversed, and each list entry keeps the smaller of itself and
// its partner, which leaves the 32 smallest of both as a bitonic sequence;
// five more steps sort it. Same list as offering them one at a time, at a
// fixed cost: it pays once a chunk brings several candidates.
__device__ __forceinline__ void list_merge32(float (&ld)[2], int (&li)[2],
                                             float cd, int ci, int lane) {
#pragma unroll
  for (int kk = 2; kk <= 32; kk <<= 1)
#pragma unroll
    for (int j = kk >> 1; j > 0; j >>= 1) hs::shfl_cas(cd, ci, lane, kk, j);
  const float rd = __shfl_sync(HS_FULL, cd, 31 - lane);
  const int ri = __shfl_sync(HS_FULL, ci, 31 - lane);
  if (hs::pair_less(rd, ri, ld[0], li[0])) {
    ld[0] = rd;
    li[0] = ri;
  }
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) hs::shfl_cas(ld[0], li[0], lane, 32, j);
  ld[1] = HS_INF;  // past k: emptied, so the list stays sorted for
  li[1] = -1;      // list_insert's position count
}

template <class TL, bool EST, class T>
__global__ void __launch_bounds__(THREADS, TL::MINB)
scan_kernel(const float* __restrict__ q, const float* __restrict__ qn,
            const T* __restrict__ x, const float* __restrict__ xn,
            const hs::Quant z, const int* __restrict__ row_ids, int B, int N,
            int D, int Dp, int Dq, int n_valid, int self_offset, int k,
            int metric, int rows_per_split,
            unsigned long long* __restrict__ gkth,
            float* __restrict__ out_d, int* __restrict__ out_i) {
  constexpr int BQ = TL::BQ, BN = TL::BN, TQ = TL::TQ, TN = TL::TN;
  constexpr int NCH = BN * (BK / 4) / THREADS;  // slab chunks a thread
  extern __shared__ __align__(16) float smem[];
  const int KL = list_slots(k);
  const int C = EST ? z.C : 0;
  float* Qs = smem;                       // [Dq][BQ]
  float* Us = Qs + (size_t)Dq * BQ;       // slabs [2][BK][BN] | dt [BQ][BN+1]
  float* Ld = Us + TL::U;                 // lists [BQ][KL]
  int* Li = reinterpret_cast<int*>(Ld + BQ * KL);
  float* Td = reinterpret_cast<float*>(Li + BQ * KL);  // thresholds [BQ]
  int* Ti = reinterpret_cast<int*>(Td + BQ);
  int* Fl = Ti + BQ;                       // a row passed the threshold
  float* Ga = reinterpret_cast<float*>(Fl + BQ);       // g_add [BQ][C]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = (lane % TL::WX) + TL::WX * (warp % TL::WXN);
  const int ty = (lane / TL::WX) + (32 / TL::WX) * (warp / TL::WXN);
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(N, r_begin + rows_per_split);

  // the query tile's dims d0 .. d0 + Dq - 1, dimension-major; lanes take
  // consecutive queries, eight 16-byte loads in flight a thread
  const float* qsrc = EST ? z.q_rot : q;
  const bool qvec4 = hs::can_vec4(qsrc, D);
  constexpr int QB = 8;
  auto q_load = [&](int d0) {
    const int ne = BQ * (min(Dq, Dp - d0) / 4);
    for (int e0 = 0; e0 < ne; e0 += QB * THREADS) {
      float4 v[QB];
#pragma unroll
      for (int u = 0; u < QB; ++u) {
        const int e = e0 + u * THREADS + tid;
        const int ql = e % BQ, d = d0 + (e / BQ) * 4, gq = q0 + ql;
        v[u] = (e < ne && gq < B)
                   ? load_dims(qsrc + (size_t)gq * D, d, D, qvec4)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < QB; ++u) {
        const int e = e0 + u * THREADS + tid;
        if (e >= ne) break;
        const int ql = e % BQ, d = (e / BQ) * 4;
        Qs[(d + 0) * BQ + ql] = v[u].x;
        Qs[(d + 1) * BQ + ql] = v[u].y;
        Qs[(d + 2) * BQ + ql] = v[u].z;
        Qs[(d + 3) * BQ + ql] = v[u].w;
      }
    }
  };
  q_load(0);
  for (int i = tid; i < BQ * KL; i += THREADS) {
    Ld[i] = HS_INF;
    Li[i] = -1;
  }
  for (int i = tid; i < BQ; i += THREADS) {
    Td[i] = HS_INF;
    Ti[i] = -1;
    Fl[i] = 0;
  }
  if (EST)
    for (int i = tid; i < BQ * C; i += THREADS) {
      const int gq = q0 + i / C;
      Ga[i] = gq < B ? z.g_add[(size_t)gq * C + i % C] : 0.f;
    }
  float qv[TQ];  // |q|^2 (exact, L2) or sum(q_rot) (estimate) per query
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int gq = q0 + fidx<TQ, BQ>(ty, i);
    qv[i] = gq >= B ? 0.f : EST ? z.sumq[gq] : metric ? 0.f : qn[gq];
  }

  // a slab: BN rows x BK dims as NCH chunks of four dims a thread (lanes on
  // consecutive rows), loaded into registers, stored dimension-major
  const bool xvec4 = !EST && hs::can_vec4(x, D);
  float4 st[NCH];
  auto slab_load = [&](int r0, int k0) {
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int e = c * THREADS + tid, r = e % BN, d = k0 + (e / BN) * 4;
      const int gr = r0 + r;
      if (gr >= r_end) {
        st[c] = make_float4(0.f, 0.f, 0.f, 0.f);
      } else if constexpr (EST) {  // the slab is word k0 / 32 of the 1-bit plane
        const uint32_t w =
            __ldg(z.rows + (size_t)gr * z.stride + k0 / BK) >> (d - k0);
        st[c] = make_float4(static_cast<float>(w & 1u),
                            static_cast<float>((w >> 1) & 1u),
                            static_cast<float>((w >> 2) & 1u),
                            static_cast<float>((w >> 3) & 1u));
      } else {
        st[c] = load_dims(x + (size_t)gr * D, d, D, xvec4);
      }
    }
  };
  auto slab_store = [&](float* xs) {
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int e = c * THREADS + tid, r = e % BN, d = (e / BN) * 4;
      xs[(d + 0) * BN + r] = st[c].x;
      xs[(d + 1) * BN + r] = st[c].y;
      xs[(d + 2) * BN + r] = st[c].z;
      xs[(d + 3) * BN + r] = st[c].w;
    }
  };

  const int nslab = Dp / BK;  // slabs of a row and of the query tile
  const int qslab = TL::CHUNK ? Dq / BK : nslab;
  constexpr int NQW = BQ / NWARP;  // queries a warp folds: warp + NWARP * m
  if (r_begin < r_end) {
    slab_load(r_begin, 0);
    slab_store(Us);
  }
  __syncthreads();
  for (int r0 = r_begin; r0 < r_end; r0 += BN) {
    // the thresholds other splits published for this warp's queries (lane
    // m: query warp + NWARP * m), in flight during the tile
    unsigned long long gk = ~0ull;
    if (gkth != nullptr && lane < NQW && q0 + warp + NWARP * lane < B)
      gk = __ldcg(gkth + q0 + warp + NWARP * lane);
    float acc[TQ][TN];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    // the query tile's chunks (one when it is resident): a chunk is loaded
    // once every thread is past the last slab of the one before (the
    // barrier after that slab's store, or after the previous row tile's
    // fold)
    for (int c0 = 0; c0 < nslab; c0 += qslab) {
      if constexpr (TL::CHUNK) {
        if (c0 > 0 || (qslab < nslab && r0 > r_begin)) {
          q_load(c0 * BK);
          __syncthreads();
        }
      }
      const int c1 = min(nslab, c0 + qslab);
      for (int s = c0; s < c1; ++s) {
        const float* xs = Us + (s & 1) * BK * BN;
        const float* qs = Qs + (s - c0) * BK * BQ;
        const bool more = s + 1 < nslab;
        // the next slab (of this tile, or the first of the next) in flight
        if (more) slab_load(r0, (s + 1) * BK);
        else if (r0 + BN < r_end) slab_load(r0 + BN, 0);
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk) {
          float a[TQ], b[TN];
          frag<TQ, BQ>(qs + kk * BQ, ty, a);
          frag<TN, BN>(xs + kk * BN, tx, b);
#pragma unroll
          for (int i = 0; i < TQ; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        if (more) {
          slab_store(Us + ((s + 1) & 1) * BK * BN);
          __syncthreads();
        }
      }
    }
    // each query's threshold: its list's k-th entry, or the k-th of a full
    // list of another split of the same query when that is ahead (a row
    // behind it is behind k rows of that split, so out of the top k)
    if (lane < NQW && gk != ~0ull) {
      const int ql = warp + NWARP * lane;
      float gd;
      int gi;
      pair_of_key(gk, gd, gi);
      if (hs::pair_less(gd, gi, Td[ql], Ti[ql])) {
        Td[ql] = gd;
        Ti[ql] = gi;
      }
    }
    __syncthreads();  // every slab read before the distance tile lands there

    // epilogue: masked distances (the replaced scan's expressions) into dt,
    // and a flag for each query one of whose rows passes its threshold
    float* dt = Us;
    float tqd[TQ];
    int tqi[TQ];
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      tqd[i] = Td[fidx<TQ, BQ>(ty, i)];
      tqi[i] = Ti[fidx<TQ, BQ>(ty, i)];
    }
    unsigned pass = 0;
    bool rok[TN];
    float xv[TN], fr[TN];
    int cid[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gr = r0 + fidx<TN, BN>(tx, j);
      rok[j] = gr < r_end && gr < n_valid &&
               (row_ids == nullptr || __ldg(row_ids + gr) >= 0);
      xv[j] = fr[j] = 0.f;
      cid[j] = 0;
      if (rok[j] && EST) {
        const uint32_t* tail =
            z.rows + (size_t)gr * z.stride + z.nb * (1 + z.ex_bits);
        xv[j] = __uint_as_float(__ldg(tail));      // f_add
        fr[j] = __uint_as_float(__ldg(tail + 1));  // f_rescale
        cid[j] = static_cast<int>(__ldg(tail + 4));
      } else if (rok[j] && !metric) {
        xv[j] = __ldg(xn + gr);
      }
    }
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int ql = fidx<TQ, BQ>(ty, i), gq = q0 + ql;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int rl = fidx<TN, BN>(tx, j), gr = r0 + rl;
        float dist = HS_INF;
        const bool ok = rok[j] && gq < B &&
                        !(self_offset >= 0 && gr == self_offset + gq);
        if (ok && EST) {
          dist = (xv[j] + Ga[ql * C + cid[j]]) +
                 fr[j] * (acc[i][j] - 0.5f * qv[i]);
        } else if (ok) {
          dist = metric ? 1.f - acc[i][j] : (qv[i] + xv[j]) - 2.f * acc[i][j];
        }
        dt[ql * (BN + 1) + rl] = dist;
        if (hs::pair_less(dist, gr, tqd[i], tqi[i])) pass |= 1u << i;
      }
    }
#pragma unroll
    for (int i = 0; i < TQ; ++i)
      if ((pass >> i) & 1u) Fl[fidx<TQ, BQ>(ty, i)] = 1;
    __syncthreads();

    // fold: each warp takes its flagged queries one by one, the list in
    // registers as NS slots a lane (2 for lists of 32 or 64, 4 for 128)
    auto fold = [&](auto ns) {
      constexpr int NS = decltype(ns)::value;
      unsigned need = __ballot_sync(
          HS_FULL, lane < NQW && Fl[warp + NWARP * (lane & (NQW - 1))] != 0);
      if (lane < NQW) Fl[warp + NWARP * lane] = 0;
      while (need) {
        const int m = __ffs(need) - 1;
        need &= need - 1;
        const int ql = warp + NWARP * m;
        const float* drow = dt + ql * (BN + 1);
        const float td0 = Td[ql];
        const int ti0 = Ti[ql];
        float ld[NS];
        int li[NS];
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const int at = s * 32 + lane;
          ld[s] = at < KL ? Ld[ql * KL + at] : HS_INF;
          li[s] = at < KL ? Li[ql * KL + at] : -1;
        }
#pragma unroll
        for (int c0 = 0; c0 < BN; c0 += 32) {
          const float cd = drow[c0 + lane];
          const int ci = r0 + c0 + lane;
          const bool ok = hs::pair_less(cd, ci, td0, ti0);
          const int n = __popc(__ballot_sync(HS_FULL, ok));
          if (k == 1 && n) {  // the list is its best entry: a warp argmin
            float md = ok ? cd : HS_INF;
            int mi = ok ? ci : -1;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
              const float od = __shfl_xor_sync(HS_FULL, md, o);
              const int oi = __shfl_xor_sync(HS_FULL, mi, o);
              if (hs::pair_less(od, oi, md, mi)) {
                md = od;
                mi = oi;
              }
            }
            if (lane == 0 && hs::pair_less(md, mi, ld[0], li[0])) {
              ld[0] = md;
              li[0] = mi;
            }
          } else if (KL == 32 && n >= MERGE_AT) {
            if constexpr (NS == 2)
              list_merge32(ld, li, ok ? cd : HS_INF, ok ? ci : -1, lane);
          } else if (n) {
            list_offer(ld, li, ok ? cd : HS_INF, ok ? ci : -1, k, lane);
          }
        }
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const int at = s * 32 + lane;
          if (at < KL) {
            Ld[ql * KL + at] = ld[s];
            Li[ql * KL + at] = li[s];
          }
        }
        float td;
        int ti;
        list_kth(ld, li, k, td, ti);
        if (lane == 0) {
          Td[ql] = td;
          Ti[ql] = ti;
          if (gkth != nullptr && ti >= 0)  // a full list: k real rows
            atomicMin(gkth + q0 + ql, pair_key(td, ti));
        }
      }
    };
    if constexpr (TL::K128) {
      if (KL == 128)
        fold(std::integral_constant<int, 4>{});
      else
        fold(std::integral_constant<int, 2>{});
    } else {
      fold(std::integral_constant<int, 2>{});
    }
    __syncthreads();
    if (r0 + BN < r_end) {  // the next tile's first slab, held in registers
      slab_store(Us);
      __syncthreads();
    }
  }

  for (int ql = warp; ql < BQ; ql += NWARP) {
    const int gq = q0 + ql;
    if (gq >= B) break;
    float* od = out_d + ((size_t)split * B + gq) * k;
    int* oi = out_i + ((size_t)split * B + gq) * k;
    for (int at = lane; at < k; at += 32) {
      od[at] = Ld[ql * KL + at];
      oi[at] = Li[ql * KL + at];
    }
  }
}

// one warp per query: merge the per-split top-k lists (NS list slots a
// lane: 2 for k <= 64, 4 for k <= 128)
template <int NS>
__global__ void __launch_bounds__(256)
topk_merge(const float* __restrict__ part_d, const int* __restrict__ part_i,
           int splits, int B, int k, float* __restrict__ out_d,
           int* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  const int gq = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (gq >= B) return;  // warp-uniform
  float ld[NS];
  int li[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    ld[s] = HS_INF;
    li[s] = -1;
  }
  for (int s = 0; s < splits; ++s) {
    const size_t row = ((size_t)s * B + gq) * k;
    for (int c0 = 0; c0 < k; c0 += 32) {
      const int c = c0 + lane;
      const float cd = c < k ? part_d[row + c] : HS_INF;
      const int ci = c < k ? part_i[row + c] : -1;
      list_offer(ld, li, cd, ci, k, lane);
    }
  }
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int idx = s * 32 + lane;
    if (idx < k) {
      out_d[(size_t)gq * k + idx] = ld[s];
      out_i[(size_t)gq * k + idx] = li[s];
    }
  }
}

// one block per query: stable sort of the per-segment picks by distance
// (ties in segment-major order), rows mapped to ids through row_ids
constexpr int MAX_SEEDS = 1024;

__global__ void __launch_bounds__(256)
strata_sort(const float* __restrict__ part_d, const int* __restrict__ part_i,
            const int* __restrict__ row_ids, int strata, int B, int sps,
            float* __restrict__ out_d, int* __restrict__ out_id) {
  __shared__ float sd[MAX_SEEDS];
  __shared__ int sj[MAX_SEEDS], spos[MAX_SEEDS];
  const int gq = blockIdx.x, S = strata * sps;
  const int Sp = hs::next_pow2(S);
  for (int j = threadIdx.x; j < Sp; j += blockDim.x) {
    float d = HS_INF;
    int pos = -1;
    if (j < S) {
      const int seg = j / sps, r = j - seg * sps;
      const size_t at = ((size_t)seg * B + gq) * sps + r;
      d = part_d[at];
      pos = part_i[at];
    }
    sd[j] = d;
    sj[j] = j;
    spos[j] = pos;
  }
  __syncthreads();
  hs::sort_pairs(sd, sj, Sp);
  for (int t = threadIdx.x; t < S; t += blockDim.x) {
    const float d = sd[t];
    const int pos = spos[sj[t]];
    out_d[(size_t)gq * S + t] = d;
    out_id[(size_t)gq * S + t] = (isinf(d) || pos < 0) ? -1 : row_ids[pos];
  }
}

// The scan launch of a plan (tile 0 L, 1 M, 2 U, 3 T; splits; smem bytes,
// which must cover the tile's layout with the whole query tile, or for U
// at least one 32-dim slab of it: with fewer than Dp dims' room U stages it
// in chunks of the most whole slabs that fit): grid (query tiles, splits),
// each split ceil(N / splits) rows rounded up to the tile's BN; gkth
// (u64[B], reset here) holds the splits' shared thresholds, null in strata
// mode, whose splits keep their own top k.
template <class TL, bool EST, class T>
int launch_tile(const float* q, const float* qn, const T* x, const float* xn,
                const hs::Quant& z, const int* row_ids, int B, int N, int D,
                int n_valid, int self_offset, int k, int metric, int splits,
                int rows_per_split, int smem, unsigned long long* gkth,
                float* od, int* oi, cudaStream_t st) {
  const int Dp = (D + BK - 1) / BK * BK;
  const size_t rest = scan_smem<TL>(0, list_slots(k), EST ? z.C : 0);
  const size_t slab = sizeof(float) * BK * TL::BQ;
  if (smem > SMEM_MAX || (size_t)smem < rest + slab ||
      (list_slots(k) == 128 && !TL::K128))
    return static_cast<int>(cudaErrorInvalidValue);
  const int Dq = min(Dp, static_cast<int>((smem - rest) / slab) * BK);
  if (Dq < Dp && !TL::CHUNK) return static_cast<int>(cudaErrorInvalidValue);
  if (rows_per_split <= 0)
    rows_per_split = ((N + splits - 1) / splits + TL::BN - 1) / TL::BN * TL::BN;
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<TL, EST, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (gkth != nullptr &&
      (err = cudaMemsetAsync(gkth, 0xff, sizeof(*gkth) * B, st)) !=
          cudaSuccess)
    return static_cast<int>(err);
  const dim3 grid((B + TL::BQ - 1) / TL::BQ, splits);
  scan_kernel<TL, EST, T><<<grid, THREADS, smem, st>>>(
      q, qn, x, xn, z, row_ids, B, N, D, Dp, Dq, n_valid, self_offset, k,
      metric, rows_per_split, gkth, od, oi);
  return static_cast<int>(cudaGetLastError());
}

template <bool EST, class T>
int launch_scan(int tile, const float* q, const float* qn, const T* x,
                const float* xn, const hs::Quant& z, const int* row_ids,
                int B, int N, int D, int n_valid, int self_offset, int k,
                int metric, int splits, int rows_per_split, int smem,
                unsigned long long* gkth, float* od, int* oi,
                cudaStream_t st) {
  if (k < 1 || k > MAX_K || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define HS_TILE(TL)                                                        \
  launch_tile<TL, EST, T>(q, qn, x, xn, z, row_ids, B, N, D, n_valid,      \
                          self_offset, k, metric, splits, rows_per_split,  \
                          smem, gkth, od, oi, st)
  switch (tile) {
    case 0: return HS_TILE(TileL);
    case 1: return HS_TILE(TileM);
    case 2: return HS_TILE(TileU);
    case 3: return HS_TILE(TileT);
  }
#undef HS_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

void merge_splits(const float* part_d, const int* part_i, int splits, int B,
                  int k, float* out_d, int* out_i, cudaStream_t st) {
  if (k > 64)
    topk_merge<4><<<(B + 7) / 8, 256, 0, st>>>(part_d, part_i, splits, B, k,
                                               out_d, out_i);
  else
    topk_merge<2><<<(B + 7) / 8, 256, 0, st>>>(part_d, part_i, splits, B, k,
                                               out_d, out_i);
}

template <class T>
int launch_topk(const float* q, const float* qn, const T* x, const float* xn,
                const int* row_ids, int B, int N, int D, int n_valid,
                int self_offset, int k, int metric, int tile, int splits,
                int smem, float* part_d, int* part_i,
                unsigned long long* gkth, float* out_d, int* out_i,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch_scan<false, T>(
      tile, q, qn, x, xn, hs::Quant{}, row_ids, B, N, D, n_valid, self_offset,
      k, metric, splits, 0, smem, splits == 1 ? nullptr : gkth,
      splits == 1 ? out_d : part_d, splits == 1 ? out_i : part_i, st);
  if (err) return err;
  if (splits > 1) merge_splits(part_d, part_i, splits, B, k, out_d, out_i, st);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_strata(const float* q, const float* qn, const T* x,
                  const float* xn, const int* row_ids, int B, int N, int D,
                  int sps, int strata, int metric, int tile, int smem,
                  float* part_d, int* part_i, float* out_d, int* out_id,
                  void* stream) {
  if (strata < 1 || N % strata || sps < 1 || sps > 64 ||
      strata * sps > MAX_SEEDS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch_scan<false, T>(
      tile, q, qn, x, xn, hs::Quant{}, row_ids, B, N, D, N, -1, sps, metric,
      strata, N / strata, smem, nullptr, part_d, part_i, st);
  if (err) return err;
  strata_sort<<<B, 256, 0, st>>>(part_d, part_i, row_ids, strata, B, sps,
                                 out_d, out_id);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// part_d / part_i: the per-split lists [splits, B, k]; gkth: u64[B] of
// scratch for the splits' shared thresholds (both unused with one split)
extern "C" int hs_topk_dist(const float* q, const float* qn, const float* x,
                            const float* xn, const int* row_ids, int B, int N,
                            int D, int n_valid, int self_offset, int k,
                            int metric, int tile, int splits, int smem,
                            float* part_d, int* part_i,
                            unsigned long long* gkth, float* out_d,
                            int* out_i, void* stream) {
  return launch_topk(q, qn, x, xn, row_ids, B, N, D, n_valid, self_offset, k,
                     metric, tile, splits, smem, part_d, part_i, gkth, out_d,
                     out_i, stream);
}

// the same over bfloat16 rows (a bf16 store or a gather of one)
extern "C" int hs_topk_dist_bf16(const float* q, const float* qn,
                                 const __nv_bfloat16* x, const float* xn,
                                 const int* row_ids, int B, int N, int D,
                                 int n_valid, int self_offset, int k,
                                 int metric, int tile, int splits, int smem,
                                 float* part_d, int* part_i,
                                 unsigned long long* gkth, float* out_d,
                                 int* out_i, void* stream) {
  return launch_topk(q, qn, x, xn, row_ids, B, N, D, n_valid, self_offset, k,
                     metric, tile, splits, smem, part_d, part_i, gkth, out_d,
                     out_i, stream);
}

extern "C" int hs_topk_strata(const float* q, const float* qn, const float* x,
                              const float* xn, const int* row_ids, int B,
                              int N, int D, int sps, int strata, int metric,
                              int tile, int smem, float* part_d, int* part_i,
                              float* out_d, int* out_id, void* stream) {
  return launch_strata(q, qn, x, xn, row_ids, B, N, D, sps, strata, metric,
                       tile, smem, part_d, part_i, out_d, out_id, stream);
}

// the seed table of a bfloat16 store (a gather of that store's rows)
extern "C" int hs_topk_strata_bf16(const float* q, const float* qn,
                                   const __nv_bfloat16* x, const float* xn,
                                   const int* row_ids, int B, int N, int D,
                                   int sps, int strata, int metric, int tile,
                                   int smem, float* part_d, int* part_i,
                                   float* out_d, int* out_id, void* stream) {
  return launch_strata(q, qn, x, xn, row_ids, B, N, D, sps, strata, metric,
                       tile, smem, part_d, part_i, out_d, out_id, stream);
}

// Kα in estimate mode: top-k rows of the packed table (N rows; scorer
// arguments as in hs_greedy_descent_quant) by 1-bit estimate, rows whose
// row_ids entry is negative masked
extern "C" int hs_topk_estimate(const uint32_t* qrows, int qstride, int nb,
                                int ex_bits, const float* q_rot,
                                const float* sumq, const float* g_add, int C,
                                const int* row_ids, int B, int N, int k,
                                int tile, int splits, int smem, float* part_d,
                                int* part_i, unsigned long long* gkth,
                                float* out_d, int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const hs::Quant z{qrows, qstride, nb, ex_bits, 0, q_rot, sumq, g_add, C};
  const int err = launch_scan<true, uint32_t>(
      tile, q_rot, nullptr, qrows, nullptr, z, row_ids, B, N, nb * 32, N, -1,
      k, 0, splits, 0, smem, splits == 1 ? nullptr : gkth,
      splits == 1 ? out_d : part_d, splits == 1 ? out_i : part_i, st);
  if (err) return err;
  if (splits > 1) merge_splits(part_d, part_i, splits, B, k, out_d, out_i, st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
