// Kε greedy_descent: greedy descent over levels' neighbor rows (dense,
// behind a rank indirection, or CHAL slices: common.cuh Fetch), one warp
// per query, one level a launch or a run of levels in one launch.
//
// Replaces (JAX): hnsw_slim_tpu/graph/search.py greedy_level_scored /
// greedy_level with make_dense_fetch / make_rank_fetch / make_chal_fetch and
// make_exact_scorer — the lax.while_loop that a whole batch runs in
// lockstep, once per upper level, in level_search (the vanilla query path),
// in chal_search above the threshold level and in the insert-time candidate
// search (graph/build.py _build_search, _build_search0).
//
// What bounds it: the row gathers. A step reads one neighbor row (4*W bytes)
// and one D*4-byte vector per valid neighbor (512 B at d=128), with 4*D
// flops on each: far below the arithmetic rate, and the steps of one query
// form a dependent chain, so latency rules unless many queries and many
// rows a query are in flight.
//
// Design: one warp per query, eight warps a block, each warp taking queries
// in turn (the grid holds what fits on the card at once); the query sits in
// the warp's shared memory. A step fetches the node's row, compacts its
// valid ids, and scores them R at a time (4 fp32 rows, 8 bf16 rows: the
// register cap that keeps 4 / 3 blocks on an SM): the loads of all R rows go
// out before any is summed (common.cuh warp_dot_rows: one coalesced 16-byte
// load a lane per row at d=128), and the R dots and norms are reduced
// together by warp_sum_rows, whose tree is warp_sum's, so every distance is
// bit-equal to a one-row-at-a-time warp_sum. Each lane keeps the best of its
// rows, and five shuffle steps take the warp's argmin. The distance and tie
// rules are the JAX scorer's: |q|^2 + |x|^2 - 2 q.x with |x|^2 from the
// gathered row (or 1 - q.x), the argmin takes the smallest id among equal
// minima, and the query moves only on a strict improvement; hops count the
// rows fetched and dcomp the valid ids scored.
//
// Levels: up to MAX_LEVELS levels top, top-1, ... in one launch, a Fetch
// each (the forms may differ by level); query b walks level l only if
// l > stop[b], so each query has its own stop level (at or above the top:
// nothing; it keeps (cur, curdist) and counts 0), and no query waits for the
// batch at a level boundary. hops and dcomp are summed over the levels
// walked. A launch of one level is greedy_level's per-level form.
//
// Over a bfloat16 store (the _bf16 entries; HnswConfig.store_dtype) a
// neighbor is one 8-byte load a lane (256 B at d=128), widened to fp32 in
// registers (common.cuh load4); the arithmetic and the rules are the same.
//
// Quantized scorer (QUANT, JAX greedy_level_scored with the SlimQ estimate
// scorer of index/slimq.py _slimq_search_jit): the distance of a neighbor is
// its RaBitQ estimate from one packed code row (84 B at P = 128 and 4 bits
// instead of a 512 B vector), R code rows a group: common.cuh
// quant_score_rows issues every word of the R rows' estimates (bit planes,
// factors, cluster id) in one gather round before any sum, one round per
// QUANT_ROUND_WORDS words of a row, through the warp's stage in shared
// memory, so a group waits on one memory round trip; every estimate is
// bit-equal to quant_score's one-row estimate. The rotated query and the
// query's g_add row sit in shared memory. With score_cur the warp first
// scores its query's own start node (curdist is then output only), as the
// JAX search scores the entry point through the same closure; with no level
// to walk the launch does just that.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr int MAX_LEVELS = 32;  // levels of one launch
// rows in flight a warp, and blocks an SM (the register cap): 4 fp32 rows
// (or code rows) at 4 blocks, 8 bf16 rows at 3
template <class T>
__host__ __device__ constexpr int rows_in_flight() { return sizeof(T) == 2 ? 8 : 4; }
template <class T>
__host__ __device__ constexpr int blocks_per_sm() { return sizeof(T) == 2 ? 3 : 4; }

struct Levels {
  hs::Fetch f[MAX_LEVELS];  // f[i] is level top - i
  int n, top;
};

template <bool QUANT, class T>
__global__ void __launch_bounds__(THREADS, blocks_per_sm<T>())
greedy_kernel(const T* __restrict__ vec, int D, const Levels lv,
              const hs::Quant z, const float* __restrict__ q,
              const float* __restrict__ qn, const int* __restrict__ stop,
              int B, int metric, int Dp,
              int score_cur, int* __restrict__ cur,
              float* __restrict__ curdist, int* __restrict__ hops_out,
              int* __restrict__ dcomp_out) {
  constexpr int R = rows_in_flight<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_warp = Dp + (QUANT ? z.C : 0) + 32;
  // exact: the query (D floats); quantized: q_rot (D = 32 nb), then g_add;
  // then the compacted ids of a row chunk
  float* qs = reinterpret_cast<float*>(smem) + (size_t)warp * per_warp;
  float* ga = qs + Dp;
  int* cids = reinterpret_cast<int*>(ga + (QUANT ? z.C : 0));
  const bool vec4 = hs::can_vec4(vec, D);
  const float* qsrc = QUANT ? z.q_rot : q;
  // quantized: the warp's stage of gathered code words
  uint32_t* stage = nullptr;
  if constexpr (QUANT) {
    __shared__ __align__(16) uint32_t s_stage[NW * hs::QUANT_ROUND_WORDS * R];
    stage = s_stage + warp * hs::QUANT_ROUND_WORDS * R;
  }

  // each warp takes queries in turn; the whole warp shares b
  for (int b = blockIdx.x * NW + warp; b < B; b += gridDim.x * NW) {
    __syncwarp();
    for (int i = lane; i < D; i += 32) qs[i] = qsrc[(size_t)b * D + i];
    if (QUANT)
      for (int i = lane; i < z.C; i += 32) ga[i] = z.g_add[(size_t)b * z.C + i];
    __syncwarp();
    const float qnv = QUANT ? z.sumq[b] : qn[b];  // quantized: sum(q_rot)
    int c = cur[b];
    float cd = (QUANT && score_cur)
                   ? hs::quant_score(z, qs, ga, qnv, c, stage)
                   : curdist[b];
    int hops = 0, dcomp = 0;
    const int sb = stop == nullptr ? -1 : stop[b];
    for (int li = 0; li < lv.n; ++li) {
      if (lv.top - li <= sb) break;
      const hs::Fetch& f = lv.f[li];
      while (true) {
        ++hops;
        int W;  // lanes of this node's row (warp-uniform)
        const int* row = hs::fetch_row(f, c, W);
        float bd = HS_INF;  // this lane's best (distance, id)
        int bid = hs::BIG;
        for (int j0 = 0; j0 < W; j0 += 32) {
          const int cnt = min(32, W - j0);
          const int mine = lane < cnt ? __ldg(row + j0 + lane) : -1;
          const unsigned vm = __ballot_sync(HS_FULL, mine >= 0);
          const int nv = __popc(vm);
          if (mine >= 0) cids[__popc(vm & ((1u << lane) - 1u))] = mine;
          __syncwarp();
          dcomp += nv;
          for (int u0 = 0; u0 < nv; u0 += R) {
            const int nr = min(R, nv - u0);
            int ids[R];
#pragma unroll
            for (int r = 0; r < R; ++r) ids[r] = r < nr ? cids[u0 + r] : 0;
            float d;
            if constexpr (QUANT) {
              d = hs::quant_score_rows<R>(z, qs, ga, qnv, ids, nr, stage);
            } else {
              const T* rows[R];
              float* const none[R] = {};
#pragma unroll
              for (int r = 0; r < R; ++r) rows[r] = vec + (size_t)ids[r] * D;
              float s, n;
              hs::warp_dot_rows<R>(qs, rows, nr, D, vec4, s, n, none);
              d = metric ? 1.f - s : (qnv + n) - 2.f * s;
            }
            const int me = lane / (32 / R);
            int id = 0;
#pragma unroll
            for (int r = 0; r < R; ++r)
              if (r == me) id = ids[r];
            if (me < nr && hs::pair_less(d, id, bd, bid)) {
              bd = d;
              bid = id;
            }
          }
          __syncwarp();
        }
        // the warp's argmin (smallest id among equal minima)
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const float od = __shfl_xor_sync(HS_FULL, bd, o);
          const int oi = __shfl_xor_sync(HS_FULL, bid, o);
          if (hs::pair_less(od, oi, bd, bid)) {
            bd = od;
            bid = oi;
          }
        }
        if (!(bd < cd)) break;
        c = bid;
        cd = bd;
      }
    }
    if (lane == 0) {
      cur[b] = c;
      curdist[b] = cd;
      hops_out[b] = hops;
      dcomp_out[b] = dcomp;
    }
  }
}

template <bool QUANT, class T>
int launch_greedy(const T* vec, int D, const Levels& lv, const hs::Quant& z,
                  const float* q, const float* qn, const int* stop, int B,
                  int metric, int score_cur, int* cur, float* curdist,
                  int* hops, int* dcomp, void* stream) {
  if (lv.n < 0 || lv.n > MAX_LEVELS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Dp = (D + 3) / 4 * 4;
  const int smem =
      static_cast<int>(sizeof(float) * (Dp + (QUANT ? z.C : 0) + 32) * NW);
  auto kern = greedy_kernel<QUANT, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, THREADS, smem)) != cudaSuccess)
    return static_cast<int>(err);
  const int grid = max(1, min((B + NW - 1) / NW, max(1, per_sm) * sms));
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      vec, D, lv, z, q, qn, stop, B, metric, Dp, score_cur, cur, curdist,
      hops, dcomp);
  return static_cast<int>(cudaGetLastError());
}

// levels from host arrays: ptrs = (rows, aux) per level, params = (mode, W,
// level, stride) per level, level top first
Levels host_levels(int nlev, int top, const long long* ptrs,
                   const int* params) {
  Levels lv{};
  lv.n = nlev;
  lv.top = top;
  for (int i = 0; i < nlev && i < MAX_LEVELS; ++i)
    lv.f[i] = hs::Fetch{reinterpret_cast<const int*>(ptrs[2 * i]),
                        reinterpret_cast<const int*>(ptrs[2 * i + 1]),
                        params[4 * i], params[4 * i + 1], params[4 * i + 2],
                        params[4 * i + 3]};
  return lv;
}

}  // namespace

// Kε over nlev levels top, top-1, ... in one launch (host arrays ptrs /
// params as in host_levels), query b walking level l only if l > stop[b]
// (stop null: every level); one level is the per-level launch
extern "C" int hs_greedy_levels(const float* vec, int D, int nlev, int top,
                                const long long* ptrs, const int* params,
                                const float* q, const float* qn,
                                const int* stop, int B, int metric, int* cur,
                                float* curdist, int* hops, int* dcomp,
                                void* stream) {
  return launch_greedy<false>(vec, D, host_levels(nlev, top, ptrs, params),
                              hs::Quant{}, q, qn, stop, B, metric, 0, cur,
                              curdist, hops, dcomp, stream);
}

extern "C" int hs_greedy_levels_bf16(const __nv_bfloat16* vec, int D,
                                     int nlev, int top, const long long* ptrs,
                                     const int* params, const float* q,
                                     const float* qn, const int* stop, int B,
                                     int metric, int* cur, float* curdist,
                                     int* hops, int* dcomp, void* stream) {
  return launch_greedy<false>(vec, D, host_levels(nlev, top, ptrs, params),
                              hs::Quant{}, q, qn, stop, B, metric, 0, cur,
                              curdist, hops, dcomp, stream);
}

extern "C" int hs_greedy_levels_quant(
    const uint32_t* qrows, int qstride, int nb, int ex_bits, int use_ex,
    const float* q_rot, const float* sumq, const float* g_add, int C,
    int nlev, int top, const long long* ptrs, const int* params,
    const int* stop, int B, int score_cur, int* cur, float* curdist,
    int* hops, int* dcomp, void* stream) {
  const hs::Quant z{qrows, qstride, nb, ex_bits, use_ex, q_rot, sumq, g_add,
                    C};
  return launch_greedy<true>(static_cast<const float*>(nullptr), nb * 32,
                             host_levels(nlev, top, ptrs, params), z, nullptr,
                             nullptr, stop, B, 0, score_cur, cur, curdist,
                             hops, dcomp, stream);
}
