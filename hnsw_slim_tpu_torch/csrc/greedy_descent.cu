// Kε greedy_descent: one level of greedy descent over a level's neighbor
// rows (dense, behind a rank indirection, or CHAL slices: common.cuh Fetch),
// one warp per query.
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
// form a dependent chain, so latency rules unless many queries are in
// flight.
//
// Design: one warp per query, eight queries per block, the query in shared
// memory; each query loops on its own until no neighbor improves (no
// lockstep, no batch-wide "changed" reduction). A neighbor vector is one
// coalesced warp-wide load (16 bytes a lane at d=128); the loads of four
// neighbors are issued before their reductions so their latencies overlap.
// The distance and tie rules are the JAX scorer's: |q|^2 + |x|^2 - 2 q.x with
// |x|^2 from the gathered row (or 1 - q.x), the argmin takes the smallest id
// among equal minima, and the query moves only on a strict improvement.
// Queries whose active flag is 0 keep their (cur, curdist) and count 0.
// Over a bfloat16 store (hs_greedy_descent_bf16; HnswConfig.store_dtype) a
// neighbor is one 8-byte load a lane (256 B at d=128), widened to fp32 in
// registers (common.cuh load4); the arithmetic and the rules are the same.
//
// Quantized scorer (QUANT, JAX greedy_level_scored with the SlimQ estimate
// scorer of index/slimq.py _slimq_search_jit): the distance of a neighbor is
// its RaBitQ estimate from one packed code row (common.cuh quant_score; 84 B
// at P = 128 and 4 bits instead of a 512 B vector), with the rotated query
// and the query's g_add row in shared memory. Same tie and move rules.
// With score_cur the warp first scores its query's own start node (curdist
// is then output only), as the JAX search scores the entry point through the
// same closure; with every query inactive the launch does just that.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr int GROUP = 4;

template <bool QUANT, class T>
__global__ void __launch_bounds__(THREADS)
greedy_kernel(const T* __restrict__ vec, int D, const hs::Fetch f,
              const hs::Quant z, const float* __restrict__ q,
              const float* __restrict__ qn,
              const unsigned char* __restrict__ active, int B, int metric,
              int Dp, int score_cur, int* __restrict__ cur,
              float* __restrict__ curdist, int* __restrict__ hops_out, int* __restrict__ dcomp_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * NW + warp;
  if (b >= B) return;  // whole warp; the kernel has no block barrier
  // exact: the query (D floats); quantized: q_rot (D = 32 nb) then g_add
  float* qs = reinterpret_cast<float*>(smem) +
              (size_t)warp * (Dp + (QUANT ? z.C : 0));
  float* ga = qs + Dp;
  const float* qsrc = QUANT ? z.q_rot : q;
  for (int i = lane; i < D; i += 32) qs[i] = qsrc[(size_t)b * D + i];
  if (QUANT)
    for (int i = lane; i < z.C; i += 32) ga[i] = z.g_add[(size_t)b * z.C + i];
  __syncwarp();

  const bool vec4 = hs::can_vec4(vec, D);
  const float qnv = QUANT ? z.sumq[b] : qn[b];  // quantized: sum(q_rot)
  int c = cur[b];
  float cd = (QUANT && score_cur) ? hs::quant_score(z, qs, ga, qnv, c)
                                  : curdist[b];
  int hops = 0, dcomp = 0;
  bool go = active == nullptr || active[b] != 0;
  while (go) {
    ++hops;
    int W;  // lanes of this node's row (warp-uniform)
    const int* row = hs::fetch_row(f, c, W);
    float best_d = HS_INF;
    int best_id = hs::BIG;
    for (int j0 = 0; j0 < W; j0 += 32) {
      const int cnt = min(32, W - j0);
      const int mine = lane < cnt ? __ldg(row + j0 + lane) : -1;
      for (int u0 = 0; u0 < cnt; u0 += GROUP) {
        int id[GROUP];
        float s[GROUP], n[GROUP];
#pragma unroll
        for (int g = 0; g < GROUP; ++g) {
          id[g] = __shfl_sync(HS_FULL, mine, (u0 + g) & 31);
          s[g] = 0.f;
          n[g] = 0.f;
        }
        if (!QUANT) {
#pragma unroll
          for (int g = 0; g < GROUP; ++g)
            if (id[g] >= 0)  // warp-uniform: every lane holds the same id
              hs::partial_dot(qs, vec + (size_t)id[g] * D, D, vec4, s[g],
                              n[g]);
        }
#pragma unroll
        for (int g = 0; g < GROUP; ++g) {
          if (id[g] < 0) continue;
          ++dcomp;
          // the butterfly sum leaves the same value in every lane, so the
          // comparisons below agree across the warp
          float d;
          if (QUANT) {
            d = hs::quant_score(z, qs, ga, qnv, id[g]);
          } else {
            const float dot = hs::warp_sum(s[g]);
            const float nrm = hs::warp_sum(n[g]);
            d = metric ? 1.f - dot : (qnv + nrm) - 2.f * dot;
          }
          if (hs::pair_less(d, id[g], best_d, best_id)) {
            best_d = d;
            best_id = id[g];
          }
        }
      }
    }
    if (best_d < cd) {
      c = best_id;
      cd = best_d;
    } else {
      go = false;
    }
  }
  if (lane == 0) {
    cur[b] = c;
    curdist[b] = cd;
    hops_out[b] = hops;
    dcomp_out[b] = dcomp;
  }
}

template <bool QUANT, class T>
int launch_greedy(const T* vec, int D, const hs::Fetch& f,
                  const hs::Quant& z, const float* q, const float* qn,
                  const unsigned char* active, int B, int metric,
                  int score_cur, int* cur, float* curdist, int* hops,
                  int* dcomp, void* stream) {
  const int Dp = (D + 3) / 4 * 4;
  const size_t smem = sizeof(float) * (Dp + (QUANT ? z.C : 0)) * NW;
  cudaError_t err = cudaFuncSetAttribute(
      greedy_kernel<QUANT, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (B + NW - 1) / NW;
  greedy_kernel<QUANT, T><<<grid, THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      vec, D, f, z, q, qn, active, B, metric, Dp, score_cur, cur, curdist,
      hops, dcomp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hs_greedy_descent(const float* vec, int D, const int* rows,
                                 const int* aux, int mode, int W, int level,
                                 int stride, const float* q, const float* qn,
                                 const unsigned char* active, int B,
                                 int metric, int* cur, float* curdist,
                                 int* hops, int* dcomp, void* stream) {
  const hs::Fetch f{rows, aux, mode, W, level, stride};
  return launch_greedy<false>(vec, D, f, hs::Quant{}, q, qn, active, B,
                              metric, 0, cur, curdist, hops, dcomp, stream);
}

// the same over a bfloat16 store (rows widened to fp32 in registers)
extern "C" int hs_greedy_descent_bf16(const __nv_bfloat16* vec, int D,
                                      const int* rows, const int* aux,
                                      int mode, int W, int level, int stride,
                                      const float* q, const float* qn,
                                      const unsigned char* active, int B,
                                      int metric, int* cur, float* curdist,
                                      int* hops, int* dcomp, void* stream) {
  const hs::Fetch f{rows, aux, mode, W, level, stride};
  return launch_greedy<false>(vec, D, f, hs::Quant{}, q, qn, active, B,
                              metric, 0, cur, curdist, hops, dcomp, stream);
}

// Kε on estimates: the scorer (packed rows, row stride in words, nb,
// ex_bits, use_ex, q_rot, sumq, g_add, C) takes the place of the vectors;
// score_cur: curdist comes in unset and starts as the estimate of cur
extern "C" int hs_greedy_descent_quant(
    const uint32_t* qrows, int qstride, int nb, int ex_bits, int use_ex,
    const float* q_rot, const float* sumq, const float* g_add, int C,
    const int* rows, const int* aux, int mode, int W, int level, int stride,
    const unsigned char* active, int B, int score_cur, int* cur,
    float* curdist, int* hops, int* dcomp, void* stream) {
  const hs::Fetch f{rows, aux, mode, W, level, stride};
  const hs::Quant z{qrows, qstride, nb, ex_bits, use_ex, q_rot, sumq, g_add,
                    C};
  return launch_greedy<true>(static_cast<const float*>(nullptr), nb * 32, f,
                             z, nullptr, nullptr, active,
                             B, 0, score_cur, cur, curdist, hops, dcomp,
                             stream);
}
