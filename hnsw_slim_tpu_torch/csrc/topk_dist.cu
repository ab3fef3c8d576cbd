// Kα topk_dist: fused distance + running top-k, no [B, N] matrix in memory.
//
// Replaces (JAX): hnsw_slim_tpu/index/bruteforce.py _bf_topk / exact_topk
// (chunked distance matmul + running lax.top_k), the exact seed block of
// graph/search.py chal_search (top-S over all level>=1 vectors) and
// graph/build.py _exact_knn_subset (self-masked subset kNN).
//
// What bounds it: B*N*D fp32 FMAs (true fp32, no TF32: the JAX code runs
// these at Precision.HIGHEST) — 1.07e12 FMA-flops for 4096 queries over
// 1M x 128 — and, at small B, streaming x (512 MB at 1M x 128) through L2.
//
// Design: a block owns 32 queries and a contiguous range of rows (grid.y
// splits N so that small query batches still fill every SM). It streams
// 64-row tiles of x and 32-dim slabs of q and x through shared memory; 256
// threads compute the 32x64 tile as 2x4 register micro-tiles. The distance
// tile goes to shared memory, and each warp folds it into the top-k lists
// of its 4 queries. A list (k <= 64) lives in registers, 2 entries per lane,
// ordered by (distance, row); a candidate enters only if it beats entry
// k-1, which after the first tiles is rare, so the insert (ballot for the
// position, shuffle-up to shift) costs little. With splits > 1 a second
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
// (common.cuh Quant). A 32-dim slab of a row is one u32 word, unpacked into
// the x tile as {0, 1}, so the same micro-tiles accumulate <q_rot, bits>;
// the epilogue forms f_add + g_add[query, cluster] + f_rescale *
// (<q_rot, bits> - sumq / 2) from the row's own factors — always the 1-bit
// pair — and the same running top-k takes it. Neither the unpacked planes
// nor the [B, rows] estimates reach device memory.
//
// bfloat16 rows (hs_topk_dist_bf16, hs_topk_strata_bf16: a bf16 store, or
// the seed table gathered from one, as the JAX union's seed table is): the
// x tile is loaded from bf16 and widened to fp32 as it enters shared
// memory, so the micro-tiles, norms and lists are as above and the scan
// streams half the bytes.
#include "common.cuh"

namespace {

constexpr int BQ = 32, BN = 64, DK = 32, THREADS = 256;

// insert (cd, ci) into a lane-distributed sorted list (slot s of lane l is
// entry s*32 + l); entries past k are don't-care
__device__ __forceinline__ void list_insert(float (&ld)[2], int (&li)[2],
                                            float cd, int ci, int lane) {
  const bool lt0 = hs::pair_less(ld[0], li[0], cd, ci);
  const bool lt1 = hs::pair_less(ld[1], li[1], cd, ci);
  const int p = __popc(__ballot_sync(HS_FULL, lt0)) +
                __popc(__ballot_sync(HS_FULL, lt1));
  const float u0d = __shfl_up_sync(HS_FULL, ld[0], 1);
  const int u0i = __shfl_up_sync(HS_FULL, li[0], 1);
  const float u1d = __shfl_up_sync(HS_FULL, ld[1], 1);
  const int u1i = __shfl_up_sync(HS_FULL, li[1], 1);
  const float l0d = __shfl_sync(HS_FULL, ld[0], 31);
  const int l0i = __shfl_sync(HS_FULL, li[0], 31);
  if (lane == p) { ld[0] = cd; li[0] = ci; }
  else if (lane > p) { ld[0] = u0d; li[0] = u0i; }
  if (lane + 32 == p) { ld[1] = cd; li[1] = ci; }
  else if (lane + 32 > p) {
    ld[1] = lane ? u1d : l0d;
    li[1] = lane ? u1i : l0i;
  }
}

__device__ __forceinline__ void list_kth(const float (&ld)[2],
                                         const int (&li)[2], int k, float& td,
                                         int& ti) {
  const int s = (k - 1) >> 5, l = (k - 1) & 31;
  td = __shfl_sync(HS_FULL, s ? ld[1] : ld[0], l);
  ti = __shfl_sync(HS_FULL, s ? li[1] : li[0], l);
}

// offer one candidate per lane (in lane order) to the list
__device__ __forceinline__ void list_offer(float (&ld)[2], int (&li)[2],
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

template <bool EST, class T>
__global__ void __launch_bounds__(THREADS)
topk_scan(const float* __restrict__ q, const float* __restrict__ qn,
          const T* __restrict__ x, const float* __restrict__ xn,
          const hs::Quant z, const int* __restrict__ row_ids, int B, int N,
          int D, int n_valid, int self_offset, int k, int metric,
          int rows_per_split, float* __restrict__ out_d,
          int* __restrict__ out_i) {
  __shared__ float qs[BQ][DK + 1];
  __shared__ float xs[BN][DK + 1];
  __shared__ float dt[BQ][BN + 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(N, r_begin + rows_per_split);

  float ld[4][2];
  int li[4][2];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    ld[r][0] = ld[r][1] = HS_INF;
    li[r][0] = li[r][1] = -1;
  }

  for (int r0 = r_begin; r0 < r_end; r0 += BN) {
    float acc[2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[a][j] = 0.f;
    for (int k0 = 0; k0 < D; k0 += DK) {
      for (int e = tid; e < BQ * DK; e += THREADS) {
        const int a = e / DK, c = e % DK, gq = q0 + a, gc = k0 + c;
        qs[a][c] = (gq < B && gc < D) ? q[(size_t)gq * D + gc] : 0.f;
      }
      for (int e = tid; e < BN * DK; e += THREADS) {
        const int a = e / DK, c = e % DK, gr = r0 + a, gc = k0 + c;
        if (EST) {  // DK = 32: this slab is word k0 / 32 of the 1-bit plane
          const uint32_t word =
              gr < r_end ? __ldg(z.rows + (size_t)gr * z.stride + k0 / DK)
                         : 0u;
          xs[a][c] = static_cast<float>((word >> c) & 1u);
        } else {
          xs[a][c] =
              (gr < r_end && gc < D) ? hs::load1(x + (size_t)gr * D + gc) : 0.f;
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < DK; ++c) {
        const float a0 = qs[ty * 2][c], a1 = qs[ty * 2 + 1][c];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float bv = xs[tx * 4 + j][c];
          acc[0][j] = fmaf(a0, bv, acc[0][j]);
          acc[1][j] = fmaf(a1, bv, acc[1][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gq = q0 + ty * 2 + a, gr = r0 + tx * 4 + j;
        float dist = HS_INF;
        const bool ok = gq < B && gr < r_end && gr < n_valid &&
                        (row_ids == nullptr || row_ids[gr] >= 0) &&
                        !(self_offset >= 0 && gr == self_offset + gq);
        if (ok && EST) {
          const uint32_t* tail =
              z.rows + (size_t)gr * z.stride + z.nb * (1 + z.ex_bits);
          const float f_add = __uint_as_float(__ldg(tail));
          const float f_rescale = __uint_as_float(__ldg(tail + 1));
          const int cid = static_cast<int>(__ldg(tail + 4));
          dist = (f_add + z.g_add[(size_t)gq * z.C + cid]) +
                 f_rescale * (acc[a][j] - 0.5f * z.sumq[gq]);
        } else if (ok) {
          dist = metric ? 1.f - acc[a][j]
                        : (qn[gq] + xn[gr]) - 2.f * acc[a][j];
        }
        dt[ty * 2 + a][tx * 4 + j] = dist;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int ql = warp * 4 + r;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = h * 32 + lane;
        list_offer(ld[r], li[r], dt[ql][col], r0 + col, k, lane);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gq = q0 + warp * 4 + r;
    if (gq >= B) continue;
    float* od = out_d + ((size_t)split * B + gq) * k;
    int* oi = out_i + ((size_t)split * B + gq) * k;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int idx = s * 32 + lane;
      if (idx < k) { od[idx] = ld[r][s]; oi[idx] = li[r][s]; }
    }
  }
}

// one warp per query: merge the per-split top-k lists
__global__ void __launch_bounds__(256)
topk_merge(const float* __restrict__ part_d, const int* __restrict__ part_i,
           int splits, int B, int k, float* __restrict__ out_d,
           int* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  const int gq = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (gq >= B) return;  // warp-uniform
  float ld[2] = {HS_INF, HS_INF};
  int li[2] = {-1, -1};
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
  for (int s = 0; s < 2; ++s) {
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

template <class T>
int launch_topk(const float* q, const float* qn, const T* x, const float* xn,
                const int* row_ids, int B, int N, int D, int n_valid,
                int self_offset, int k, int metric, int splits, float* part_d,
                int* part_i, float* out_d, int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per = (N + splits - 1) / splits;
  const int rows_per_split = (per + BN - 1) / BN * BN;
  const dim3 grid((B + BQ - 1) / BQ, splits);
  const hs::Quant z{};
  if (splits == 1) {
    topk_scan<false, T><<<grid, THREADS, 0, st>>>(
        q, qn, x, xn, z, row_ids, B, N, D, n_valid, self_offset, k, metric,
        rows_per_split, out_d, out_i);
  } else {
    topk_scan<false, T><<<grid, THREADS, 0, st>>>(
        q, qn, x, xn, z, row_ids, B, N, D, n_valid, self_offset, k, metric,
        rows_per_split, part_d, part_i);
    topk_merge<<<(B + 7) / 8, 256, 0, st>>>(part_d, part_i, splits, B, k,
                                            out_d, out_i);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_strata(const float* q, const float* qn, const T* x,
                  const float* xn, const int* row_ids, int B, int N, int D,
                  int sps, int strata, int metric, float* part_d, int* part_i,
                  float* out_d, int* out_id, void* stream) {
  if (strata < 1 || N % strata || sps < 1 || sps > 64 ||
      strata * sps > MAX_SEEDS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + BQ - 1) / BQ, strata);
  topk_scan<false, T><<<grid, THREADS, 0, st>>>(
      q, qn, x, xn, hs::Quant{}, row_ids, B, N, D, N, -1, sps, metric,
      N / strata, part_d, part_i);
  strata_sort<<<B, 256, 0, st>>>(part_d, part_i, row_ids, strata, B, sps,
                                 out_d, out_id);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hs_topk_dist(const float* q, const float* qn, const float* x,
                            const float* xn, const int* row_ids, int B, int N,
                            int D, int n_valid, int self_offset, int k,
                            int metric, int splits, float* part_d,
                            int* part_i, float* out_d, int* out_i,
                            void* stream) {
  return launch_topk(q, qn, x, xn, row_ids, B, N, D, n_valid, self_offset, k,
                     metric, splits, part_d, part_i, out_d, out_i, stream);
}

// the same over bfloat16 rows (a bf16 store or a gather of one)
extern "C" int hs_topk_dist_bf16(const float* q, const float* qn,
                                 const __nv_bfloat16* x, const float* xn,
                                 const int* row_ids, int B, int N, int D,
                                 int n_valid, int self_offset, int k,
                                 int metric, int splits, float* part_d,
                                 int* part_i, float* out_d, int* out_i,
                                 void* stream) {
  return launch_topk(q, qn, x, xn, row_ids, B, N, D, n_valid, self_offset, k,
                     metric, splits, part_d, part_i, out_d, out_i, stream);
}

extern "C" int hs_topk_strata(const float* q, const float* qn, const float* x,
                              const float* xn, const int* row_ids, int B,
                              int N, int D, int sps, int strata, int metric,
                              float* part_d, int* part_i, float* out_d,
                              int* out_id, void* stream) {
  return launch_strata(q, qn, x, xn, row_ids, B, N, D, sps, strata, metric,
                       part_d, part_i, out_d, out_id, stream);
}

// the seed table of a bfloat16 store (a gather of that store's rows)
extern "C" int hs_topk_strata_bf16(const float* q, const float* qn,
                                   const __nv_bfloat16* x, const float* xn,
                                   const int* row_ids, int B, int N, int D,
                                   int sps, int strata, int metric,
                                   float* part_d, int* part_i, float* out_d,
                                   int* out_id, void* stream) {
  return launch_strata(q, qn, x, xn, row_ids, B, N, D, sps, strata, metric,
                       part_d, part_i, out_d, out_id, stream);
}

// Kα in estimate mode: top-k rows of the packed table (N rows; scorer
// arguments as in hs_greedy_descent_quant) by 1-bit estimate, rows whose
// row_ids entry is negative masked
extern "C" int hs_topk_estimate(const uint32_t* qrows, int qstride, int nb,
                                int ex_bits, const float* q_rot,
                                const float* sumq, const float* g_add, int C,
                                const int* row_ids, int B, int N, int k,
                                int splits, float* part_d, int* part_i,
                                float* out_d, int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const hs::Quant z{qrows, qstride, nb, ex_bits, 0, q_rot, sumq, g_add, C};
  const int per = (N + splits - 1) / splits;
  const int rows_per_split = (per + BN - 1) / BN * BN;
  const dim3 grid((B + BQ - 1) / BQ, splits);
  topk_scan<true, float><<<grid, THREADS, 0, st>>>(
      q_rot, nullptr, nullptr, nullptr, z, row_ids, B, N, nb * 32, N, -1, k,
      0, rows_per_split, splits == 1 ? out_d : part_d,
      splits == 1 ? out_i : part_i);
  if (splits > 1)
    topk_merge<<<(B + 7) / 8, 256, 0, st>>>(part_d, part_i, splits, B, k,
                                            out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
