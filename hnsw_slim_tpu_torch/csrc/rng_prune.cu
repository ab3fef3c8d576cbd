// Kγ rng_prune: relative-neighborhood (RNG) heuristic prune, one block per
// base node.
//
// Replaces (JAX): hnsw_slim_tpu/graph/heuristic.py _prune_batch_impl with
// _sorted_prune_inputs, _prune_one and _pack_kept (prune_batch / prune_all),
// which the NND build and the Slim conversion run over every node, and
// _prune_batch_guarded_impl with _prune_one_guarded (prune_batch_guarded),
// which the SlimZero conversion runs.
//
// What bounds it: the JAX program materializes all C x C candidate pair
// distances ([chunk, C, C] in HBM; conversion hub rows reach C >= 1024, a
// 4 MB tile per row that no 227 KB shared memory holds). The walk itself
// needs far less: candidate i is tested only against the <= m rows already
// kept. Work per row is one D-float gather per candidate for the base
// distance, then, along the walk, one dot per (visited, kept) pair.
//
// Design: the block scores base->candidate distances (one warp per
// candidate, norms from vn as the JAX code does), bitonic-sorts
// (masked distance, position) in shared memory, then walks the sorted
// candidates in order. Each visited candidate's vector is loaded straight
// into the next kept slot in shared memory; warps test it against the kept
// rows (cn_i + cn_j - 2 dot, JAX's formula) and a block-wide OR decides —
// keeping it costs no copy. The walk stops when m rows are kept.
// keep_all_under_m, the keep_pruned backfill (nearest first, skipping ids
// already kept or seen earlier in the walk) and the packing to out_width
// follow the JAX code.
//
// Guarded mode (guard != nullptr, the SlimZero prune): every valid candidate
// whose guard byte is set is kept whatever the budget, so the kept rows may
// number up to C and the stage is sized by C. They are staged first, in
// walk order, because the RNG test of an unguarded candidate runs against
// ALL kept rows, guarded ones farther away included. The walk then visits
// the unguarded candidates in ascending distance while fewer than m rows
// are kept. No early-out and no backfill in this mode.
//
// bfloat16 store (hs_rng_prune_bf16; HnswConfig.store_dtype): base and
// candidate rows are read as bf16 (half the gather bytes) and widened to
// fp32 as they are read, so the staged kept rows in shared memory, the norms
// (vn, computed from the bf16 store) and every sum are fp32 as above.
#include <climits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;

template <class T>
__global__ void __launch_bounds__(THREADS)
prune_kernel(const T* __restrict__ vec, const float* __restrict__ vn,
             int D, const int* __restrict__ base_ids,
             const int* __restrict__ cand, const int* __restrict__ m_per_row,
             int C, int Cp, int Dp, int m_slots, int keep_all_under_m,
             int keep_pruned, int w, int metric,
             const unsigned char* __restrict__ guard, int* __restrict__ out,
             int* __restrict__ cnt_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* bvec = reinterpret_cast<float*>(smem);
  float* kvec = bvec + Dp;                     // [m_slots][Dp]
  float* sd = kvec + (size_t)m_slots * Dp;     // [Cp]
  int* sp = reinterpret_cast<int*>(sd + Cp);   // [Cp]
  float* kn = reinterpret_cast<float*>(sp + Cp);  // [m_slots]
  int* kid = reinterpret_cast<int*>(kn + m_slots);  // [m_slots]
  unsigned char* kflag = reinterpret_cast<unsigned char*>(kid + m_slots);
  __shared__ int s_nvalid, s_cnt, s_scr[32];

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int* crow = cand + (size_t)b * C;
  const int base = base_ids[b];
  const float bn = vn[base];
  const int m = m_per_row[b];  // kept rows never exceed min(m, C) <= m_slots
  const bool vec4 = hs::can_vec4(vec, D);
  for (int i = tid; i < D; i += THREADS)
    bvec[i] = hs::load1(vec + (size_t)base * D + i);
  for (int c = tid; c < Cp; c += THREADS) {
    kflag[c] = 0;
    if (c >= C) { sd[c] = HS_INF; sp[c] = INT_MAX; }
  }
  if (tid == 0) s_nvalid = 0;
  __syncthreads();

  // base -> candidate distances; invalid lanes (-1, self) sort last
  for (int c = warp; c < C; c += NW) {
    const int id = crow[c];
    const bool valid = id >= 0 && id != base;
    float dist = HS_INF;
    if (valid) {
      const float dot =
          hs::warp_dot(bvec, vec + (size_t)id * D, D, vec4, nullptr);
      dist = metric ? 1.f - dot : (bn + vn[id]) - 2.f * dot;
    }
    if (lane == 0) {
      sd[c] = valid ? dist : HS_INF;
      sp[c] = c;
      if (valid) atomicAdd(&s_nvalid, 1);
    }
  }
  __syncthreads();
  hs::sort_pairs(sd, sp, Cp);
  const int nvalid = s_nvalid;  // valid lanes are sorted positions [0, nvalid)

  int cnt = 0;
  if (guard) {
    // pass 1: stage every guarded valid candidate, in walk order
    const unsigned char* grow = guard + (size_t)b * C;
    cnt = hs::compact(
        nvalid,
        [&](int i, int& v) {
          v = i;
          return grow[sp[i]] != 0;
        },
        kid, s_scr, m_slots);
    for (int j = warp; j < cnt; j += NW) {
      const int i = kid[j];
      const int id = crow[sp[i]];
      for (int e = lane; e < D; e += 32)
        kvec[(size_t)j * Dp + e] = hs::load1(vec + (size_t)id * D + e);
      if (lane == 0) { kn[j] = vn[id]; kflag[i] = 1; }
    }
    __syncthreads();
    // pass 2: unguarded candidates under the RNG rule against all kept rows
    for (int i = 0; i < nvalid && cnt < m; ++i) {
      if (kflag[i]) continue;  // block-uniform: kflag is in shared memory
      const int id = crow[sp[i]];
      const float di = sd[i];
      float* cv = kvec + (size_t)cnt * Dp;
      for (int e = tid; e < D; e += THREADS)
        cv[e] = hs::load1(vec + (size_t)id * D + e);
      const float cn = vn[id];
      __syncthreads();
      bool conflict = false;
      for (int j = warp; j < cnt; j += NW) {
        const float dot = hs::warp_dot_smem(cv, kvec + (size_t)j * Dp, D);
        const float pd = metric ? 1.f - dot : (cn + kn[j]) - 2.f * dot;
        conflict |= pd < di;
      }
      if (!__syncthreads_or(conflict)) {
        if (tid == 0) { kn[cnt] = cn; kflag[i] = 1; }
        ++cnt;
      }
    }
  } else if (keep_all_under_m && nvalid < m) {
    for (int i = tid; i < nvalid; i += THREADS) kflag[i] = 1;
    cnt = nvalid;
  } else {
    for (int i = 0; i < nvalid && cnt < m; ++i) {
      const int id = crow[sp[i]];
      const float di = sd[i];
      float* cv = kvec + (size_t)cnt * Dp;
      for (int e = tid; e < D; e += THREADS)
        cv[e] = hs::load1(vec + (size_t)id * D + e);
      const float cn = vn[id];
      __syncthreads();
      bool conflict = false;
      for (int j = warp; j < cnt; j += NW) {
        const float dot = hs::warp_dot_smem(cv, kvec + (size_t)j * Dp, D);
        const float pd = metric ? 1.f - dot : (cn + kn[j]) - 2.f * dot;
        conflict |= pd < di;
      }
      if (!__syncthreads_or(conflict)) {
        if (tid == 0) { kn[cnt] = cn; kid[cnt] = id; kflag[i] = 1; }
        ++cnt;
      }
    }
    __syncthreads();
    if (keep_pruned && cnt < m) {
      // backfill rejected candidates, nearest first, up to the budget
      if (warp == 0) {
        const int need = m - cnt;
        int taken = 0;
        for (int i0 = 0; i0 < nvalid && taken < need; i0 += 32) {
          const int i = i0 + lane;
          bool ok = i < nvalid && !kflag[i];
          if (ok) {
            const int id = crow[sp[i]];
            for (int j = 0; j < cnt && ok; ++j) ok = kid[j] != id;
            for (int j = 0; j < i && ok; ++j) ok = crow[sp[j]] != id;
          }
          const unsigned msk = __ballot_sync(HS_FULL, ok);
          const int r = __popc(msk & ((1u << lane) - 1u));
          if (ok && taken + r < need) kflag[i] = 1;
          taken += __popc(msk);
        }
        if (lane == 0) s_cnt = cnt + min(taken, need);
      }
      __syncthreads();
      cnt = s_cnt;
    }
  }
  __syncthreads();

  // pack kept lanes in walk order, -1 beyond
  int* orow = out + (size_t)b * w;
  const int written = hs::compact(
      nvalid,
      [&](int i, int& v) {
        v = crow[sp[i]];
        return kflag[i] != 0;
      },
      orow, s_scr, w);
  for (int t = written + tid; t < w; t += THREADS) orow[t] = -1;
  if (tid == 0) cnt_out[b] = cnt;
}

template <class T>
int launch_prune(const T* vec, const float* vn, int D, const int* base_ids,
                 const int* cand, const int* m_per_row, int B, int C,
                 int m_max, int keep_all_under_m, int keep_pruned,
                 int out_width, int metric, const unsigned char* guard,
                 int* out, int* cnt, void* stream) {
  const int Dp = (D + 3) / 4 * 4;
  const int Cp = hs::next_pow2(C < 1 ? 1 : C);
  const int m_slots = m_max < 1 ? 1 : m_max;
  const size_t smem = sizeof(float) * Dp * (1 + (size_t)m_slots) +
                      2 * sizeof(int) * Cp + 2 * sizeof(int) * m_slots + Cp;
  cudaError_t err = cudaFuncSetAttribute(
      prune_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  prune_kernel<T><<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      vec, vn, D, base_ids, cand, m_per_row, C, Cp, Dp, m_slots,
      keep_all_under_m, keep_pruned, out_width, metric, guard, out, cnt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hs_rng_prune(const float* vec, const float* vn, int D,
                            const int* base_ids, const int* cand,
                            const int* m_per_row, int B, int C, int m_max,
                            int keep_all_under_m, int keep_pruned,
                            int out_width, int metric,
                            const unsigned char* guard, int* out, int* cnt,
                            void* stream) {
  return launch_prune(vec, vn, D, base_ids, cand, m_per_row, B, C, m_max,
                      keep_all_under_m, keep_pruned, out_width, metric, guard,
                      out, cnt, stream);
}

// the same over a bfloat16 store (rows widened to fp32 as they are read)
extern "C" int hs_rng_prune_bf16(const __nv_bfloat16* vec, const float* vn,
                                 int D, const int* base_ids, const int* cand,
                                 const int* m_per_row, int B, int C,
                                 int m_max, int keep_all_under_m,
                                 int keep_pruned, int out_width, int metric,
                                 const unsigned char* guard, int* out,
                                 int* cnt, void* stream) {
  return launch_prune(vec, vn, D, base_ids, cand, m_per_row, B, C, m_max,
                      keep_all_under_m, keep_pruned, out_width, metric, guard,
                      out, cnt, stream);
}
