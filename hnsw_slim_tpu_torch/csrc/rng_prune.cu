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
// What kept an earlier design at 7% of that bound: its walk took one visited
// candidate at a time — a dependent device-memory round trip for the
// candidate's row, two block barriers, a few dots a warp — up to C times
// in sequence per row.
//
// Design: the block scores base->candidate distances and sorts (masked
// distance, position) with the short strides in registers (common.cuh
// sort_pairs_shfl). The walk reads no device memory per candidate. Where
// C <= 64 (the conversions' rows) every candidate row is staged in shared
// memory in step 1 — fp32 rows all at once by cp.async, then scored from
// the stage; bf16 rows as they are scored — a kept row is its staged row,
// and a block has 128 threads, so more of these short rows run at once.
// Wider rows (the forward prune's 128, the conversion's hub rows of 1024)
// are scored four rows a warp at a time, their loads in flight together,
// and staged for the walk a ring of 32 sorted candidates at a time, the
// next ring loading (cp.async) while this one is walked; a kept ring row is
// copied to a kept row before its ring is reloaded. The walk takes a ring
// in windows of 16 members (8 for staged rows): (a) each member is tested
// against the kept rows, one warp a member and one lane a kept row
// (common.cuh warp_dots_smem: each row read once, up to the first
// conflict); (b) each member that (a) leaves is tested against the earlier
// ones it leaves; (c) warp 0 resolves the window in walk order from those
// marks: a member is kept if it conflicts with no kept row and no earlier
// kept member, while fewer than m are kept. Three block barriers a window
// instead of two a candidate. Each distance is the one a one-at-a-time
// walk computes: base distances in warp_dot's order, pair distances cn_i +
// cn_j - 2 dot (JAX's formula) or 1 - dot with dot in that walk's
// lane-strided order; so kept rows and counts equal that walk's bit for
// bit. Dots of
// members past the budget are wasted, at most a window's. The host plan
// (graph/heuristic.py prune_plan) picks the stage, the rings and the
// block size.
// keep_all_under_m, the keep_pruned backfill (nearest first, skipping ids
// already kept or seen earlier in the walk) and the packing to out_width
// follow the JAX code.
//
// Guarded mode (guard != nullptr, the SlimZero prune): every valid candidate
// whose guard byte is set is kept whatever the budget, so the kept rows may
// number up to C (m_slots = C). They are kept first, in walk order, because
// the RNG test of an unguarded candidate runs against ALL kept rows,
// guarded ones farther away included. The walk then visits the unguarded
// candidates in ascending distance while fewer than m rows are kept. No
// early-out and no backfill in this mode.
//
// bfloat16 store (hs_rng_prune_bf16; HnswConfig.store_dtype): base and
// candidate rows are read as bf16 (half the gather bytes) and widened to
// fp32 as they are read, so the staged rows in shared memory, the norms
// (vn, computed from the bf16 store) and every sum are fp32 as above.
#include <climits>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int MAX_RING = 64;  // candidate rows staged at a time
constexpr int WIN = 16;       // ring members the walk takes at a time
constexpr int WIN_STAGED = 8;  // the same where every candidate is staged

// NT threads a block (256, or 128 for rows of at most 64 candidates: more
// short rows in flight), 64 registers a thread either way
template <class T, int NT>
__global__ void __launch_bounds__(NT, 1024 / NT)
prune_kernel(const T* __restrict__ vec, const float* __restrict__ vn,
             int D, const int* __restrict__ base_ids,
             const int* __restrict__ cand, const int* __restrict__ m_per_row,
             int C, int Cp, int SD, int m_slots, int keep_all_under_m,
             int keep_pruned, int w, int metric,
             const unsigned char* __restrict__ guard, int* __restrict__ out,
             int* __restrict__ cnt_out, int ring) {
  constexpr int ROWS = NT == 128 ? 8 : 4;  // rows a warp scores at once
  extern __shared__ __align__(16) unsigned char smem[];
  // rows of SD floats (a multiple of 32 plus 8): C staged candidate rows
  // and one more (the base row's); or two rings of `ring` rows, then
  // m_slots kept rows. A kept row is named by its float offset from
  // `rows`: a ring row until its ring is reloaded, then its kept row. The
  // base row sits in the first kept row, free until the walk.

  float* rows = reinterpret_cast<float*>(smem);
  // every candidate fits the ring: step 1 stages candidate column c at
  // ring row c, a kept row is its ring row, and the walk loads nothing
  const bool staged = C <= ring;
  float* sd = rows + (size_t)(staged ? ring + 1 : 2 * ring + m_slots) * SD;
  int* sp = reinterpret_cast<int*>(sd + Cp);         // [Cp]
  int* ul = sp + Cp;                                 // [Cp] guarded walk
  float* kn = reinterpret_cast<float*>(ul + Cp);     // [m_slots]
  int* kid = reinterpret_cast<int*>(kn + m_slots);   // [m_slots]
  int* kof = kid + m_slots;                          // [m_slots]
  unsigned char* kflag = reinterpret_cast<unsigned char*>(kof + m_slots);
  __shared__ int s_nvalid, s_cnt, s_scr[32];
  __shared__ int r_i[MAX_RING], r_off[MAX_RING];
  __shared__ int r_conf[MAX_RING];  // the member hits a kept row
  __shared__ unsigned r_pair[MAX_RING];
  __shared__ float r_cn[MAX_RING], r_di[MAX_RING];

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int* crow = cand + (size_t)b * C;
  const int base = base_ids[b];
  const float bn = vn[base];
  const int m = m_per_row[b];  // kept rows never exceed min(m, C) <= m_slots
  const bool vec4 = hs::can_vec4(vec, D);
  // offset of kept row 0: past the staged rows, or past the two rings
  const int kept0 = (staged ? ring : 2 * ring) * SD;
  const bool fp32v4 = vec4 && std::is_same<T, float>::value;
  const bool async = !staged && fp32v4;  // rings load by cp.async
  // short rows (staged) waste less on (b)'s pairs in smaller windows
  const int win = staged ? WIN_STAGED : WIN;
  float* bvec = rows + kept0;
  for (int i = tid; i < D; i += NT)
    bvec[i] = hs::load1(vec + (size_t)base * D + i);
  for (int c = tid; c < Cp; c += NT) {
    kflag[c] = 0;
    if (c >= C) { sd[c] = HS_INF; sp[c] = INT_MAX; }
  }
  if (tid == 0) s_nvalid = 0;
  __syncthreads();

  // 1. base -> candidate distances; invalid lanes (-1, self) sort last.
  // Staged fp32 rows are all copied into the stage at once (cp.async: one
  // device-memory round trip a row of candidates) and the dots read the
  // stage; otherwise each warp reads ROWS candidates at a time, their rows
  // in flight together (and staged as they are read).
  const bool copy_all = staged && fp32v4;
  if (copy_all) {
    const int q = D >> 2;
    for (int t = tid; t < C * q; t += NT) {
      const int c = t / q, e = (t - c * q) * 4;
      const int id = crow[c];
      if (id >= 0 && id != base)
        hs::cp_async16(rows + (size_t)c * SD + e, vec + (size_t)id * D + e);
    }
    hs::cp_async_commit();
    hs::cp_async_wait_all();
    __syncthreads();
  }
  for (int c0 = warp * ROWS; c0 < C; c0 += (NT / 32) * ROWS) {
    const int nr = min(ROWS, C - c0);
    float s, nrm;  // of row lane / (32 / ROWS)
    if (copy_all) {
      const float* sr[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        sr[r] = rows + (size_t)(c0 + min(r, nr - 1)) * SD;
      s = hs::warp_dot_rows_smem<ROWS>(bvec, sr, nr, D);
    } else {
      const T* src[ROWS];
      float* st[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int id = r < nr ? crow[c0 + r] : -1;
        src[r] = vec + (size_t)(id >= 0 && id != base ? id : base) * D;
        st[r] = staged && r < nr ? rows + (size_t)(c0 + r) * SD : nullptr;
      }
      hs::warp_dot_rows<ROWS>(bvec, src, nr, D, vec4, s, nrm, st);
    }
    const int r = lane / (32 / ROWS);
    const bool writer = lane % (32 / ROWS) == 0 && r < nr;
    const int my_id = writer ? crow[c0 + r] : -1;
    const bool ok = my_id >= 0 && my_id != base;
    if (writer) {
      sd[c0 + r] = ok ? (metric ? 1.f - s : (bn + vn[my_id]) - 2.f * s)
                      : HS_INF;
      sp[c0 + r] = c0 + r;
    }
    const unsigned nv = __ballot_sync(HS_FULL, writer && ok);
    if (lane == 0 && nv) atomicAdd(&s_nvalid, __popc(nv));
  }
  __syncthreads();
  hs::sort_pairs_shfl(sd, sp, Cp);
  const int nvalid = s_nvalid;  // valid lanes are sorted positions [0, nvalid)

  // rows [0, n) of the store, id_of(r), into the stage at dst + r * SD:
  // every load of a batch issued before its stores, so a thread has four
  // (vec4) or eight loads in flight
  auto stage = [&](int n, auto id_of, size_t dst) {
    if (vec4) {
      const int q = D >> 2, tot = n * q;
      for (int t0 = tid; t0 < tot; t0 += 4 * NT) {
        float4 v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int t = t0 + k * NT, r = t / q;
          if (t < tot)
            v[k] = hs::load4(vec + (size_t)id_of(r) * D + (t - r * q) * 4);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int t = t0 + k * NT, r = t / q;
          if (t < tot)
            *reinterpret_cast<float4*>(rows + dst + (size_t)r * SD +
                                       (t - r * q) * 4) = v[k];
        }
      }
    } else {
      const int tot = n * D;
      for (int t0 = tid; t0 < tot; t0 += 8 * NT) {
        float v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int t = t0 + k * NT, r = t / D;
          if (t < tot) v[k] = hs::load1(vec + (size_t)id_of(r) * D + t - r * D);
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int t = t0 + k * NT, r = t / D;
          if (t < tot) rows[dst + (size_t)r * SD + t - r * D] = v[k];
        }
      }
    }
  };

  int cnt = 0, nu = nvalid;
  bool walk = true;  // false: every valid candidate kept, no backfill
  const unsigned char* grow = guard ? guard + (size_t)b * C : nullptr;
  if (guard) {
    // every guarded valid candidate is kept, in walk order, its row loaded
    // straight into its kept row
    // one pass: guarded valid candidates to kid, the others to ul, each in
    // walk order
    int ng = 0, nn = 0;
    const unsigned below = (1u << lane) - 1u;
    for (int c0 = 0; c0 < nvalid; c0 += NT) {
      const int i = c0 + tid;
      const bool g = i < nvalid && grow[sp[i]] != 0;
      const bool u = i < nvalid && !g;
      const unsigned mg = __ballot_sync(HS_FULL, g);
      const unsigned mu = __ballot_sync(HS_FULL, u);
      if (lane == 0) {
        s_scr[warp] = __popc(mg);
        s_scr[16 + warp] = __popc(mu);
      }
      __syncthreads();
      int og = 0, ou = 0, tg = 0, tu = 0;
      for (int x = 0; x < NT / 32; ++x) {
        og += x < warp ? s_scr[x] : 0;
        ou += x < warp ? s_scr[16 + x] : 0;
        tg += s_scr[x];
        tu += s_scr[16 + x];
      }
      if (g) kid[ng + og + __popc(mg & below)] = i;
      if (u) ul[nn + ou + __popc(mu & below)] = i;
      ng += tg;
      nn += tu;
      __syncthreads();
    }
    cnt = ng;
    nu = nn;
    for (int j = tid; j < cnt; j += NT) {
      const int i = kid[j];
      kof[j] = staged ? sp[i] * SD : kept0 + j * SD;
      kn[j] = vn[crow[sp[i]]];
      kflag[i] = 1;
    }
    if (!staged) stage(cnt, [&](int j) { return crow[sp[kid[j]]]; }, kept0);
    __syncthreads();
  } else if (keep_all_under_m && nvalid < m) {
    for (int i = tid; i < nvalid; i += NT) kflag[i] = 1;
    cnt = nvalid;
    nu = 0;
    walk = false;
  }

  // 2. the RNG walk, in sorted order, over rings of staged candidates:
  // each ring's rows are loaded at once (one device-memory round trip a
  // ring, not one a candidate). A ring is walked in windows of WIN
  // members, in three steps with a block barrier after each: (a) every
  // member against every kept row, (b) every member that (a) left against
  // the earlier ones that it left, (c) warp 0 resolves the window in walk
  // order from those marks: a member is kept if it conflicts with no kept
  // row and no earlier kept member, while fewer than m are kept, and its
  // ring row becomes a kept row. A conflict is a pair distance (cn + kn -
  // 2 dot, JAX's formula, or 1 - dot) below the member's own; every dot is
  // bit-equal to the one-candidate-at-a-time walk's.
  // the ring form walks one ring while the next one's rows load into the
  // other (cp.async for fp32 rows, no registers held; bf16 rows widen
  // through registers)
  auto ring_id = [&](int u, int r) {
    return crow[sp[guard ? ul[u + r] : u + r]];
  };
  auto load_ring = [&](int u, int buf) {
    const int n = min(ring, nu - u);
    if (async) {
      const int q = D >> 2;
      for (int t = tid; t < n * q; t += NT) {
        const int r = t / q, e = (t - r * q) * 4;
        hs::cp_async16(rows + (size_t)(buf * ring + r) * SD + e,
                       vec + (size_t)ring_id(u, r) * D + e);
      }
      hs::cp_async_commit();
    } else {
      stage(n, [&](int r) { return ring_id(u, r); },
            (size_t)buf * ring * SD);
    }
  };
  if (!staged && nu > 0 && cnt < m) load_ring(0, 0);
  for (int u0 = 0, buf = 0; u0 < nu && cnt < m; u0 += ring, buf ^= 1) {
    const int rn = min(ring, nu - u0);
    if (tid < rn) {
      const int i = guard ? ul[u0 + tid] : u0 + tid;
      r_i[tid] = i;
      r_off[tid] = (staged ? sp[i] : buf * ring + tid) * SD;
      r_di[tid] = sd[i];
      r_cn[tid] = vn[crow[sp[i]]];
    }
    if (async) hs::cp_async_wait_all();
    __syncthreads();
    if (!staged && u0 + ring < nu) {
      // the other ring (the one before) takes the next one's rows: its
      // kept rows move to their kept rows first
      const int lo = (buf ^ 1) * ring * SD, hi = lo + ring * SD;
      if (u0) {
        for (int t = tid; t < cnt * D; t += NT) {
          const int j = t / D, e = t - j * D;
          if (kof[j] >= lo && kof[j] < hi)
            rows[kept0 + (size_t)j * SD + e] = rows[kof[j] + e];
        }
        __syncthreads();
        for (int j = tid; j < cnt; j += NT)
          if (kof[j] >= lo && kof[j] < hi) kof[j] = kept0 + j * SD;
      }
      load_ring(u0 + ring, buf ^ 1);
      if (u0) __syncthreads();
    }
    for (int a0 = 0; a0 < rn && cnt < m; a0 += win) {
      const int wn = min(win, rn - a0);
      // (a) each member against the kept rows: one warp a member, one lane
      // a row, 8 rows at a time (common.cuh warp_dots_smem), up to the
      // first conflict
      for (int x = warp; x < wn; x += (NT / 32)) {
        const int r = a0 + x;
        bool conf = false;
        for (int c0 = 0; c0 < cnt && !conf; c0 += 8) {
          const int nb = min(8, cnt - c0);
          const float dot = hs::warp_dots_smem(
              rows + r_off[r], rows, lane < nb ? kof[c0 + lane] : 0, nb, D);
          bool hit = false;
          if (lane < nb) {
            const float pd = metric ? 1.f - dot
                                    : (r_cn[r] + kn[c0 + lane]) - 2.f * dot;
            hit = pd < r_di[r];
          }
          conf = __any_sync(HS_FULL, hit);
        }
        if (lane == 0) r_conf[r] = conf;
      }
      __syncthreads();
      // (b) the members that survive (a) against the survivors before
      // them: one warp a survivor, one lane an earlier survivor
      const unsigned surv = __ballot_sync(HS_FULL, lane < wn &&
                                                       !r_conf[a0 + lane]);
      for (int k = warp; k < __popc(surv); k += (NT / 32)) {
        const int x = __fns(surv, 0, k + 1);
        const unsigned before = surv & ((1u << x) - 1u);
        const int y = lane < __popc(before) ? __fns(before, 0, lane + 1)
                                            : -1;
        const float dot = hs::warp_dots_smem(
            rows + r_off[a0 + x], rows, r_off[a0 + (y < 0 ? 0 : y)],
            __popc(before), D);
        bool hit = false;
        if (y >= 0) {
          const float pd = metric ? 1.f - dot
                                  : (r_cn[a0 + x] + r_cn[a0 + y]) - 2.f * dot;
          hit = pd < r_di[a0 + x];
        }
        const unsigned pm = __reduce_or_sync(HS_FULL, hit ? 1u << y : 0u);
        if (lane == 0) r_pair[a0 + x] = pm;
      }
      __syncthreads();
      // (c) warp 0 takes the window in walk order: a survivor is kept if no
      // earlier kept member conflicts with it, while fewer than m are kept
      if (warp == 0) {
        const unsigned pr = (surv >> lane) & 1u ? r_pair[a0 + lane] : 0u;
        unsigned col = 0u;  // lane y: the survivors that y rules out
        for (int yy = 0; yy < wn; ++yy) {
          const unsigned bm = __ballot_sync(HS_FULL, (pr >> yy) & 1u);
          if (lane == yy) col = bm;
        }
        unsigned cand_set = surv, keep = 0u;
        for (int room = m - cnt; cand_set && room > 0; --room) {
          const int yy = __ffs(cand_set) - 1;
          keep |= 1u << yy;
          cand_set &= ~(1u << yy);
          cand_set &= ~__shfl_sync(HS_FULL, col, yy);
        }
        if ((keep >> lane) & 1u) {
          const int slot = cnt + __popc(keep & ((1u << lane) - 1u));
          const int r = a0 + lane, i = r_i[r];
          kof[slot] = r_off[r];
          kn[slot] = r_cn[r];
          kid[slot] = guard ? i : crow[sp[i]];
          kflag[i] = 1;
        }
        if (lane == 0) s_cnt = cnt + __popc(keep);
      }
      __syncthreads();
      cnt = s_cnt;
    }
  }
  if (async) hs::cp_async_wait_all();  // a ring may still be loading
  __syncthreads();
  if (walk && !guard && keep_pruned && cnt < m) {
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
  for (int t = written + tid; t < w; t += NT) orow[t] = -1;
  if (tid == 0) cnt_out[b] = cnt;
}

template <class T, int NT>
int launch_nt(const T* vec, const float* vn, int D, const int* base_ids,
              const int* cand, const int* m_per_row, int B, int C,
              int m_slots, int keep_all_under_m, int keep_pruned,
              int out_width, int metric, const unsigned char* guard, int ring,
              int smem, int* out, int* cnt, void* stream) {
  const int SD = (D + 31) / 32 * 32 + 8;
  const int Cp = hs::next_pow2(C < 32 ? 32 : C);
  cudaError_t err = cudaFuncSetAttribute(
      prune_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  prune_kernel<T, NT><<<B, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      vec, vn, D, base_ids, cand, m_per_row, C, Cp, SD, m_slots,
      keep_all_under_m, keep_pruned, out_width, metric, guard, out, cnt,
      ring);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_prune(const T* vec, const float* vn, int D, const int* base_ids,
                 const int* cand, const int* m_per_row, int B, int C,
                 int m_slots, int keep_all_under_m, int keep_pruned,
                 int out_width, int metric, const unsigned char* guard,
                 int ring, int threads, int smem, int* out, int* cnt,
                 void* stream) {
  if (ring < 1 || ring > MAX_RING || m_slots < 1 ||
      (threads != 128 && threads != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  return (threads == 128 ? launch_nt<T, 128> : launch_nt<T, 256>)(
      vec, vn, D, base_ids, cand, m_per_row, B, C, m_slots, keep_all_under_m,
      keep_pruned, out_width, metric, guard, ring, smem, out, cnt, stream);
}

}  // namespace

extern "C" int hs_rng_prune(const float* vec, const float* vn, int D,
                            const int* base_ids, const int* cand,
                            const int* m_per_row, int B, int C, int m_max,
                            int keep_all_under_m, int keep_pruned,
                            int out_width, int metric,
                            const unsigned char* guard, int ring,
                            int threads, int smem, int* out, int* cnt,
                            void* stream) {
  return launch_prune(vec, vn, D, base_ids, cand, m_per_row, B, C, m_max,
                      keep_all_under_m, keep_pruned, out_width, metric, guard,
                      ring, threads, smem, out, cnt, stream);
}

// the same over a bfloat16 store (rows widened to fp32 as they are read)
extern "C" int hs_rng_prune_bf16(const __nv_bfloat16* vec, const float* vn,
                                 int D, const int* base_ids, const int* cand,
                                 const int* m_per_row, int B, int C,
                                 int m_max, int keep_all_under_m,
                                 int keep_pruned, int out_width, int metric,
                                 const unsigned char* guard, int ring,
                                 int threads, int smem, int* out, int* cnt,
                                 void* stream) {
  return launch_prune(vec, vn, D, base_ids, cand, m_per_row, B, C, m_max,
                      keep_all_under_m, keep_pruned, out_width, metric, guard,
                      ring, threads, smem, out, cnt, stream);
}
