// Kβ beam_search: the Slim base-layer beam, one block per query.
//
// Replaces (JAX): hnsw_slim_tpu/graph/search.py beam_level_scored with
// make_dense_fetch / make_rank_fetch / make_chal_fetch, make_exact_scorer,
// merge_sorted and the FilterTrack branches (the lax.while_loop lockstep beam
// of every beamed level of chal_search and level_search).
//
// What bounds it: the row gathers — every candidate costs one random
// D*4-byte vector read (512 B at d=128) plus a 4*W-byte neighbor row per pop;
// the arithmetic (one dot per candidate) is small. What kept an earlier
// design of this kernel at 27% of that bound at build shape was block-barrier
// latency — three full bitonic sorts an iteration, about 115 barriers — and
// one random row in flight per warp.
//
// Design: the query's sorted buffer of P <= 512 (distance, id, checked)
// entries stays in shared memory for the whole search, so no HBM traffic
// beyond the gathers; each query stops on its own (no lockstep, so no
// straggler compaction). One iteration:
//   1. warp 0 finds the E best unchecked entries within the ef_eff window
//      that are not worse than the window's last distance (the reference's
//      termination rule on the single best unchecked entry);
//   2. the E neighbor rows are read; an id already in the buffer is dropped
//      by one probe of the buffer's id set (common.cuh set_has: open
//      addressing in shared memory, a generation tag per slot, so the set
//      is rebuilt by the merge of step 4 without a clearing pass). The
//      reference keeps the first cw lanes of the sorted ids (2*cw under
//      the pre-window rule, 2*cw < E*W): only when more lanes are left
//      does a k-th smallest select (common.cuh select_kth: one 256-bin
//      radix pass, then one warp over the chosen bin) cut them at that
//      id. Repeats are dropped as they fail to enter the set, and the
//      pre-window's pool is cut to its cw smallest by a second select.
//      No sort, no binary search;
//   3. each warp gathers four candidates at a time, all four rows in flight
//      (common.cuh warp_dot_rows), and computes q.x and |x|^2 (|x|^2 from
//      the row, as the JAX scorer does) in warp_dot's order, so every
//      distance is bit-equal to a one-row-at-a-time dot;
//   4. candidates are sorted by (distance, id) (strides under 32 in
//      registers, common.cuh sort_pairs_shfl) and merged into the buffer
//      by rank (each entry finds its output slot by binary search in the
//      other list), keeping the P smallest; buffer entries precede
//      candidates on equal distance, as JAX's stable sort merge does.
// About 20 block barriers an iteration at build shape where the sorting
// design waited at about 115; every result, hops and dcomp count is the
// same.
// The neighbor rows come through one of three fetch forms (common.cuh
// Fetch): dense rows, rows behind a rank indirection, or CHAL slices.
//
// Filtered mode (allowed != nullptr, JAX FilterTrack): the block keeps a
// second sorted list of P (distance, id), the result track, which holds
// allowed nodes only. After scoring, candidates that are allowed and not yet
// in the track (a probe of the track's id set) are merged into
// it by rank, track entries first on equal distance. The pop bound and the
// stop rule read the track's ef_eff-th distance instead of the buffer's, so
// a query keeps expanding until ef_eff allowed results are held (or nothing
// is left unchecked). The track comes in and goes out whole, so a caller can
// carry it across levels beside the buffer. At P = 512, E = 8, W = 60 the
// block needs 38 KB of shared memory unfiltered (16 KB of it the id set)
// and 60 KB filtered.
//
// Tag mode (tags != nullptr; the filtered mode's other predicate): each
// node has one u32 tag word (tags[N], resident on the card) and each query
// one u32 need word (need[B], held in a register), and a node is allowed
// for the query iff (tags[id] & need) == need. One-hot tags make that an
// equality test on a label, for up to 32 labels; a batch mixes predicates
// freely, since every block searches its own query. Everything else is the
// filtered mode's. In both, admit[b] counts the scored candidates that
// passed the predicate (whether or not they were new to the track).
//
// iters (nullable, i32[B]): a per-query iteration cap in place of
// max_iters (a filtered query's cap grows with its predicate's
// selectivity).
//
// Quantized mode (QUANT; JAX: index/slimq.py _slimq_search_jit's score
// closure over pack_code_rows with quant/estimator.py est_dist_1bit /
// est_dist_ex, and its pop_hook): step 3 scores a candidate by its RaBitQ
// estimate from one packed code row (84 B at P = 128 and 4 bits instead of
// a 512 B vector; the 1-bit or the full-code estimate), with the rotated
// query and the query's g_add row in shared memory. A warp scores ROWS
// candidates at a time from one gather of their code rows
// (common.cuh quant_score_rows): every word their estimates read — bit
// planes, factors, cluster id — is issued before any sum, so a group costs
// one memory round trip, as the exact mode's four vectors do (a block's
// iteration waits on its slowest warp's chain of such trips); the words go
// through the warp's stage in shared memory (4 KB a block), from which each
// lane reads a word of all four rows with one 16-byte broadcast load. A row
// of more than QUANT_ROUND_WORDS words (wide P, many ex bits) takes a round
// per QUANT_ROUND_WORDS; at P = 128 it is one. Every estimate is bit-equal
// to the one-row scorer's. With a
// rerank track (common.cuh PopTrack) the block also keeps the raw query and
// a sorted list of kk (exact distance, id): after step 1 one warp per pop
// reads the popped node's raw vector (the one 4 D-byte gather per pop) and
// computes |q|^2 + |x|^2 - 2 q.x (or 1 - q.x); pops already in the track are
// dropped, and the rest merge into it by rank — track entries first on equal
// distance, pops in pop order, as the reference's stable sort by distance
// alone. Rerank distances are not counted in dcomp. The track adds
// 16 kk + 4 D bytes of shared memory (under 1 KB at kk = 16, D = 128).
//
// bfloat16 store (hs_beam_search_bf16; HnswConfig.store_dtype): step 3 reads
// a candidate with one 8-byte load a lane (256 B at d=128 instead of 512 B)
// and widens it to fp32 in registers (common.cuh load4); the query, the
// norms and the sums stay fp32, so every rule above is unchanged.
#include <algorithm>
#include <climits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;  // select_kth needs exactly 256
constexpr int NW = THREADS / 32;
constexpr int MAX_POP = 64;
// candidate rows a warp has in flight (step 3), vectors or code rows (8 code
// rows spill registers at 4 blocks an SM)
constexpr int ROWS = 4;

template <bool QUANT, class T>
__global__ void __launch_bounds__(THREADS, 4)
beam_kernel(const T* __restrict__ vec, int D, const hs::Fetch f,
            const hs::Quant z, const hs::PopTrack t, int Cp, int Drp, int KKp,
            const float* __restrict__ q, const float* __restrict__ qn,
            const float* __restrict__ seed_d, const int* __restrict__ seed_id,
            int S, int P, int ef_eff, int E, int cw, int max_iters, int k,
            int metric, int Dp, int EWp, int Hs, int Ht, int CWp,
            const unsigned char* __restrict__ allowed,
            const float* __restrict__ trk_d_in,
            const int* __restrict__ trk_id_in, float* __restrict__ out_d,
            int* __restrict__ out_id, int* __restrict__ hops_out,
            int* __restrict__ dcomp_out, float* __restrict__ trk_d_out,
            int* __restrict__ trk_id_out, const unsigned* __restrict__ tags,
            const unsigned* __restrict__ need, const int* __restrict__ iters,
            int* __restrict__ admit_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the id sets: the buffer's (and the iteration's candidates'), and in
  // filtered mode the track's
  unsigned long long* tab = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* ttab = tab + Hs;
  // exact: the query (D floats). Quantized: q_rot (D = 32 nb), the g_add
  // row (Cp), and with a rerank track the raw query (Drp) and the track with
  // its double buffer (4 KKp); all three sizes are 0 when unused
  float* qs = reinterpret_cast<float*>(ttab + Ht);
  float* ga = qs + Dp;
  float* qraw = ga + Cp;
  float* rd = qraw + Drp;
  int* ri = reinterpret_cast<int*>(rd + KKp);
  float* nrd = reinterpret_cast<float*>(ri + KKp);
  int* nri = reinterpret_cast<int*>(nrd + KKp);
  float* bd = reinterpret_cast<float*>(nri + KKp);
  int* bi = reinterpret_cast<int*>(bd + P);
  int* bc = bi + P;
  float* nd = reinterpret_cast<float*>(bc + P);
  int* ni = reinterpret_cast<int*>(nd + P);
  int* nc = ni + P;
  int* raw = nc + P;
  int* lst = raw + EWp;
  int* hist = lst + EWp;
  float* cd = reinterpret_cast<float*>(hist + 256);
  int* ci = reinterpret_cast<int*>(cd + CWp);
  // filtered mode only: the track and its double buffer, and the allowed
  // new candidates (index, distance, id)
  float* td = reinterpret_cast<float*>(ci + CWp);
  int* ti = reinterpret_cast<int*>(td + P);
  float* ntd = reinterpret_cast<float*>(ti + P);
  int* nti = reinterpret_cast<int*>(ntd + P);
  int* fx = nti + P;
  float* fd = reinterpret_cast<float*>(fx + CWp);
  int* fi = reinterpret_cast<int*>(fd + CWp);
  __shared__ int s_pos[MAX_POP], s_popid[MAX_POP], s_npop, s_scr[32];
  __shared__ int s_sel[16], s_n, s_or, s_tk, s_adm;
  __shared__ const int* s_row[MAX_POP];
  __shared__ int s_rowcnt[MAX_POP];
  __shared__ float s_ed[MAX_POP];  // the pops' exact distances (rerank)
  // quantized: each warp's stage of gathered code words (step 3)
  uint32_t* stage = nullptr;
  if constexpr (QUANT) {
    __shared__ __align__(16) uint32_t s_stage[NW * hs::QUANT_ROUND_WORDS *
                                              ROWS];
    stage = s_stage + (threadIdx.x >> 5) * hs::QUANT_ROUND_WORDS * ROWS;
  }

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const bool vec4 = hs::can_vec4(vec, D);
  const bool track = QUANT && t.data != nullptr;
  // filtered: by the allowed flags, or by tag words against the need word
  const bool filt = allowed != nullptr || tags != nullptr;
  const unsigned nw = tags ? need[b] : 0u;
  const int cap = iters ? iters[b] : max_iters;
  if (tid == 0) s_adm = 0;
  const float qnv = QUANT ? z.sumq[b] : qn[b];  // quantized: sum(q_rot)
  const float qnr = (track && !metric) ? t.qn_raw[b] : 0.f;
  const bool rvec4 = hs::can_vec4(t.data, t.D);
  const unsigned hmask = Hs - 1, tmask = Ht - 1;
  const float* qsrc = QUANT ? z.q_rot : q;
  for (int i = tid; i < Hs + Ht; i += THREADS) tab[i] = 0ull;
  for (int i = tid; i < 256; i += THREADS) hist[i] = 0;
  for (int i = tid; i < D; i += THREADS) qs[i] = qsrc[(size_t)b * D + i];
  if (QUANT)
    for (int i = tid; i < z.C; i += THREADS)
      ga[i] = z.g_add[(size_t)b * z.C + i];
  if (track) {
    for (int i = tid; i < t.D; i += THREADS)
      qraw[i] = t.q_raw[(size_t)b * t.D + i];
    for (int j = tid; j < t.kk; j += THREADS) {
      rd[j] = t.d_in[(size_t)b * t.kk + j];
      ri[j] = t.id_in[(size_t)b * t.kk + j];
    }
  }
  for (int j = tid; j < P; j += THREADS) {
    bd[j] = j < S ? seed_d[(size_t)b * S + j] : HS_INF;
    bi[j] = j < S ? seed_id[(size_t)b * S + j] : -1;
    bc[j] = 0;
    if (filt) {
      td[j] = trk_d_in[(size_t)b * P + j];
      ti[j] = trk_id_in[(size_t)b * P + j];
    }
  }
  __syncthreads();
  // generation 1 of the sets: the seeds, the incoming track
  for (int j = tid; j < P; j += THREADS) {
    if (bi[j] >= 0) hs::set_insert(tab, hmask, 1u, bi[j]);
    if (filt && ti[j] >= 0) hs::set_insert(ttab, tmask, 1u, ti[j]);
  }
  const int W = f.W;
  const int ew = E * W;
  const bool prewindow = E > 1 && 2 * cw < ew;
  int hops = 0, dcomp = 0, admit = 0;
  __syncthreads();

  for (int it = 0; it < cap; ++it) {
    const unsigned gen = it + 1;  // the sets' generation this iteration
    // 1. pops: first E unchecked entries of the window within the bound
    if (warp == 0) {
      const float bound = filt ? td[ef_eff - 1] : bd[ef_eff - 1];
      int cnt = 0;
      bool stop = false;
      for (int base = 0; base < ef_eff && !stop; base += 32) {
        const int j = base + lane;
        unsigned m = __ballot_sync(
            HS_FULL, j < ef_eff && bc[j] == 0 && bi[j] >= 0);
        while (m) {
          const int jj = base + __ffs(m) - 1;
          m &= m - 1;
          if (bd[jj] > bound) { stop = true; break; }
          if (lane == 0) s_pos[cnt] = jj;
          if (++cnt == E) { stop = true; break; }
        }
      }
      if (lane == 0) {
        s_npop = cnt;
        s_n = 0;
        s_or = 0;
        s_tk = 0;
      }
    }
    __syncthreads();
    const int npop = s_npop;
    if (npop == 0) break;  // no unchecked entry, or the best is past bound
    if (tid < npop) {
      const int j = s_pos[tid];
      bc[j] = 1;
      s_popid[tid] = bi[j];
      int rc;
      s_row[tid] = hs::fetch_row(f, bi[j], rc);
      s_rowcnt[tid] = rc;
    }
    hops += npop;
    __syncthreads();

    // 1b. rerank track: exact distance of every pop (one warp per pop),
    // pops already in the track dropped, the rest merged in by rank
    if (track) {
      for (int c = warp; c < npop; c += NW) {
        const int id = s_popid[c];
        float nrm;
        const float dot = hs::warp_dot(qraw, t.data + (size_t)id * t.D, t.D,
                                       rvec4, &nrm);
        bool dup = false;
        for (int j = lane; j < t.kk; j += 32) dup |= ri[j] == id;
        dup = __any_sync(HS_FULL, dup);
        if (lane == 0)
          s_ed[c] = dup ? HS_INF
                        : (metric ? 1.f - dot : (qnr + nrm) - 2.f * dot);
      }
      __syncthreads();
      for (int j = tid; j < t.kk; j += THREADS) {
        const float v = rd[j];
        int pos = j;
        for (int c = 0; c < npop; ++c) pos += s_ed[c] < v;
        if (pos < t.kk) { nrd[pos] = v; nri[pos] = ri[j]; }
      }
      for (int c = tid; c < npop; c += THREADS) {
        const float v = s_ed[c];
        int pos = hs::count_at_or_below(rd, t.kk, v);
        for (int c2 = 0; c2 < npop; ++c2)
          pos += s_ed[c2] < v || (s_ed[c2] == v && c2 < c);
        if (pos < t.kk) { nrd[pos] = v; nri[pos] = isinf(v) ? -1 : s_popid[c]; }
      }
      __syncthreads();
      float* xd = rd; rd = nrd; nrd = xd;
      int* xi = ri; ri = nri; nri = xi;
    }

    // 2. candidate ids. The reference sorts the E*W fetched ids and keeps
    // the first cw sorted lanes (the first 2*cw under the pre-window rule)
    // that are valid, new to the buffer and not repeats. The same set
    // without a sort: buffer ids are dropped by a probe of the buffer's
    // set; only when more than cw (2*cw) lanes are left does a k-th
    // smallest select (with multiplicity, as the sorted lanes count) cut
    // them at the cw-th (2*cw-th) smallest id; repeats are dropped as they
    // fail to enter the set (E = 1 keeps them, as the reference does).
    int nv = 0;
    unsigned orv = 0;
    for (int c = tid; c < EWp; c += THREADS) {
      int v = hs::BIG;
      if (c < npop * W) {
        const int p = c / W, lane_c = c - p * W;
        const int id = lane_c < s_rowcnt[p] ? __ldg(s_row[p] + lane_c) : -1;
        if (id >= 0 && (prewindow || !hs::set_has(tab, hmask, gen, id)))
          v = id;
      }
      raw[c] = v;
      if (v != hs::BIG) { ++nv; orv |= v; }
    }
    nv = __reduce_add_sync(HS_FULL, nv);
    orv = __reduce_or_sync(HS_FULL, orv);
    if (lane == 0 && nv) {
      atomicAdd(&s_n, nv);
      atomicOr(&s_or, static_cast<int>(orv));
    }
    __syncthreads();
    const int nbits = 32 - __clz(s_or);
    const int lim = prewindow ? 2 * cw : cw;
    if (s_n > lim) {
      int tk;
      const int cut = hs::select_kth(raw, EWp, lim, nbits, hist, lst, s_sel,
                                     &tk);
      for (int c = tid; c < EWp; c += THREADS) {
        const int v = raw[c];
        if (v != hs::BIG &&
            (v > cut || (v == cut && E == 1 && atomicAdd(&s_tk, 1) >= tk)))
          raw[c] = hs::BIG;
      }
      __syncthreads();
    }
    int m;
    if (!prewindow) {
      m = hs::compact(
          EWp,
          [&](int c, int& v) {
            v = raw[c];
            return v != hs::BIG &&
                   (E == 1 || hs::set_insert(tab, hmask, gen, v));
          },
          ci, s_scr, cw);
    } else {
      // the pool: the unique ids of the 2*cw smallest lanes that are not
      // in the buffer (both fail to enter the set); then its cw smallest
      const int u = hs::compact(
          EWp,
          [&](int c, int& v) {
            v = raw[c];
            return v != hs::BIG && hs::set_insert(tab, hmask, gen, v);
          },
          lst, s_scr, EWp);
      int cut = INT_MAX, tk;
      if (u > cw) cut = hs::select_kth(lst, u, cw, nbits, hist, raw, s_sel,
                                       &tk);
      m = hs::compact(
          u,
          [&](int c, int& v) {
            v = lst[c];
            return v <= cut;
          },
          ci, s_scr, cw);
    }

    // 3. score: each warp ROWS candidates at a time, their rows in flight
    // together (quantized: one gather of their code rows)
    for (int c0 = warp * ROWS; c0 < m; c0 += NW * ROWS) {
      const int nr = min(ROWS, m - c0);
      if constexpr (QUANT) {
        int ids[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) ids[r] = ci[c0 + min(r, nr - 1)];
        const float dist =  // of row lane / (32 / ROWS)
            hs::quant_score_rows<ROWS>(z, qs, ga, qnv, ids, nr, stage);
        const int r = lane / (32 / ROWS);
        if (lane % (32 / ROWS) == 0 && r < nr) cd[c0 + r] = dist;
      } else {
        const T* rows[ROWS];
        float* const st[ROWS] = {};
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          rows[r] = vec + (size_t)ci[c0 + min(r, nr - 1)] * D;
        float s, nrm;  // of row lane / (32 / ROWS)
        hs::warp_dot_rows<ROWS>(qs, rows, nr, D, vec4, s, nrm, st);
        const int r = lane / (32 / ROWS);
        if (lane % (32 / ROWS) == 0 && r < nr)
          cd[c0 + r] = metric ? 1.f - s : (qnv + nrm) - 2.f * s;
      }
    }
    const int mp = max(32, hs::next_pow2(m));
    for (int c = m + tid; c < mp; c += THREADS) {
      cd[c] = HS_INF;
      ci[c] = INT_MAX;
    }
    __syncthreads();
    hs::sort_pairs_shfl(cd, ci, mp);

    // 3b. filtered mode: allowed candidates not yet in the track merge into
    // it by rank (track entries first on equal distance), P smallest kept
    if (filt) {
      const int fm = hs::compact(
          m,
          [&](int c, int& v) {
            v = c;
            const int id = ci[c];
            const bool ok = allowed ? allowed[id] != 0
                                    : (__ldg(tags + id) & nw) == nw;
            admit += ok;
            return ok && !hs::set_has(ttab, tmask, gen, id);
          },
          fx, s_scr, cw);
      for (int c = tid; c < fm; c += THREADS) {
        fd[c] = cd[fx[c]];
        fi[c] = ci[fx[c]];
      }
      __syncthreads();
      for (int j = tid; j < P; j += THREADS) {
        const int pos = j + hs::count_below(fd, fm, td[j]);
        if (pos < P) {
          ntd[pos] = td[j];
          nti[pos] = ti[j];
          if (ti[j] >= 0) hs::set_insert(ttab, tmask, gen + 1, ti[j]);
        }
      }
      for (int c = tid; c < fm; c += THREADS) {
        const int pos = c + hs::count_at_or_below(td, P, fd[c]);
        if (pos < P) {
          ntd[pos] = fd[c];
          nti[pos] = fi[c];
          hs::set_insert(ttab, tmask, gen + 1, fi[c]);
        }
      }
      __syncthreads();
      float* xd = td; td = ntd; ntd = xd;
      int* xi = ti; ti = nti; nti = xi;
    }

    // 4. merge by rank into the other buffer, keep the P smallest; the
    // merged ids form the buffer's set of the next generation
    for (int j = tid; j < P; j += THREADS) {
      const int pos = j + hs::count_below(cd, m, bd[j]);
      if (pos < P) {
        nd[pos] = bd[j];
        ni[pos] = bi[j];
        nc[pos] = bc[j];
        if (bi[j] >= 0) hs::set_insert(tab, hmask, gen + 1, bi[j]);
      }
    }
    for (int c = tid; c < m; c += THREADS) {
      const int pos = c + hs::count_at_or_below(bd, P, cd[c]);
      if (pos < P) {
        nd[pos] = cd[c];
        ni[pos] = ci[c];
        nc[pos] = 0;
        hs::set_insert(tab, hmask, gen + 1, ci[c]);
      }
    }
    dcomp += m;
    __syncthreads();
    float* sw_d = bd; bd = nd; nd = sw_d;
    int* sw_i = bi; bi = ni; ni = sw_i;
    int* sw_c = bc; bc = nc; nc = sw_c;
  }

  for (int t = tid; t < k; t += THREADS) {
    out_d[(size_t)b * k + t] = bd[t];
    out_id[(size_t)b * k + t] = bi[t];
  }
  if (filt) {
    for (int j = tid; j < P; j += THREADS) {
      trk_d_out[(size_t)b * P + j] = td[j];
      trk_id_out[(size_t)b * P + j] = ti[j];
    }
    admit = __reduce_add_sync(HS_FULL, admit);
    if (lane == 0 && admit) atomicAdd(&s_adm, admit);
    __syncthreads();
    if (tid == 0) admit_out[b] = s_adm;
  }
  if (track) {
    for (int j = tid; j < t.kk; j += THREADS) {
      t.d_out[(size_t)b * t.kk + j] = rd[j];
      t.id_out[(size_t)b * t.kk + j] = ri[j];
    }
  }
  if (tid == 0) {
    hops_out[b] = hops;
    dcomp_out[b] = dcomp;
  }
}

// smallest power of two that holds n ids at a load of at most 1/2
int set_size(int n) { return hs::next_pow2(2 * (n < 1 ? 1 : n)); }

template <bool QUANT, class T>
int launch_beam(const T* vec, int D, const hs::Fetch& f,
                const hs::Quant& z, const hs::PopTrack& t, const float* q,
                const float* qn, const float* seed_d, const int* seed_id,
                int B, int S, int P, int ef_eff, int E, int cw, int max_iters,
                int k, int metric, const unsigned char* allowed,
                const float* trk_d_in, const int* trk_id_in, float* out_d,
                int* out_id, int* hops, int* dcomp, float* trk_d_out,
                int* trk_id_out, const unsigned* tags, const unsigned* need,
                const int* iters, int* admit, void* stream) {
  if (E > MAX_POP) return static_cast<int>(cudaErrorInvalidValue);
  const bool filt = allowed != nullptr || tags != nullptr;
  const int Dp = (D + 3) / 4 * 4;
  const int Cp = QUANT ? (z.C + 3) / 4 * 4 : 0;
  const int Drp = (QUANT && t.data) ? (t.D + 3) / 4 * 4 : 0;
  const int KKp = (QUANT && t.data) ? (t.kk + 3) / 4 * 4 : 0;
  const int ew = E * f.W;
  const int EWp = std::max(32, hs::next_pow2(ew));
  const int CWp = std::max(32, hs::next_pow2(cw));
  // the buffer's set holds P buffer ids and at most min(E W, 2 cw)
  // candidates in one generation; the track's set P ids
  int Hs = set_size(P + std::min(ew, 2 * cw));
  const int Ht = filt ? set_size(P) : 0;
  const size_t rest = sizeof(float) * (Dp + Cp + Drp + 4 * KKp) +
                      6 * sizeof(int) * P + 2 * sizeof(int) * EWp +
                      256 * sizeof(int) + 2 * sizeof(int) * CWp +
                      (filt ? 4 * sizeof(int) * P +
                                     3 * sizeof(int) * CWp : 0);
  const size_t cap = 227 * 1024;
  // past the shared memory a block can have, the set runs fuller (it keeps
  // a free slot: Hs > P + min(E W, 2 cw))
  while (Hs > hs::next_pow2(P + std::min(ew, 2 * cw) + 1) &&
         rest + 8 * (size_t)(Hs + Ht) > cap)
    Hs >>= 1;
  const size_t smem = rest + 8 * (size_t)(Hs + Ht);
  cudaError_t err = cudaFuncSetAttribute(
      beam_kernel<QUANT, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  beam_kernel<QUANT, T><<<B, THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      vec, D, f, z, t, Cp, Drp, KKp, q, qn, seed_d, seed_id, S, P, ef_eff, E,
      cw, max_iters, k, metric, Dp, EWp, Hs, Ht, CWp, allowed, trk_d_in,
      trk_id_in, out_d, out_id, hops, dcomp, trk_d_out, trk_id_out, tags,
      need, iters, admit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hs_beam_search(const float* vec, int D, const int* rows,
                              const int* aux, int mode, int W, int level,
                              int stride, const float* q, const float* qn,
                              const float* seed_d, const int* seed_id, int B,
                              int S, int P, int ef_eff, int E, int cw,
                              int max_iters, int k, int metric,
                              const unsigned char* allowed,
                              const float* trk_d_in, const int* trk_id_in,
                              float* out_d, int* out_id, int* hops,
                              int* dcomp, float* trk_d_out, int* trk_id_out,
                              const unsigned* tags, const unsigned* need,
                              const int* iters, int* admit, void* stream) {
  const hs::Fetch f{rows, aux, mode, W, level, stride};
  return launch_beam<false>(vec, D, f, hs::Quant{}, hs::PopTrack{}, q, qn,
                            seed_d, seed_id, B, S, P, ef_eff, E, cw,
                            max_iters, k, metric, allowed, trk_d_in,
                            trk_id_in, out_d, out_id, hops, dcomp, trk_d_out,
                            trk_id_out, tags, need, iters, admit, stream);
}

// the same over a bfloat16 store (rows widened to fp32 in registers)
extern "C" int hs_beam_search_bf16(
    const __nv_bfloat16* vec, int D, const int* rows, const int* aux,
    int mode, int W, int level, int stride, const float* q, const float* qn,
    const float* seed_d, const int* seed_id, int B, int S, int P, int ef_eff,
    int E, int cw, int max_iters, int k, int metric,
    const unsigned char* allowed, const float* trk_d_in,
    const int* trk_id_in, float* out_d, int* out_id, int* hops, int* dcomp,
    float* trk_d_out, int* trk_id_out, const unsigned* tags,
    const unsigned* need, const int* iters, int* admit, void* stream) {
  const hs::Fetch f{rows, aux, mode, W, level, stride};
  return launch_beam<false>(vec, D, f, hs::Quant{}, hs::PopTrack{}, q, qn,
                            seed_d, seed_id, B, S, P, ef_eff, E, cw,
                            max_iters, k, metric, allowed, trk_d_in,
                            trk_id_in, out_d, out_id, hops, dcomp, trk_d_out,
                            trk_id_out, tags, need, iters, admit, stream);
}

// Kβ on estimates: the scorer (arguments as in hs_greedy_descent_quant)
// takes the place of the vectors; data != nullptr adds the rerank track
// (dataset f32[N, Dr], raw queries and their squared norms, kk, the track in
// and out). metric selects the rerank distance only.
extern "C" int hs_beam_search_quant(
    const uint32_t* qrows, int qstride, int nb, int ex_bits, int use_ex,
    const float* q_rot, const float* sumq, const float* g_add, int C,
    const int* rows, const int* aux, int mode, int W, int level, int stride,
    const float* seed_d, const int* seed_id, int B, int S, int P, int ef_eff,
    int E, int cw, int max_iters, int k, int metric, const float* data,
    int Dr, const float* q_raw, const float* qn_raw, int kk,
    const float* rr_d_in, const int* rr_id_in, float* out_d, int* out_id,
    int* hops, int* dcomp, float* rr_d_out, int* rr_id_out, void* stream) {
  const hs::Fetch f{rows, aux, mode, W, level, stride};
  const hs::Quant z{qrows, qstride, nb, ex_bits, use_ex, q_rot, sumq, g_add,
                    C};
  const hs::PopTrack t{data, Dr, kk, q_raw, qn_raw, rr_d_in, rr_id_in,
                       rr_d_out, rr_id_out};
  return launch_beam<true>(static_cast<const float*>(nullptr), nb * 32, f, z,
                           t, nullptr, nullptr,
                           seed_d, seed_id, B, S, P, ef_eff, E, cw, max_iters,
                           k, metric, nullptr, nullptr, nullptr, out_d,
                           out_id, hops, dcomp, nullptr, nullptr, nullptr,
                           nullptr, nullptr, nullptr, stream);
}
