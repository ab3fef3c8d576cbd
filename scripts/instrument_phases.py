#!/usr/bin/env python3
"""Instrument a COPY of the port's kernel sources with per-phase clocks.

    python3 scripts/instrument_phases.py COPY/hnsw_slim_tpu_torch/csrc \
        --design current      # or --design sort: commit f18965d's kernels
    python3 scripts/instrument_phases.py COPY/hnsw_slim_tpu_torch/csrc \
        --target scan_descent --design tile   # or --design current

The default target is Kβ and Kγ (read by scripts/beam_prune_ab.py); the
scan_descent target is Kα and Kε (read by scripts/scan_descent_ab.py).

Thread 0 of each block adds the clock64 cycles between phase marks to a
per-block sum, and the block adds its sums to a device array at its end;
``hs_phase_read`` copies the 16 sums out and zeroes them.
scripts/beam_prune_ab.py prints them for a package copy whose library
exports that function. A block's phase time includes what it waits for at
the barrier that ends the phase, so a barrier-bound phase shows as its own
time. Slots (beam_search, then rng_prune):
  sort design: 0 pops, 1 rerank track, 2 candidate ids read, 3 buffer-id
    sort, 4 id sort + dedup + compaction, 5 scoring, 6 pair sort, 7 filter
    track, 8 merge, 9 end; 10 scoring, 11 sort, 12 walk set-up, 13 walk:
    row load + barrier, 14 walk: dots + barrier, 15 backfill + pack;
  current design: 0 pops, 1 rerank track, 2 candidate ids read + buffer
    probe, 3 select, 4 dedup + compaction, 5 scoring, 6 pair sort, 7
    filter track, 8 merge, 9 end (rng_prune: window resolve), 10 the
    iterations a query took (a count: Kβ alone); 10 scoring,
    11 sort, 12 set-up + backfill + pack, 13 ring load, 14 window step (a),
    15 window step (b); rng_prune counters per block in 0-5: windows,
    members, (member, kept row) pairs, survivors of (a), valid candidates,
    kept rows.
Slots of the scan_descent target (Kα: thread 0 of each block; Kε: lane 0
of each warp, each clock read after a value that the phase produced, so a
load's wait falls in the phase that issued it):
  tile design (commit 65d9c40's kernels): 0 Kα staging (slab loads +
    barrier), 1 FMA loop + barrier, 2 epilogue + barrier, 3 top-k fold +
    barrier; 6 Kε row fetch, 7 vector loads + partial dots of a group of
    four, 8 reductions + argmin of the group, 9 move;
  current design: 0 Kα slab stores + barrier, 1 FMA loop (the next slab's
    loads in flight), 2 epilogue + barrier, 3 top-k fold + barrier; 6 Kε
    row fetch, 7 vector loads + lane sums of a group of rows, 8
    reductions + the group's argmin, 9 the warp's argmin + move, 10 hops
    counted, 11 levels walked; Kα counts of warp 0's folds: 12 candidates
    offered, 13 chunks with a candidate, 14 chunks merged whole.
The patches match the designs' source text and fail on anything else.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HEAD = r'''
__device__ unsigned long long g_phase_%(t)s[16];
extern "C" int hs_phase_read_%(t)s(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_phase_%(t)s, sizeof(unsigned long long) * 16);
  if (e != cudaSuccess) return (int)e;
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(g_phase_%(t)s, z, sizeof z);
}
#define PH_INIT long long ph_t = clock64(); unsigned long long ph[16] = {0};
#define PH(k) if (threadIdx.x == 0) { long long ph_n = clock64(); ph[k] += ph_n - ph_t; ph_t = ph_n; }
#define PH_FLUSH(tag) if (threadIdx.x == 0) { for (int ph_i = 0; ph_i < 16; ++ph_i) if (ph[ph_i]) atomicAdd(&g_phase_##tag[ph_i], ph[ph_i]); }
#define PHW_INIT long long phw_t = clock64(); unsigned long long phw[16] = {0}; int phw_sink = 0;
#define PHW(k, v) { asm volatile("add.s32 %%0, %%0, %%1;" : "+r"(phw_sink) : "r"((int)(v))); long long phw_n = clock64(); phw[k] += phw_n - phw_t; phw_t = phw_n; }
#define PHWF(k, v) PHW(k, __float_as_int(v))
#define PHW_FLUSH(tag) if ((threadIdx.x & 31) == 0) { for (int ph_i = 0; ph_i < 16; ++ph_i) if (phw[ph_i]) atomicAdd(&g_phase_##tag[ph_i], phw[ph_i]); if (phw_sink == 0x7fffffff) g_phase_##tag[15] += 0; }
'''
SORT_BEAM = [
    ("  const int W = f.W;\n  const int ew = E * W;", "  PH_INIT\n  const int W = f.W;\n  const int ew = E * W;"),
    ("    hops += npop;\n    __syncthreads();\n", "    hops += npop;\n    __syncthreads();\n    PH(0)\n"),
    ("    // 2. candidate ids: fetch rows, sort, dedup, cap at cw lanes\n", "    PH(1)\n    // 2. candidate ids: fetch rows, sort, dedup, cap at cw lanes\n"),
    ("    hs::sort_int(sb, Pp);\n", "    PH(2)\n    hs::sort_int(sb, Pp);\n    PH(3)\n"),
    ("    // 3. score: one warp per candidate\n", "    PH(4)\n    // 3. score: one warp per candidate\n"),
    ("    hs::sort_pairs(cd, ci, mp);\n", "    PH(5)\n    hs::sort_pairs(cd, ci, mp);\n    PH(6)\n"),
    ("    // 4. merge by rank into the other buffer, keep the P smallest\n", "    PH(7)\n    // 4. merge by rank into the other buffer, keep the P smallest\n"),
    ("    int* sw_c = bc; bc = nc; nc = sw_c;\n  }\n", "    int* sw_c = bc; bc = nc; nc = sw_c;\n    PH(8)\n  }\n  PH(0)\n"),
    ("  if (tid == 0) {\n    hops_out[b] = hops;", "  PH(9)\n  PH_FLUSH(b)\n  if (tid == 0) {\n    hops_out[b] = hops;"),
]
SORT_PRUNE = [
    ("  for (int i = tid; i < D; i += THREADS)\n    bvec[i]", "  PH_INIT\n  for (int i = tid; i < D; i += THREADS)\n    bvec[i]"),
    ("  hs::sort_pairs(sd, sp, Cp);\n", "  PH(10)\n  hs::sort_pairs(sd, sp, Cp);\n  PH(11)\n"),
    # plain walk: load + barrier, then dots + barrier
    ("""    for (int i = 0; i < nvalid && cnt < m; ++i) {
      const int id = crow[sp[i]];
      const float di = sd[i];
      float* cv = kvec + (size_t)cnt * Dp;
      for (int e = tid; e < D; e += THREADS)
        cv[e] = hs::load1(vec + (size_t)id * D + e);
      const float cn = vn[id];
      __syncthreads();""", """    PH(12)
    for (int i = 0; i < nvalid && cnt < m; ++i) {
      const int id = crow[sp[i]];
      const float di = sd[i];
      float* cv = kvec + (size_t)cnt * Dp;
      for (int e = tid; e < D; e += THREADS)
        cv[e] = hs::load1(vec + (size_t)id * D + e);
      const float cn = vn[id];
      __syncthreads();
      PH(13)"""),
    ("""      if (!__syncthreads_or(conflict)) {
        if (tid == 0) { kn[cnt] = cn; kid[cnt] = id; kflag[i] = 1; }
        ++cnt;
      }
    }""", """      if (!__syncthreads_or(conflict)) {
        if (tid == 0) { kn[cnt] = cn; kid[cnt] = id; kflag[i] = 1; }
        ++cnt;
      }
      PH(14)
    }"""),
    ("  if (tid == 0) cnt_out[b] = cnt;\n", "  PH(15)\n  PH_FLUSH(p)\n  if (tid == 0) cnt_out[b] = cnt;\n"),
]

CURRENT_BEAM = [
    ("  const int W = f.W;\n  const int ew = E * W;", "  PH_INIT\n  const int W = f.W;\n  const int ew = E * W;"),
    ("    hops += npop;\n    __syncthreads();\n", "    hops += npop;\n    __syncthreads();\n    PH(0)\n    if (tid == 0) ph[10] += 1;\n"),
    ("    int nv = 0;\n    unsigned orv = 0;\n", "    PH(1)\n    int nv = 0;\n    unsigned orv = 0;\n"),
    ("    const int nbits = 32 - __clz(s_or);\n", "    PH(2)\n    const int nbits = 32 - __clz(s_or);\n"),
    ("    int m;\n    if (!prewindow) {\n", "    PH(3)\n    int m;\n    if (!prewindow) {\n"),
    ("    // 3. score: each warp ROWS candidates at a time, their rows in flight\n", "    PH(4)\n    // 3. score: each warp ROWS candidates at a time, their rows in flight\n"),
    ("    hs::sort_pairs_shfl(cd, ci, mp);\n", "    PH(5)\n    hs::sort_pairs_shfl(cd, ci, mp);\n    PH(6)\n"),
    ("    // 4. merge by rank into the other buffer, keep the P smallest; the\n", "    PH(7)\n    // 4. merge by rank into the other buffer, keep the P smallest; the\n"),
    ("    int* sw_c = bc; bc = nc; nc = sw_c;\n  }\n", "    int* sw_c = bc; bc = nc; nc = sw_c;\n    PH(8)\n  }\n  PH(0)\n"),
    ("  if (tid == 0) {\n    hops_out[b] = hops;", "  PH(9)\n  PH_FLUSH(b)\n  if (tid == 0) {\n    hops_out[b] = hops;"),
]
CURRENT_PRUNE = [
    ("  float* bvec = rows + kept0;", "  PH_INIT\n  float* bvec = rows + kept0;"),
    ("  hs::sort_pairs_shfl(sd, sp, Cp);\n", "  PH(10)\n  hs::sort_pairs_shfl(sd, sp, Cp);\n  PH(11)\n"),
    ("  for (int u0 = 0, buf = 0; u0 < nu && cnt < m; u0 += ring, buf ^= 1) {\n", "  PH(12)\n  for (int u0 = 0, buf = 0; u0 < nu && cnt < m; u0 += ring, buf ^= 1) {\n"),
    ("    for (int a0 = 0; a0 < rn && cnt < m; a0 += win) {\n      const int wn = min(win, rn - a0);\n", "    PH(13)\n    for (int a0 = 0; a0 < rn && cnt < m; a0 += win) {\n      const int wn = min(win, rn - a0);\n      if (tid == 0) { ph[0] += 1; ph[1] += wn; ph[2] += (unsigned long long)wn * cnt; }\n"),
    ("      // (b) the members that survive (a)", "      PH(14)\n      // (b) the members that survive (a)"),
    ("      // (c) warp 0 takes the window", "      PH(15)\n      if (tid == 0) ph[3] += __popc(surv);\n      // (c) warp 0 takes the window"),
    ("      __syncthreads();\n      cnt = s_cnt;\n", "      __syncthreads();\n      PH(9)\n      cnt = s_cnt;\n"),
    ("  if (tid == 0) cnt_out[b] = cnt;\n", "  PH(12)\n  if (tid == 0) { ph[4] += nvalid; ph[5] += cnt; }\n  PH_FLUSH(p)\n  if (tid == 0) cnt_out[b] = cnt;\n"),
]

TILE_SCAN = [
    ("  float ld[4][2];\n  int li[4][2];", "  PH_INIT\n  float ld[4][2];\n  int li[4][2];"),
    ("      __syncthreads();\n#pragma unroll 8\n", "      __syncthreads();\n      PH(0)\n#pragma unroll 8\n"),
    ("          acc[1][j] = fmaf(a1, bv, acc[1][j]);\n        }\n      }\n      __syncthreads();\n", "          acc[1][j] = fmaf(a1, bv, acc[1][j]);\n        }\n      }\n      __syncthreads();\n      PH(1)\n"),
    ("        dt[ty * 2 + a][tx * 4 + j] = dist;\n      }\n    }\n    __syncthreads();\n", "        dt[ty * 2 + a][tx * 4 + j] = dist;\n      }\n    }\n    __syncthreads();\n    PH(2)\n"),
    ("        list_offer(ld[r], li[r], dt[ql][col], r0 + col, k, lane);\n      }\n    }\n    __syncthreads();\n", "        list_offer(ld[r], li[r], dt[ql][col], r0 + col, k, lane);\n      }\n    }\n    __syncthreads();\n    PH(3)\n"),
    ("#pragma unroll\n  for (int r = 0; r < 4; ++r) {\n    const int gq = q0 + warp * 4 + r;\n    if (gq >= B) continue;", "  PH_FLUSH(a)\n#pragma unroll\n  for (int r = 0; r < 4; ++r) {\n    const int gq = q0 + warp * 4 + r;\n    if (gq >= B) continue;"),
]
TILE_DESCENT = [
    ("  int hops = 0, dcomp = 0;\n  bool go", "  PHW_INIT\n  int hops = 0, dcomp = 0;\n  bool go"),
    ("      const int mine = lane < cnt ? __ldg(row + j0 + lane) : -1;\n", "      const int mine = lane < cnt ? __ldg(row + j0 + lane) : -1;\n      PHW(6, mine)\n"),
    ("              hs::partial_dot(qs, vec + (size_t)id[g] * D, D, vec4, s[g],\n                              n[g]);\n        }\n", "              hs::partial_dot(qs, vec + (size_t)id[g] * D, D, vec4, s[g],\n                              n[g]);\n        }\n        PHWF(7, s[0] + s[1] + s[2] + s[3] + n[0] + n[1] + n[2] + n[3])\n"),
    ("            best_id = id[g];\n          }\n        }\n", "            best_id = id[g];\n          }\n        }\n        PHWF(8, best_d)\n"),
    ("      go = false;\n    }\n  }\n", "      go = false;\n    }\n    PHW(9, c)\n  }\n"),
    ("  if (lane == 0) {\n    cur[b] = c;", "  PHW_FLUSH(e)\n  if (lane == 0) {\n    cur[b] = c;"),
]
CURRENT_SCAN = [
    ("  const int nslab = Dp / BK, qslab", "  PH_INIT\n  const int nslab = Dp / BK, qslab"),
    ("        }\n        if (more) {\n          slab_store(Us + ((s + 1) & 1) * BK * BN);\n          __syncthreads();\n        }\n", "        }\n        PH(1)\n        if (more) {\n          slab_store(Us + ((s + 1) & 1) * BK * BN);\n          __syncthreads();\n        }\n        PH(0)\n"),
    ("      if ((pass >> i) & 1u) Fl[fidx<TQ, BQ>(ty, i)] = 1;\n    __syncthreads();\n", "      if ((pass >> i) & 1u) Fl[fidx<TQ, BQ>(ty, i)] = 1;\n    __syncthreads();\n    PH(2)\n"),
    ("        const int n = __popc(__ballot_sync(HS_FULL, ok));\n", "        const int n = __popc(__ballot_sync(HS_FULL, ok));\n        if (threadIdx.x == 0) { ph[12] += n; ph[13] += n > 0; ph[14] += n >= MERGE_AT; }\n"),
    ("          atomicMin(gkth + q0 + ql, pair_key(td, ti));\n      }\n    }\n    __syncthreads();\n", "          atomicMin(gkth + q0 + ql, pair_key(td, ti));\n      }\n    }\n    __syncthreads();\n    PH(3)\n"),
    ("      slab_store(Us);\n      __syncthreads();\n    }\n  }\n", "      slab_store(Us);\n      __syncthreads();\n    }\n    PH(0)\n  }\n"),
    ("  for (int ql = warp; ql < BQ; ql += NWARP) {\n    const int gq = q0 + ql;\n    if (gq >= B) break;", "  PH_FLUSH(a)\n  for (int ql = warp; ql < BQ; ql += NWARP) {\n    const int gq = q0 + ql;\n    if (gq >= B) break;"),
]
# Kε: the exact scorer's warp_dot_rows spelled out (vec4 rows), with a mark
# between its loads + lane sums and its reductions
CURRENT_DESCENT = [
    ("    int hops = 0, dcomp = 0;\n    const int sb", "    PHW_INIT\n    int hops = 0, dcomp = 0;\n    const int sb"),
    ("      const hs::Fetch& f = lv.f[li];\n", "      const hs::Fetch& f = lv.f[li];\n      phw[11] += 1;\n"),
    ("        ++hops;\n", "        ++hops;\n        phw[10] += 1;\n"),
    ("          const int mine = lane < cnt ? __ldg(row + j0 + lane) : -1;\n", "          const int mine = lane < cnt ? __ldg(row + j0 + lane) : -1;\n          PHW(6, mine)\n"),
    ("              d = hs::quant_score_rows<R>(z, qs, ga, qnv, ids, nr);\n", "              d = hs::quant_score_rows<R>(z, qs, ga, qnv, ids, nr);\n              PHWF(7, d)\n"),
    ("              hs::warp_dot_rows<R>(qs, rows, nr, D, vec4, s, n, none);\n", """              if (vec4) {
                float s_[R], n_[R];
                for (int r = 0; r < R; ++r) s_[r] = n_[r] = 0.f;
                for (int e = lane * 4; e < D; e += 128) {
                  float4 x_[R];
#pragma unroll
                  for (int r = 0; r < R; ++r)
                    x_[r] = r < nr ? hs::load4(rows[r] + e) : make_float4(0.f, 0.f, 0.f, 0.f);
                  const float4 y = *reinterpret_cast<const float4*>(qs + e);
#pragma unroll
                  for (int r = 0; r < R; ++r) {
                    s_[r] = fmaf(x_[r].x, y.x, s_[r]); s_[r] = fmaf(x_[r].y, y.y, s_[r]);
                    s_[r] = fmaf(x_[r].z, y.z, s_[r]); s_[r] = fmaf(x_[r].w, y.w, s_[r]);
                    n_[r] = fmaf(x_[r].x, x_[r].x, n_[r]); n_[r] = fmaf(x_[r].y, x_[r].y, n_[r]);
                    n_[r] = fmaf(x_[r].z, x_[r].z, n_[r]); n_[r] = fmaf(x_[r].w, x_[r].w, n_[r]);
                  }
                }
                float dep = 0.f;
#pragma unroll
                for (int r = 0; r < R; ++r) dep += s_[r] + n_[r];
                PHWF(7, dep)
                hs::warp_sum_rows<R>(s_);
                hs::warp_sum_rows<R>(n_);
                s = s_[0];
                n = n_[0];
              } else {
                hs::warp_dot_rows<R>(qs, rows, nr, D, vec4, s, n, none);
              }
"""),
    ("              d = metric ? 1.f - s : (qnv + n) - 2.f * s;\n", "              d = metric ? 1.f - s : (qnv + n) - 2.f * s;\n              PHWF(8, d)\n"),
    ("        if (!(bd < cd)) break;\n", "        PHW(9, bid)\n        if (!(bd < cd)) break;\n"),
    ("    if (lane == 0) {\n      cur[b] = c;", "    PHW_FLUSH(e)\n    if (lane == 0) {\n      cur[b] = c;"),
]

SD_READER = """
extern "C" int hs_phase_read_a(unsigned long long* host);
extern "C" int hs_phase_read(unsigned long long* host) {
  unsigned long long a8[16], e8[16];
  int e = hs_phase_read_a(a8);
  if (e) return e;
  e = hs_phase_read_e(e8);
  for (int i = 0; i < 16; ++i) host[i] = a8[i] + e8[i];
  return e;
}
"""

READER = """
extern "C" int hs_phase_read_b(unsigned long long* host);
extern "C" int hs_phase_read(unsigned long long* host) {
  unsigned long long b8[16], p8[16];
  int e = hs_phase_read_b(b8);
  if (e) return e;
  e = hs_phase_read_p(p8);
  for (int i = 0; i < 16; ++i) host[i] = b8[i] + p8[i];
  return e;
}
"""


def _patch(path: str, tag: str, reps: list, tail: str = "") -> None:
    with open(path) as fh:
        s = fh.read()
    s = s.replace('#include "common.cuh"\n',
                  '#include "common.cuh"\n' + HEAD % {"t": tag}, 1)
    for a, b in reps:
        if a not in s:
            raise SystemExit(f"{path}: source text not found: {a[:60]!r}")
        s = s.replace(a, b, 1)
    with open(path, "w") as fh:
        fh.write(s + tail)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("copy", help="a copy's hnsw_slim_tpu_torch/csrc")
    ap.add_argument("--target", choices=("beam_prune", "scan_descent"),
                    default="beam_prune")
    ap.add_argument("--design", choices=("sort", "tile", "current"),
                    required=True)
    args = ap.parse_args()
    src_dir = os.path.abspath(args.copy)
    if src_dir == os.path.join(ROOT, "hnsw_slim_tpu_torch", "csrc"):
        raise SystemExit("instrument a copy, not this checkout's sources")
    if args.target == "scan_descent":
        if args.design == "sort":
            raise SystemExit("the scan_descent designs are tile and current")
        scan, descent = ((TILE_SCAN, TILE_DESCENT) if args.design == "tile"
                         else (CURRENT_SCAN, CURRENT_DESCENT))
        _patch(os.path.join(src_dir, "topk_dist.cu"), "a", scan)
        _patch(os.path.join(src_dir, "greedy_descent.cu"), "e", descent,
               SD_READER)
    else:
        if args.design == "tile":
            raise SystemExit("the beam_prune designs are sort and current")
        beam, prune = ((SORT_BEAM, SORT_PRUNE) if args.design == "sort"
                       else (CURRENT_BEAM, CURRENT_PRUNE))
        _patch(os.path.join(src_dir, "beam_search.cu"), "b", beam)
        _patch(os.path.join(src_dir, "rng_prune.cu"), "p", prune, READER)
    print(f"instrumented {src_dir} ({args.target}, {args.design})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
