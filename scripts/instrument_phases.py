#!/usr/bin/env python3
"""Instrument a COPY of the port's Kβ and Kγ sources with per-phase clocks.

    python3 scripts/instrument_phases.py COPY/hnsw_slim_tpu_torch/csrc \
        --design current      # or --design sort: commit f18965d's kernels

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
    filter track, 8 merge, 9 end (rng_prune: window resolve); 10 scoring,
    11 sort, 12 set-up + backfill + pack, 13 ring load, 14 window step (a),
    15 window step (b); rng_prune counters per block in 0-5: windows,
    members, (member, kept row) pairs, survivors of (a), valid candidates,
    kept rows.
The patches match the two designs' source text and fail on anything else.
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
    ("    hops += npop;\n    __syncthreads();\n", "    hops += npop;\n    __syncthreads();\n    PH(0)\n"),
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
    ap.add_argument("--design", choices=("sort", "current"), required=True)
    args = ap.parse_args()
    src_dir = os.path.abspath(args.copy)
    if src_dir == os.path.join(ROOT, "hnsw_slim_tpu_torch", "csrc"):
        raise SystemExit("instrument a copy, not this checkout's sources")
    beam, prune = ((SORT_BEAM, SORT_PRUNE) if args.design == "sort"
                   else (CURRENT_BEAM, CURRENT_PRUNE))
    _patch(os.path.join(src_dir, "beam_search.cu"), "b", beam)
    _patch(os.path.join(src_dir, "rng_prune.cu"), "p", prune, READER)
    print(f"instrumented {src_dir} ({args.design})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
