#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main paths once on one NVIDIA card.

    python3 chip_smoke.py            # 1M x 128, 4096 queries
    python3 chip_smoke.py --n 20000  # a short rehearsal at a smaller N
                                     # (printed as a CUT line)

Phases (one line each on stdout, the kernel table second to last):
  1. the card (nvidia-smi name, power limit) and the kernel build;
  2. the insertion path, as the JAX package runs it at this size, its
     kernel launch counts reset before and read after:
     HnswIndex(HnswConfig(M=30, ef_construction=128)) with strategy "auto"
     (insertion rounds from 200k points) -> check_integrity -> exact ground
     truth -> vanilla HNSW sweep (pop 4) at ef 32..320 -> Slim conversion
     + dense level-0 rows -> seeded Slim sweep (seed_width 32, pop 8);
     build seconds split into the device spans of the batches' searches
     (level-0-only and upper-level inserts) and applies and the rest
     (host), and the reverse-connect overflow counters;
  3. the query surface on that graph, with its own launch counts: the
     seeded Slim search over three serving layouts (CHAL only, dense level
     0, dense level 0 + dense upper; identical ids), seed_width=0 (greedy
     descent through rank and CHAL rows), a threshold_level=1 conversion
     served with seed_width=0, seed_strata=4, filter_mask at 50% and 10%
     allowed on both index classes (recall over the allowed subset, every
     id allowed, every row full), search_async against search, one
     autotune_index(ef=128);
  4. SlimZero, with its own launch counts: HnswSlimZeroIndex.from_hnsw on
     the same HNSW, integrity, the in-degree floor at level 0, a seeded
     sweep;
  5. SlimQ, with its own launch counts, on the manifold data the JAX
     package documents for it (manifold(N, 128, latent_dim=24,
     n_clusters=250, seed=5), HnswConfig(M=32, ef_construction=128),
     SlimConfig(32, 8, 16, 4), 4 bits, both dense layouts):
     HnswSlimQIndex.build with its split (HNSW build, conversion, KMeans,
     rotation, quantization) and the Kα launches of its KMeans step,
     index_size and runtime_memory, exact ground
     truth, a sweep at ef 32..256 with the rerank (seed_width 32, pop 8) and
     its time split (rotate, seeds, beam), the same at ef 64/128 with
     use_ex, with rerank=False, with seed_width=0, and a save_slimq ->
     load_slimq round trip;
  6. the HTTP server on an NN-descent-built index, with its own launch
     counts: SlimServer(base, build_strategy="nnd") (the NND build on Kν,
     Kκ, Kλ both modes, Kμ both modes, Kδ, the mutual union on Kκ + Kμ +
     Kθ, Kγ, Kα, K1; IncrementalSlim.full; both dense layouts), integrity,
     the seeded sweep on server.slim, then over HTTP /setEf, /stats, /query
     from 1 and 64 client threads (latency p50 / p99, QPS, the batches the
     _Batcher formed, recall@10 at ef 64, the ids of one batched search),
     /getIndex, a cold and a warm 1000-vector /updateIndex (zlib),
     /getLastBatch chunks and sync_patches onto the bootstrapped copy (equal
     to the server's graph and vectors), /markDelete of 1000 labels (none
     served after), /getIndex and /getVectors again; then, outside the
     path's counts, the NND build at min(N, 100000) with the kernels equal
     row for row to the build with every plain twin swapped in, Kκ / Kλ /
     Kμ / Kν against their plain versions on inputs recorded from the 1M
     build (round 2, the warm start, the level-0 union; Kκ beside
     torch.sort(stable=True), also on all-equal and on descending keys at
     round 2's size, its device launches per sort counted by
     torch.profiler), and the build once more under
     torch.profiler (device time by kernel group, host the rest);
  7. each kernel and each kernel mode against its plain PyTorch version on
     the card: Kε (level by level, and as the one launch for all levels
     that the main paths make, against its level-by-level plain twin), Kβ
     in build mode and from a carried buffer (with its bound), Kγ and Kζ on
     one 4096-insert batch recorded during the insertion build (its
     pre-batch graph and inputs; Kζ's calls host-inclusive and device-only,
     the whole level-0 apply both ways, and its Kζ calls and Kι sorts,
     which must be 2 and 1; then one seeded Slim search must launch Kξ
     once), Kα (ground truth, the seed block, and a
     12-query server batch over the seed table) and Kβ on the serving
     paths, Kγ on the NND build's and conversion's
     prunes, Kδ on an NND chunk, and on inputs of phases 3 and 4 Kβ over
     CHAL and rank rows, Kβ filtered, Kβ's tag mode at the label cell's
     shapes (all 4096 queries, ef 128, 12 one-hot labels, per-query
     caps), Kε over CHAL and rank rows, Kα in
     strata mode, Kγ guarded (one recorded 8192-row chunk with its live
     guard), and on the SlimQ index Kη on the 4096 queries, the g_add
     table, Kβ quant / quant_ex / rerank on 512 queries at ef 64, Kε quant
     (which scores the entry point itself), Kα in estimate mode and Kα with
     k=1 on one 262144-row KMeans chunk (beside torch.cdist().argmin(); a
     line of its own, it is the same kernel as any k=1 call); both times,
     agreement, and the least time the card could take (bytes over
     3.35 TB/s or fp32 flops over 67 TFLOP/s, the larger);
  8. incremental updates on the insertion index, with their own launch
     counts, through SlimServer(h).update_index without HTTP (1000-vector
     batches into 1M points, the paper's Table 4 deployment): the server's
     IncrementalSlim.full (equal to the conversion of phase 2), three
     add batches drawn around the base's cluster centres (add_points,
     IncrementalSlim.update, the in-place refresh of both dense serving
     layouts, checked against a fresh densify, and the PatchWriter), the
     chunks applied onto a client copy (equal to the server's graph),
     integrity of both indexes, recall@10 at ef=64 against fresh ground
     truth over the grown set and self-hit@1 of the inserted vectors; then
     1000 labels marked deleted and served through filter_mask, their slots
     reused by the next batch (replace_points), and the same round; the incremental graph against convert_to_slim of the
     updated vanilla graph, equal on every row after the add batches with
     nothing repaired and after the replace batch, whose update re-runs the
     connectivity repair; IncrementalSlimZero.full and one update with
     its floor, cap and hierarchy invariants; and Kθ row_deg on the 1M
     level-0 adjacency, Kι (Kκ's ids mode) on a build batch's and an
     update batch's edge list, with payload and key-only (beside
     torch.sort(stable=True)), and Kζ + Kγ on one
     recorded collect-mode apply, against their plain versions;
  9. union and sharded serving, with its own launch counts, on phase 2's
     data and ground truth: 4 round-robin shards of N / 4 points (the
     insertion path's HnswConfig and SlimConfig.from_ratios(); build and
     conversion seconds of each) served as a FlatUnionIndex with dense
     level 0 at seed_width 32 and 32 x 4 (ef 32..256, beside the single
     index of phase 2) and at seed_width 0 (ef 64/128: each query once per
     shard, merged by K19), and as a one-card ShardedSlimIndex with and
     without dense layouts: sharded equal to the host merge of each shard's
     own search and to the union with seed_width 0 (slots equal but for
     near-ties, hops and dcomp the per-shard sums); the same shards as a
     bf16 union (vector bytes exactly half, recall beside the fp32 union);
     shard 0 again with a bf16 store (graph from the fp32 rows, conversion
     over bf16 rows: Kγ's bf16 mode; vanilla and Slim at ef 64 beside the
     fp32 shard); then K19 on the sharded search's [4, 4096, 10] lists
     (beside torch.sort(stable=True) + gather), K1 on the 4096 queries'
     entry distances from both stores (beside the gather + torch.bmm), and
     Kα (strata and exact), Kβ, Kε, Kγ in their bf16 modes, each against
     its plain version;
 11. (run after phase 9, before the summary) the strategy CLI, its tools
     and the reference-graph import, with its own launch counts: phase 2's
     data written as fvecs, strategy.main in process at the reference's
     defaults (--m 30 --ef_construction 128 --ef_search 128 --k 10):
     bruteforce (the 100-NN ground truth, Kα with k = 100 and 128-slot
     lists), hnsw, hnsw_slim built and saved then loaded (--index_dir,
     equal recall), hnsw_slimzero, hnsw_slimq (4 bits) plain and --use_ex,
     each recall beside the same-ef line of phase 2, 3 or 4;
     tools.recall_knn on hnsw_slim's knn ivecs (equal to the CLI's recall)
     and tools.prep_data (100,000 rows, byte-equal) into a dataset of their
     own, with its own ground truth and an hnsw run (NN-descent) under
     --profile_dir, whose Chrome trace must name Kα, Kβ and Kε launches;
     reference dumps (parity/ref_harness.cc's formats) of
     phase 2's Slim graph and of the insertion index's vanilla graph as
     phase 8 left it, imported (slim_index_from_ref, hnsw_index_from_ref)
     and searched at ef 64 bit for bit like the in-memory indexes; then Kξ
     against its plain version on the fp32 store, a bf16 copy and the
     queries (host-inclusive and device-only, beside torch.sum(x * x, -1)
     and torch.linalg.vector_norm),
     and Kα at k = 100 over all queries (ids equal to the CLI's ground
     truth, top 10 equal to phase 2's near-ties aside, 64 queries against
     the plain version, beside a chunked torch.cdist().topk() composite);
 10. Kα's, Kβ's, Kγ's and Kε's main-path launches by shape class (scan
     mode, tile and k; build E 8, upper levels E 1, serving by ef; forward,
     overflow, conversion, NN-descent, and the SlimQ build and update
     rounds apart; a run of levels or one level), summing to their
     launches; output checks (finite, in range, true distances, recall
     sanity, the
     insertion-built Slim index above the NND-built one at ef=320, SlimZero
     within 0.02 of the Slim index there; SlimQ: ids in range, reranked
     distances the true ones, reranked recall not below the estimate-only
     recall, recall not falling with ef, index_size under 0.35 of the raw
     vectors).
Any failed check exits non-zero before the last line, which is
{"ok": true, "device": {...}}. Without a CUDA card it exits 2 at once.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import threading
import time

ROUTES = {  # kernel: (source, the JAX program it replaces)
    "topk_dist": ("hnsw_slim_tpu_torch/csrc/topk_dist.cu",
                  "hnsw_slim_tpu/index/bruteforce.py:85"),
    "beam_search": ("hnsw_slim_tpu_torch/csrc/beam_search.cu",
                    "hnsw_slim_tpu/graph/search.py:297"),
    "rng_prune": ("hnsw_slim_tpu_torch/csrc/rng_prune.cu",
                  "hnsw_slim_tpu/graph/heuristic.py:242"),
    "cand_merge": ("hnsw_slim_tpu_torch/csrc/cand_merge.cu",
                   "hnsw_slim_tpu/graph/nnd.py:45"),
    "greedy_descent": ("hnsw_slim_tpu_torch/csrc/greedy_descent.cu",
                       "hnsw_slim_tpu/graph/search.py:101"),
    "rev_connect": ("hnsw_slim_tpu_torch/csrc/rev_connect.cu",
                    "hnsw_slim_tpu/graph/revconn.py:47"),
    "fht_rotate": ("hnsw_slim_tpu_torch/csrc/fht_rotate.cu",
                   "hnsw_slim_tpu/quant/rotator.py:41"),
    "row_deg": ("hnsw_slim_tpu_torch/csrc/row_deg.cu",
                "hnsw_slim_tpu/index/hnsw.py:39"),
    "point_dist": ("hnsw_slim_tpu_torch/csrc/point_dist.cu",
                   "hnsw_slim_tpu/ops/distance.py:63"),
    "shard_merge": ("hnsw_slim_tpu_torch/csrc/shard_merge.cu",
                    "hnsw_slim_tpu/parallel/sharded.py:287"),
    "radix_sort": ("hnsw_slim_tpu_torch/csrc/radix_sort.cu",
                   "hnsw_slim_tpu/graph/nnd.py:171"),
    "run_scatter": ("hnsw_slim_tpu_torch/csrc/run_scatter.cu",
                    "hnsw_slim_tpu/graph/nnd.py:33"),
    "nnd_cand": ("hnsw_slim_tpu_torch/csrc/nnd_cand.cu",
                 "hnsw_slim_tpu/graph/nnd.py:152"),
    "rp_window": ("hnsw_slim_tpu_torch/csrc/rp_window.cu",
                  "hnsw_slim_tpu/graph/nnd.py:117"),
    "row_norms": ("hnsw_slim_tpu_torch/csrc/row_norms.cu",
                  "hnsw_slim_tpu/ops/distance.py:21"),
    # the reference's patch apply is host numpy, no device program
    "patch_apply": ("hnsw_slim_tpu_torch/csrc/patch_apply.cu",
                    "hnsw_slim_tpu/persist/patch.py:173"),
}
MODE_ROUTES = {  # kernel mode: (kernel, the JAX code that mode replaces)
    "topk_dist.strata": ("topk_dist", "hnsw_slim_tpu/graph/search.py:800"),
    "beam_search.chal": ("beam_search", "hnsw_slim_tpu/graph/search.py:42"),
    "beam_search.rank": ("beam_search", "hnsw_slim_tpu/graph/search.py:67"),
    "beam_search.filtered": ("beam_search",
                             "hnsw_slim_tpu/graph/search.py:279"),
    # per-query label predicates: the JAX package filters a batch by one mask
    "beam_search.tags": ("beam_search", "hnsw_slim_tpu/graph/search.py:279"),
    "greedy_descent.chal": ("greedy_descent",
                            "hnsw_slim_tpu/graph/search.py:42"),
    "greedy_descent.rank": ("greedy_descent",
                            "hnsw_slim_tpu/graph/search.py:67"),
    "rng_prune.guarded": ("rng_prune", "hnsw_slim_tpu/graph/heuristic.py:61"),
    "topk_dist.estimate": ("topk_dist", "hnsw_slim_tpu/index/slimq.py:148"),
    "beam_search.quant": ("beam_search", "hnsw_slim_tpu/index/slimq.py:116"),
    "beam_search.quant_ex": ("beam_search",
                             "hnsw_slim_tpu/quant/estimator.py:56"),
    "beam_search.rerank": ("beam_search", "hnsw_slim_tpu/index/slimq.py:182"),
    "greedy_descent.quant": ("greedy_descent",
                             "hnsw_slim_tpu/index/slimq.py:166"),
    "fht_rotate.g_tables": ("fht_rotate",
                            "hnsw_slim_tpu/quant/estimator.py:79"),
    # bfloat16 store rows: the JAX package upcasts them inside its einsum
    "topk_dist.bf16": ("topk_dist", "hnsw_slim_tpu/ops/distance.py:76"),
    "beam_search.bf16": ("beam_search", "hnsw_slim_tpu/ops/distance.py:76"),
    "greedy_descent.bf16": ("greedy_descent",
                            "hnsw_slim_tpu/ops/distance.py:76"),
    "rng_prune.bf16": ("rng_prune", "hnsw_slim_tpu/ops/distance.py:76"),
    "point_dist.bf16": ("point_dist", "hnsw_slim_tpu/ops/distance.py:76"),
    "run_scatter.dedup": ("run_scatter", "hnsw_slim_tpu/graph/build.py:233"),
    "nnd_cand.join": ("nnd_cand", "hnsw_slim_tpu/graph/nnd.py:179"),
    # Kι: the insert apply's reverse-edge sort on Kκ's ids map
    "radix_sort.ids": ("radix_sort", "hnsw_slim_tpu/graph/revconn.py:90"),
    # Kα with 128-slot lists (64 < k <= 128): the CLI's 100-NN ground truth
    "topk_dist.k128": ("topk_dist", "hnsw_slim_tpu/index/bruteforce.py:85"),
    "row_norms.bf16": ("row_norms", "hnsw_slim_tpu/ops/distance.py:21"),
}
INSERT_PATH = ("topk_dist", "beam_search", "rng_prune", "greedy_descent",
               "rev_connect", "radix_sort.ids", "row_norms")
UPDATE_PATH = ("row_deg", "radix_sort.ids", "rev_connect", "rng_prune",
               "beam_search", "greedy_descent", "topk_dist", "row_norms",
               "patch_apply")
UPD_BATCH = 1000  # vectors per update batch (the paper's Table 4)
SERVER_PATH = ("radix_sort", "run_scatter", "run_scatter.dedup", "nnd_cand",
               "nnd_cand.join", "rp_window", "cand_merge", "rng_prune",
               "topk_dist", "point_dist", "row_deg", "beam_search",
               "beam_search.filtered", "greedy_descent", "radix_sort.ids",
               "rev_connect", "row_norms", "patch_apply")
QUERY_PATH = ("topk_dist", "beam_search", "greedy_descent", "rng_prune",
              "topk_dist.strata", "beam_search.chal", "beam_search.rank",
              "beam_search.filtered", "beam_search.tags", "greedy_descent.chal",
              "greedy_descent.rank", "row_norms")
SLIMZERO_PATH = ("rng_prune", "rng_prune.guarded", "topk_dist", "beam_search",
                 "row_norms")
SLIMQ_PATH = ("fht_rotate", "fht_rotate.g_tables", "topk_dist",
              "topk_dist.estimate", "beam_search.quant",
              "beam_search.quant_ex", "beam_search.rerank",
              "greedy_descent.quant", "greedy_descent.rank", "beam_search",
              "greedy_descent", "rng_prune", "rev_connect", "row_norms")
SHARDS = 4  # round-robin shards of phase 9 (4 x 250,000 at 1M)
HTTP_PROCS = 4  # client processes of the 64-thread /query run
SHARD_PATH = ("topk_dist", "topk_dist.strata", "beam_search",
              "beam_search.chal", "greedy_descent", "greedy_descent.chal",
              "greedy_descent.rank", "rng_prune", "rev_connect",
              "radix_sort.ids", "point_dist", "shard_merge", "topk_dist.bf16",
              "beam_search.bf16", "greedy_descent.bf16", "rng_prune.bf16",
              "point_dist.bf16", "row_norms", "row_norms.bf16")
# phase 11, the strategy CLI at the reference's defaults
CLI_PATH = ("topk_dist", "topk_dist.k128", "row_norms", "beam_search",
            "greedy_descent", "rng_prune", "rng_prune.guarded", "rev_connect",
            "radix_sort.ids", "fht_rotate", "fht_rotate.g_tables",
            "beam_search.quant", "beam_search.quant_ex",
            "beam_search.rerank", "greedy_descent.quant", "beam_search.chal",
            "greedy_descent.chal")
CLI_ARGS = ("--m", "30", "--ef_construction", "128", "--ef_search", "128",
            "--k", "10")
KM_PAIR = "topk_dist k=1 (KMeans assignment)"
SLIMQ_EFS = (32, 64, 128, 256)
EFS = (32, 64, 128, 256, 320)
NQ = 4096
HBM_BPS = 3.35e12  # H100 SXM device memory, bytes/s
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores, flop/s


def say(msg: str) -> None:
    print(msg, flush=True)


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean milliseconds per call on the card (CUDA events, after a warm-up
    call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20, prep=None) -> float:
    """Median milliseconds of the card's work for one call: CUDA events
    around the call, recorded while the card still sleeps
    (``torch.cuda._sleep``, about 1 ms) so that they time the card and not
    the wrapper's host code. ``prep`` (untimed) makes each call's input."""
    import torch

    fn(prep() if prep else None)
    out = []
    for _ in range(reps):
        st = prep() if prep else None
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda._sleep(2_000_000)
        ev[0].record()
        fn(st)
        ev[1].record()
        ev[1].synchronize()
        out.append(ev[0].elapsed_time(ev[1]))
    return statistics.median(out)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(ms, what bounds it): the larger of bytes over the memory rate and
    fp32 operations over the card's fp32 rate."""
    tb, to = nbytes / HBM_BPS * 1e3, flops / FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def sweep_bound(e: int, key_bits: int, payload: bool = True) -> float:
    """ms of Kκ's own traffic at the card's memory rate: 4 B an element for
    its histogram launch, then 16 B an element (8 B key-only) for each of
    its ceil(key_bits / 8) digit passes."""
    return e * (4 + -(-key_bits // 8) * (16 if payload else 8)) / HBM_BPS * 1e3


def sort_launches(fn, key_bits: int, sessions: int = 3) -> dict:
    """The device kernels one call of a Kκ sort launched, by name
    (torch.profiler's device events, after a warm-up call); checks that they
    are Kκ's histogram launch and one launch per 8-bit digit, and nothing
    else. A session that saw fewer of those launches and nothing else is
    one whose profiler dropped device events (seen on the card: a session
    without the first kernel, or without any), and it is profiled again, up
    to ``sessions`` times; any other kernel or any extra launch fails at
    once. Empty without a card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        return {}
    want = {"hist_kernel": 1, "pass_kernel": -(-key_bits // 8)}
    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {}
        for evt in prof.key_averages():
            if "CUDA" in str(getattr(evt, "device_type", "")):
                key = "hist_kernel" if "hist_kernel" in evt.key else \
                    "pass_kernel" if "pass_kernel" in evt.key else evt.key
                names[key] = names.get(key, 0) + evt.count
        if names == want:
            return names
        check(all(k in want and v <= want[k] for k, v in names.items()),
              f"a Kκ sort launched {names}, not {want}")
        say(f"a Kκ sort's profiler session saw {names} of {want}: device "
            "events dropped, profiled again")
    check(False, f"a Kκ sort launched {names}, not {want}, in {sessions} "
                 "profiler sessions")
    return names


def recall(ids, gt) -> float:
    import numpy as np

    k = gt.shape[1]
    hits = sum(len(set(a[:k].tolist()) & set(b.tolist()))
               for a, b in zip(np.asarray(ids), gt))
    return hits / gt.size


def tie_ok(ids_a, ids_b, d_ref, k: int) -> float:
    """Fraction of rows whose top-k id sets agree, counting as agreeing a row
    whose k-th and (k+1)-th reference distances lie within 1e-5 relative
    (d_ref holds k+1 sorted columns)."""
    import numpy as np

    same = np.array([set(a.tolist()) == set(b.tolist())
                     for a, b in zip(ids_a[:, :k], ids_b[:, :k])])
    gap = np.abs(d_ref[:, k] - d_ref[:, k - 1])
    near = gap <= 1e-5 * np.maximum(1.0, np.abs(d_ref[:, k - 1]))
    return float((same | near).mean())


def distinct(ts: list) -> int:
    """How many distinct ids the tensors in ``ts`` hold together: a plain
    run's ``seen`` ids, the rows or vectors its call must read at least
    once."""
    import torch

    return int(torch.unique(torch.cat(ts)).numel()) if ts else 0


def descent_pair(args: tuple, kw: dict, err=None) -> dict:
    """Kε's one-launch descent (greedy_descent_levels) against its
    level-by-level plain twin on the same inputs: agreement of the final
    cur, the largest curdist difference where cur agrees (``err`` of the
    two, default absolute), the share of queries whose cur, hops and dcomp
    all agree (a near-tie that the two sum orders break apart changes the
    rest of a query's walk), both times, and the launch's hops and
    dcomp."""
    import torch

    from hnsw_slim_tpu_torch.graph import search as gs

    k_o = gs.greedy_descent_levels(*args, **kw)
    p_o = gs.greedy_descent_levels_plain(*args, **kw)
    same = k_o[0] == p_o[0]
    e = 0.0
    if same.any():
        e = (err(k_o[1][same], p_o[1][same]) if err else
             float((k_o[1] - p_o[1])[same].abs().max()))
    return dict(
        agree=float(same.float().mean()), max_abs_err=e,
        ms=cuda_ms(lambda: gs.greedy_descent_levels(*args, **kw)),
        plain_ms=cuda_ms(lambda: gs.greedy_descent_levels_plain(*args, **kw),
                         1),
        hops=int(k_o[2].sum()), dcomp=int(k_o[3].sum()),
        path_agree=float((same & (k_o[2] == p_o[2]) & (k_o[3] == p_o[3]))
                         .float().mean()),
        levels=len(args[3]))


def full_batches(n: int, max_batch: int = 4096) -> int:
    """How many insert batches of max_batch points the build makes."""
    done, k = 1, 0
    while done < n:
        b = min(max(1, min(done, max_batch)), n - done)
        k += b == max_batch
        done += b
    return k


MAIN_SHAPES: dict = {}  # Kα-Kε launches of the main paths by shape


def keep_shapes() -> None:
    """Add the launches by shape since the last reset (cuda.launch_shapes)
    to MAIN_SHAPES: called where a path's launch counts are read."""
    from hnsw_slim_tpu_torch.ops import cuda

    for key, v in cuda.launch_shapes.items():
        MAIN_SHAPES[key] = MAIN_SHAPES.get(key, 0) + v


def launch_classes(shapes: dict) -> dict:
    """Kα, Kβ, Kγ and Kε main-path launches by shape class. Kα: its scan
    mode (none, strata, estimate), plan tile and k; Kε: "levels" (one
    launch for a run of levels) or "one level". Kβ: "upper E1" (pop
    width 1: the insertion build's upper levels, a carried buffer), "build
    E8" (pop 8 from one seed inside a tagged build), else "serving ef<ef>".
    Kγ by the tag of the work that ran it: in an insertion build (phase 2,
    shards) the keep-all form is the forward prune and the budget form the
    overflow re-prune; in a conversion every form is the conversion's; in
    the NN-descent server build the keep-all forms are the NN-descent
    prunes and the rest its conversion; the SlimQ build and the update
    rounds mix their forms and are counted apart. Phase 11's launches (tag
    "cli") are a class of their own, Kα's split by shape."""
    out: dict = {}
    for key, v in shapes.items():
        kern, rest = key.split("[", 1)
        tag, shape = rest.split("] ", 1)
        parts = shape.split()
        if tag == "cli":  # phase 11 apart; Kα by its shape there too
            cls = "cli" + (f" {shape}" if kern == "topk_dist" else "")
        elif kern == "beam_search":
            e, ef, seeds = parts[0], parts[1], parts[2]
            cls = ("upper E1" if e == "E1" else
                   f"build {e}" if tag and seeds == "S1" else
                   f"serving {ef}")
        elif kern == "topk_dist":  # scan mode, plan tile and k
            cls = shape
        elif kern == "greedy_descent":  # one launch for a run of levels
            cls = "levels" if parts[0] == "levels" else "one level"
        else:
            keep_all = parts[0].startswith("keep_all")
            cls = {"build": "forward" if keep_all else "overflow",
                   "convert": "conversion",
                   "nnd build": "NND" if keep_all else "conversion",
                   }.get(tag, f"{tag or 'other'}")
        name = f"{kern} {cls}"
        out[name] = out.get(name, 0) + v
    return dict(sorted(out.items()))


class BatchRecorder:
    """Records one 4096-insert batch of the insertion build: wraps
    HnswBuilder's level-0 search (_build_search0) and revconn.apply_insert,
    and on the `which`-th batch of 4096 clones the pre-batch graph, the
    search inputs and the level-0 apply inputs. The wrapped calls run
    unchanged."""

    def __init__(self, which: int, cap0: int):
        self.which, self.cap0 = which, cap0
        self.n_search = self.n_apply = 0
        self.rec: dict = {}

    @contextlib.contextmanager
    def installed(self):
        from hnsw_slim_tpu_torch.graph import build as tb
        from hnsw_slim_tpu_torch.graph import revconn

        s0, ap = tb._build_search0, revconn.apply_insert

        def s0_w(adjs, entry, vectors, vn, q, active, **kw):
            if q.shape[0] == 4096:
                self.n_search += 1
                if self.n_search == self.which:
                    self.rec.update(adjs=[a.clone() for a in adjs],
                                    entry=entry, q=q.clone(),
                                    active=active.clone(), s0_kw=kw)
            return s0(adjs, entry, vectors, vn, q, active, **kw)

        def ap_w(adj, deg, vecs, vn, a_ids, cand, **kw):
            if adj.shape[1] == self.cap0 and a_ids.shape[0] == 4096:
                self.n_apply += 1
                if self.n_apply == self.which:
                    self.rec.update(adj0=adj.clone(), deg0=deg.clone(),
                                    a_ids=a_ids.clone(), cand=cand.clone(),
                                    ap_kw=kw)
            return ap(adj, deg, vecs, vn, a_ids, cand, **kw)

        tb._build_search0, revconn.apply_insert = s0_w, ap_w
        try:
            yield self
        finally:
            tb._build_search0, revconn.apply_insert = s0, ap


def serve_line(idx, queries, gt, label: str, allowed=None,
               need_full: bool = True, **kw) -> dict:
    """One search() configuration as serve_sweep prints it: recall@10
    against ``gt``, QPS (best of 3 after a warm call), hops, dcomp, and the
    split of a call into the card's time (CUDA events around the enqueued
    work) and the rest (host glue: conversions, read-back). With
    ``allowed`` (bool[N]) it also checks that every id is allowed and
    (``need_full``) every row full, and reports the share of full rows.
    Returns the row with the results under "d" and "ids"."""
    import numpy as np
    import torch

    if allowed is not None:
        kw["filter_mask"] = allowed
    d, ids = idx.search(queries, k=10, **kw)
    stats = dict(idx.last_stats)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx.search(queries, k=10, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    search_ms = 1e3 * min(times)
    if hasattr(idx, "search_async"):
        card_ms = cuda_ms(lambda: idx.search_async(queries, 10, **kw))
    else:
        card_ms = None
    row = {"ef": idx.scfg.ef, "recall@10": round(recall(ids, gt), 4),
           "qps": round(len(queries) / min(times), 1),
           "hops": stats["hops"], "dcomp": stats["distance_computations"],
           "search_ms": round(search_ms, 3),
           "card_ms": None if card_ms is None else round(card_ms, 3),
           "glue_ms": None if card_ms is None
           else round(search_ms - card_ms, 3)}
    full = ids >= 0
    if allowed is not None:
        row["full_rows"] = round(float(full.all(axis=1).mean()), 6)
    say(f"{label} {json.dumps(row)}")
    check(d.shape == (len(queries), 10) and ids.shape == d.shape,
          f"{label}: misshapen result")
    if allowed is not None:
        check(full.all() or not need_full,
              f"{label}: a filtered row is not full")
        check(bool(allowed[ids[full]].all()), f"{label}: a returned id is "
                                              "not allowed")
    check(np.isfinite(d[full]).all() and
          (np.diff(np.where(full, d, np.float32(3e38)), axis=1) >= 0).all(),
          f"{label}: distances not finite and ascending")
    row.update(d=d, ids=ids)
    return row


def serve_sweep(idx, queries, gt, base, make_cfg, label: str) -> list:
    """serve_line at each ef of EFS, plus: ids in range, returned distances
    the true ones, a plausible recall sweep. Returns the rows without their
    ids."""
    import numpy as np

    n = len(base)
    rows = []
    for ef in EFS:
        idx.scfg = make_cfg(ef)
        row = serve_line(idx, queries, gt, label)
        d, ids = row.pop("d"), row.pop("ids")
        rows.append(row)
        check(np.isfinite(d).all(), f"{label} ef={ef}: non-finite distances")
        check(((ids >= 0) & (ids < n)).all(), f"{label} ef={ef}: id range")
        true_d = ((queries[:, None, :] - base[ids]) ** 2).sum(-1)
        check(np.allclose(d, true_d, rtol=1e-3, atol=1e-3),
              f"{label} ef={ef}: returned distances are not the true ones")
    rec = [r["recall@10"] for r in rows]
    check(rec[-1] >= 0.5 and rec[-1] >= rec[0] - 0.01,
          f"{label}: recall sweep implausible: {rec}")
    return rows


def same_slots(ids_a, d_a, ids_b, d_b, tol: float = 1e-5) -> float:
    """Share of result slots on which two searches agree: the same distance
    within tol * (1 + |d|) (both missing counts as the same). Where the ids
    differ on such a slot, it is a near-tie the two ordered differently."""
    import numpy as np

    near = np.abs(d_a - d_b) <= tol * (1 + np.abs(d_b))
    gone = np.isinf(d_a) & np.isinf(d_b) & (ids_a == ids_b)
    return float((near | gone).mean())


def shard_phase(base, queries, gt, slim_ins, report, dev) -> tuple:
    """Phase 9: union and sharded serving of SHARDS round-robin shards of
    the base set, with its own launch counts; then K19, K1 and the bf16
    modes of Kα / Kβ / Kε / Kγ against their plain versions on this phase's
    inputs (into ``report``). Returns (summary, the path's launch counts)."""
    import numpy as np
    import torch

    from hnsw_slim_tpu_torch.config import (HnswConfig, SearchConfig,
                                            SlimConfig)
    from hnsw_slim_tpu_torch.graph import heuristic, prune
    from hnsw_slim_tpu_torch.graph import search as gs
    from hnsw_slim_tpu_torch.index import bruteforce as bf
    from hnsw_slim_tpu_torch.index.hnsw import (HnswIndex,
                                                resolve_build_strategy)
    from hnsw_slim_tpu_torch.index.slim import HnswSlimIndex
    from hnsw_slim_tpu_torch.ops import cuda
    from hnsw_slim_tpu_torch.ops import distance as dist
    from hnsw_slim_tpu_torch.parallel import merge
    from hnsw_slim_tpu_torch.parallel.flat_union import FlatUnionIndex
    from hnsw_slim_tpu_torch.parallel.sharded import (ShardedSlimIndex,
                                                      make_mesh)

    n, d = base.shape
    s, k = SHARDS, 10
    n_per = -(-n // s)
    hcfg = HnswConfig(M=30, ef_construction=128)
    strategy = "auto" if resolve_build_strategy("auto", n_per) == "insert" \
        else "insert"
    if strategy != "auto":
        say(f"CUT: shards built with strategy='insert' (auto picks "
            f"NN-descent at {n_per} points)")
    slim_at = {r["ef"]: r for r in slim_ins}
    qall = torch.as_tensor(queries, device=dev)
    qn_all = (qall * qall).sum(1)
    cuda.reset_launches()
    t_phase = time.perf_counter()

    def build_shard(local, cfg):
        """HnswIndex.build and the Slim conversion of one shard, timed."""
        t0 = time.perf_counter()
        hs_ = HnswIndex(cfg, device=dev, strategy=strategy)
        with cuda.tagged("build"):
            hs_.build(local)
        torch.cuda.synchronize()
        t_b = time.perf_counter() - t0
        t0 = time.perf_counter()
        with cuda.tagged("convert"):
            sl = HnswSlimIndex.from_hnsw(hs_, SlimConfig.from_ratios())
        torch.cuda.synchronize()
        return hs_, sl, t_b, time.perf_counter() - t0

    def checked(row, label, store=torch.float32):
        """Pop a serve_line row's results; ids in range, and the distances
        those of the rows as the store holds them."""
        dd, ids = row.pop("d"), row.pop("ids")
        check(((ids >= 0) & (ids < n)).all(), f"{label}: id range")
        rows = torch.as_tensor(base[ids]).to(store).float().numpy()
        true_d = ((queries[:, None, :] - rows) ** 2).sum(-1)
        check(np.allclose(dd, true_d, rtol=1e-3, atol=1e-3),
              f"{label}: returned distances are not the true ones")
        return dd, ids

    # S round-robin shards (global id g on shard g % S), a short shard
    # padded with copies of its row 0 (gid -1), as ShardedSlimIndex.build
    shards, shard_rows = [], []
    for si in range(s):
        gids = np.arange(si, n, s, dtype=np.int32)
        local = base[gids]
        if len(gids) < n_per:
            pad = n_per - len(gids)
            local = np.concatenate([local, np.repeat(local[:1], pad, 0)])
            gids = np.concatenate([gids, np.full(pad, -1, np.int32)])
        hs_, sl, t_b, t_c = build_shard(local, hcfg)
        if si == 0:
            h0, local0 = hs_, local
        shards.append((sl, gids))
        row = {"shard": si, "n": int((gids >= 0).sum()),
               "build_s": round(t_b, 3), "convert_s": round(t_c, 3),
               "max_level": sl.graph.max_level,
               "index_size": sl.index_size()}
        shard_rows.append(row)
        say(f"shard {json.dumps(row)}")

    # the union, seeded: seed_width 32 (32 / S seeds a shard) and 32 * S
    t0 = time.perf_counter()
    u = FlatUnionIndex.from_indexes(shards, device=dev)
    u.densify_level0()
    torch.cuda.synchronize()
    say(f"union: from_indexes + densify_level0 {time.perf_counter() - t0:.2f}"
        f" s, index_size {u.index_size()} B, hbm_bytes {u.hbm_bytes()} B, "
        f"max_level {u.graph.max_level}, {len(u._slim.up_ids)} seed-table "
        f"rows")
    union_rows = {}
    for sw in (32, 32 * s):
        for ef in (32, 64, 128, 256):
            u.scfg = SearchConfig(ef=ef, pop_width=8, seed_width=sw)
            label = f"union seed_width={sw} ef={ef}"
            row = serve_line(u, queries, gt, label)
            checked(row, label)
            row["single_slim"] = {k_: slim_at[ef][k_]
                                  for k_ in ("recall@10", "qps")}
            say(f"  beside the single {n}-point Slim index of phase 2 at "
                f"ef={ef}: {json.dumps(row['single_slim'])}")
            union_rows[label] = row

    # seed_width 0: the union (each query once per shard, K19 merge), the
    # host merge of each shard's own search, and the one-card sharded index
    lmax = max(sl.graph.max_level for sl, _ in shards)
    t0 = time.perf_counter()
    sh = ShardedSlimIndex.from_indexes(make_mesh(s), shards, device=dev)
    torch.cuda.synchronize()
    say(f"sharded: from_indexes {time.perf_counter() - t0:.2f} s, "
        f"index_size {sh.index_size()} B")
    par_rows, ref = {}, {}
    for ef in (64, 128):
        cfg0 = SearchConfig(ef=ef, pop_width=8, seed_width=0)
        u.scfg = cfg0
        label = f"union seed_width=0 ef={ef}"
        ur = serve_line(u, queries, gt, label)
        ud, ui = checked(ur, label)
        par_rows[label] = ur
        cat_d, cat_i, hops, dcomp = [], [], 0, 0
        for sl, gids in shards:
            sl.scfg = cfg0
            a_, b_ = sl.search(queries, k)
            cat_d.append(a_)
            cat_i.append(np.where(b_ >= 0, gids[np.maximum(b_, 0)], -1))
            # the stacked layout walks every level up to the largest
            # max_level: one hop for each empty level above the shard's own
            hops += (sl.last_stats["hops"]
                     + (lmax - sl.graph.max_level) * len(queries))
            dcomp += sl.last_stats["distance_computations"]
        cat_d, cat_i = np.concatenate(cat_d, 1), np.concatenate(cat_i, 1)
        cat_d = np.where(cat_i >= 0, cat_d, np.inf)
        o = np.argsort(cat_d, axis=1, kind="stable")[:, :k]
        ref[ef] = (np.take_along_axis(cat_d, o, 1),
                   np.take_along_axis(cat_i, o, 1), hops, dcomp, ud, ui, ur)
    for lay in ("chal", "dense"):
        if lay == "dense":
            sh.densify_level0()
            sh.densify_upper()
        for ef in (64, 128):
            hd, hi, hops, dcomp, ud, ui, ur = ref[ef]
            sh.scfg = SearchConfig(ef=ef, pop_width=8, seed_width=0)
            label = f"sharded [{lay}] ef={ef}"
            sr = serve_line(sh, queries, gt, label)
            sd_, si_ = checked(sr, label)
            agree = {"host_merge": same_slots(si_, sd_, hi, hd),
                     "host_merge_ids": float((si_ == hi).mean()),
                     "union_sw0": same_slots(si_, sd_, ui, ud),
                     "union_sw0_ids": float((si_ == ui).mean()),
                     "host_hops": hops, "host_dcomp": dcomp}
            sr["agree"] = agree
            par_rows[label] = sr
            say(f"  {label}: {json.dumps(agree)}")
            check(agree["host_merge"] == 1.0 and agree["union_sw0"] == 1.0,
                  f"{label}: differs from the host merge of the per-shard "
                  f"searches or from the union with seed_width 0: {agree}")
            check(sr["hops"] == hops and sr["dcomp"] == dcomp
                  and ur["hops"] == hops and ur["dcomp"] == dcomp,
                  f"{label}: hops / dcomp are not the per-shard sums: "
                  f"{sr['hops']} {sr['dcomp']} {ur['hops']} {ur['dcomp']} "
                  f"{agree}")

    # the bf16 union: the same shards, half the vector bytes
    t0 = time.perf_counter()
    ub = FlatUnionIndex.from_indexes(shards, store_dtype="bfloat16",
                                     device=dev)
    ub.densify_level0()
    torch.cuda.synchronize()
    vb = [x_.vectors.numel() * x_.vectors.element_size() for x_ in (u, ub)]
    say(f"bf16 union: from_indexes + densify_level0 "
        f"{time.perf_counter() - t0:.2f} s, vector bytes {vb[1]} against "
        f"{vb[0]} (fp32), hbm_bytes {ub.hbm_bytes()} against {u.hbm_bytes()}")
    check(2 * vb[1] == vb[0], f"the bf16 union's vectors are not half the "
                              f"bytes: {vb}")
    for sw, ef in ((32, 64), (32, 128), (0, 64)):
        ub.scfg = SearchConfig(ef=ef, pop_width=8, seed_width=sw)
        label = f"bf16 union seed_width={sw} ef={ef}"
        row = serve_line(ub, queries, gt, label)
        checked(row, label, torch.bfloat16)
        fp = (union_rows.get(f"union seed_width={sw} ef={ef}")
              or par_rows[f"union seed_width=0 ef={ef}"])["recall@10"]
        row["fp32_union_recall@10"] = fp
        say(f"  beside the fp32 union: recall@10 {fp}")
        check(row["recall@10"] >= fp - 0.02, f"{label}: recall "
              f"{row['recall@10']} more than 0.02 under the fp32 union's {fp}")
        union_rows[label] = row

    # shard 0 again with a bf16 store: the graph from the fp32 rows, the
    # conversion over bf16 rows (Kγ's bf16 mode), vanilla and Slim at ef 64
    h0b, s0b, t_b, t_c = build_shard(
        local0, dataclasses.replace(hcfg, store_dtype="bfloat16"))
    rows_eq = min(float((a_ == b_).all(1).float().mean())
                  for a_, b_ in zip(h0b.graph.adjs, h0.graph.adjs))
    s0 = shards[0][0]
    for sl in (s0, s0b):
        sl.densify_level0()
    _, gt0 = bf.BruteForceIndex(local0, device=dev).search(queries, k=k)
    bf16_rows = {"build_s": round(t_b, 3), "convert_s": round(t_c, 3),
                 "graph_rows_equal_fp32": rows_eq,
                 "store_bytes": [h0.vectors.nbytes, h0b.vectors.nbytes]}
    for eng, label, scfg in (
            (h0, "fp32 shard 0 vanilla", SearchConfig(ef=64, pop_width=4)),
            (h0b, "bf16 shard 0 vanilla", SearchConfig(ef=64, pop_width=4)),
            (s0, "fp32 shard 0 slim", SearchConfig(ef=64, pop_width=8,
                                                   seed_width=32)),
            (s0b, "bf16 shard 0 slim", SearchConfig(ef=64, pop_width=8,
                                                    seed_width=32))):
        eng.scfg = scfg
        row = serve_line(eng, queries, gt0, label)
        row.pop("d"), row.pop("ids")
        bf16_rows[label] = row
    say(f"bf16 shard 0: {json.dumps(bf16_rows)}")
    check(rows_eq >= 0.99, f"the bf16 shard's graph differs from the fp32 "
                           f"build's on more than 1% of rows: {rows_eq}")
    for what in ("vanilla", "slim"):
        a_, b_ = (bf16_rows[f"{t} shard 0 {what}"]["recall@10"]
                  for t in ("bf16", "fp32"))
        check(a_ >= b_ - 0.02, f"bf16 shard 0 {what}: recall {a_} more than "
                               f"0.02 under the fp32 shard's {b_}")
    launch_par = dict(cuda.launches)
    keep_shapes()
    say(f"shard-path launches: {launch_par}")
    for name in SHARD_PATH:
        check(launch_par[name] > 0, f"{name} never launched on the union / "
                                    "sharded path")
    summary = {"shards": shard_rows, "union": union_rows,
               "sharded": par_rows, "bf16_shard0": bf16_rows,
               "phase_s": round(time.perf_counter() - t_phase, 1)}

    # ---- K19, K1 and the bf16 modes against their plain versions ---------
    # K19: the sharded search's per-shard results at ef 64, [S, NQ, 10]
    sh.scfg = SearchConfig(ef=64, pop_width=8)
    parts = sh._local_search(qall, k)
    margs = (parts[0], parts[1], sh._gid_all, parts[2], parts[3])
    kout, pout = merge.merge_topk(*margs), merge.merge_topk_plain(*margs)
    m_eq = all(torch.equal(a_, b_) for a_, b_ in zip(kout, pout))
    gi = merge._global_ids(parts[1], sh._gid_all)
    cat_d = torch.where(gi >= 0, parts[0], float("inf")).permute(
        1, 0, 2).reshape(NQ, s * k).contiguous()
    cat_i = gi.permute(1, 0, 2).reshape(NQ, s * k).contiguous()

    def lib_merge():
        sd_, o_ = torch.sort(cat_d, dim=1, stable=True)
        return sd_[:, :k], torch.gather(cat_i, 1, o_[:, :k])

    n_ent = parts[0].numel()
    report["shard_merge"] = dict(
        agree=float(m_eq), max_abs_err=float(torch.nan_to_num(
            kout[0] - pout[0], nan=0.0).abs().max()),
        ms=cuda_ms(lambda: merge.merge_topk(*margs), 20),
        plain_ms=cuda_ms(lambda: merge.merge_topk_plain(*margs), 20),
        library_ms=cuda_ms(lib_merge, 20),
        bound=bound(n_ent * 12 + s * NQ * 8 + NQ * k * 8 + NQ * 8, 0),
        shapes=f"[{s}, {NQ}, {k}] per-shard lists of the sharded search at "
               f"ef 64 -> [{NQ}, {k}]; d, global ids, hops and dcomp equal "
               "to the plain version; library: torch.sort(stable=True) + "
               "gather over the gid-mapped concatenation")
    check(m_eq, f"shard_merge differs from its plain version: "
                f"{report['shard_merge']}")

    # K1: the entry distances of the 4096 queries (query b from shard b % S's
    # entry point), from the fp32 and the bf16 union store
    ent = torch.as_tensor(u.entries[np.arange(NQ) % s], dtype=torch.int32,
                          device=dev)[:, None].contiguous()
    for name, uu in (("point_dist", u), ("point_dist.bf16", ub)):
        x_, vn_ = uu.vectors, uu.vn
        kd = dist.gathered_dist(qall, x_, qn=qn_all, vn=vn_, ids=ent)
        pd = dist.gathered_dist_plain(qall, x_, qn=qn_all, vn=vn_, ids=ent)

        def lib_k1(x_=x_):
            rows = x_[ent[:, 0].long()][:, None, :].float()
            return torch.bmm(rows, qall[:, :, None])

        report[name] = dict(
            agree=1.0, max_abs_err=float((kd - pd).abs().max()),
            ms=cuda_ms(lambda: dist.gathered_dist(qall, x_, qn=qn_all,
                                                  vn=vn_, ids=ent), 20),
            plain_ms=cuda_ms(lambda: dist.gathered_dist_plain(
                qall, x_, qn=qn_all, vn=vn_, ids=ent), 20),
            library_ms=cuda_ms(lib_k1, 20),
            bound=bound(NQ * (d * x_.element_size() + 12 + d * 4 + 4),
                        2 * NQ * d),
            shapes=f"{NQ} queries x 1 entry row each of the {x_.dtype} union "
                   "store, by id; library: the row gather + torch.bmm")
        check(report[name]["max_abs_err"]
              <= 1e-4 * (1 + float(pd.abs().max())),
              f"{name} disagrees with its plain version: {report[name]}")

    # Kα bf16: the strata seed block of the bf16 union (32 seeds, S
    # segments), all 4096 queries; and the exact seed block (k=32) of the
    # bf16 shard 0
    up16 = ub._slim._seed_table()
    st = (qall, up16[0], up16[1], up16[2], 32, s)
    ksd, ksi = bf.topk_dist_strata(*st)
    psd, psi = bf.topk_dist_strata_plain(*st)
    fin = torch.isfinite(psd)
    s0_up = s0b._seed_table()
    kxd, kxi = bf.topk_dist(qall, s0_up[0], s0_up[1], 32, row_ids=s0_up[2])
    pxd, pxi = bf.topk_dist_plain(qall, s0_up[0], s0_up[1], 33,
                                  row_ids=s0_up[2])
    agree_x = tie_ok(kxi.cpu().numpy(), pxi.cpu().numpy(), pxd.cpu().numpy(),
                     32)
    rows_up = up16[0].shape[0]
    x_ms = cuda_ms(lambda: bf.topk_dist(qall, s0_up[0], s0_up[1], 32,
                                        row_ids=s0_up[2]))
    report["topk_dist.bf16"] = dict(
        agree=min(float((ksi == psi).float().mean()), agree_x),
        max_abs_err=max(float((ksd - psd)[fin].abs().max()),
                        float((kxd - pxd[:, :32]).abs().max())),
        ms=cuda_ms(lambda: bf.topk_dist_strata(*st)),
        plain_ms=cuda_ms(lambda: bf.topk_dist_strata_plain(*st), 1),
        bound=bound(rows_up * (d * 2 + 8) + NQ * d * 4 + NQ * 32 * 8,
                    2 * NQ * rows_up * d),
        shapes=f"strata: {NQ} x {rows_up} bf16 rows of the union's seed "
               f"table, {s} segments x {32 // s} seeds; exact: {NQ} x "
               f"{s0_up[0].shape[0]} rows of the bf16 shard 0, k=32 (agree "
               f"{agree_x:.4f}, kernel {x_ms:.3f} ms)")
    check(report["topk_dist.bf16"]["agree"] >= 0.99
          and bool(torch.equal(torch.isfinite(ksd), fin)),
          f"topk_dist (bf16) disagrees with its plain version: "
          f"{report['topk_dist.bf16']}")

    # Kβ bf16: the seeded ef=64 beam of the bf16 shard 0 Slim index, 512
    # queries over its dense level-0 rows
    x16, vn16 = s0b.vectors, s0b.vn
    q512, qn512 = qall[:512].contiguous(), qn_all[:512].contiguous()
    sd_, sp_ = bf.topk_dist(q512, *s0_up[:2], 32, row_ids=s0_up[2])
    si_ = torch.where(sp_ >= 0, s0_up[2][sp_.clamp(min=0).long()], -1)
    si_ = torch.where(torch.isinf(sd_), -1, si_).to(torch.int32).contiguous()
    kw_b = dict(P=64, ef_eff=64, pop_width=8,
                cw=gs.cand_width(64, 8, s0b.dense0.shape[1], 0),
                max_iters=SearchConfig(ef=64, pop_width=8).iters(), k=k)
    b_args = (x16, q512, qn512, s0b.dense0, sd_.contiguous(), si_)
    k_o = gs.beam_search(*b_args, **kw_b)
    p_o = gs.beam_search_plain(*b_args, **kw_b, seen=(sn := []))
    same = k_o[1] == p_o[1]
    hops_, dc_ = int(k_o[2].sum()), int(k_o[3].sum())
    report["beam_search.bf16"] = dict(
        agree=float(same.float().mean()),
        max_abs_err=float((k_o[0] - p_o[0])[same & torch.isfinite(
            p_o[0])].abs().max()),
        ms=cuda_ms(lambda: gs.beam_search(*b_args, **kw_b)),
        plain_ms=cuda_ms(lambda: gs.beam_search_plain(*b_args, **kw_b), 1),
        bound=bound(distinct([a for a, _ in sn]) * s0b.dense0.shape[1] * 4
                    + distinct([v for _, v in sn]) * d * 2
                    + 512 * d * 4 + 512 * (k * 8 + 8) + 512 * 32 * 8,
                    dc_ * 4 * d),
        shapes=f"bf16 shard 0 Slim, dense rows, seeded ef=64: 512 queries, "
               f"hops {hops_} vs {int(p_o[2].sum())}, dcomp {dc_} vs "
               f"{int(p_o[3].sum())}")
    check(report["beam_search.bf16"]["agree"] >= 0.99,
          f"beam_search (bf16) disagrees with its plain version: "
          f"{report['beam_search.bf16']}")

    # Kε bf16: the vanilla descent of the bf16 shard 0, levels max..1, all
    # 4096 queries, each level from the plain state
    g0b = h0b.graph
    pc_, pd_ = gs.entry_dist(h0b.vectors, h0b.vn, qall, qn_all, g0b.entry)
    eq_, tot_, err_, kms, pms, byt, flo = 0, 0, 0.0, 0.0, 0.0, 0, 0
    vecs = []  # the ids scored at every level: one store, read once
    for l in range(g0b.max_level, 0, -1):
        st_ = (h0b.vectors, qall, qn_all, g0b.adjs[l], pc_, pd_)
        kc_, kd_, kh_, kdc_ = gs.greedy_descent(*st_)
        kms += cuda_ms(lambda: gs.greedy_descent(*st_))
        pms += cuda_ms(lambda: gs.greedy_descent_plain(*st_), 1)
        npc, npd, _, _ = gs.greedy_descent_plain(*st_, seen=(sn := []))
        same_ = kc_ == npc
        eq_, tot_ = eq_ + int(same_.sum()), tot_ + len(same_)
        if same_.any():
            err_ = max(err_, float((kd_ - npd)[same_].abs().max()))
        byt += distinct([a for a, _ in sn]) * g0b.adjs[l].shape[1] * 4
        vecs += [v for _, v in sn]
        flo += int(kdc_.sum()) * 4 * d
        pc_, pd_ = npc, npd
    byt += distinct(vecs) * d * 2 + NQ * d * 4 + NQ * 16
    c0, d0 = gs.entry_dist(h0b.vectors, h0b.vn, qall, qn_all, g0b.entry)
    fused = descent_pair((h0b.vectors, qall, qn_all,
                          g0b.adjs[g0b.max_level:0:-1], g0b.max_level, c0,
                          d0), {})
    report["greedy_descent.bf16"] = dict(
        agree=min(eq_ / max(1, tot_), fused["agree"]),
        max_abs_err=max(err_, fused["max_abs_err"]), ms=fused["ms"],
        plain_ms=fused["plain_ms"], per_level_ms=kms,
        per_level_plain_ms=pms, fused=fused, bound=bound(byt, flo),
        shapes=f"{NQ} queries, levels {g0b.max_level}..1 of the bf16 shard "
               f"0's vanilla graph: one launch {fused['ms']:.4f} ms, per "
               f"level {kms:.4f} ms")
    check(report["greedy_descent.bf16"]["agree"] >= 0.99
          and fused["path_agree"] >= 0.99,
          f"greedy_descent (bf16) disagrees with its plain version: "
          f"{report['greedy_descent.bf16']}")

    # Kγ bf16: stage 2 of the bf16 shard 0's conversion on 4096 of its
    # level-0 rows (the degree-threshold budgets)
    cfg_s = SlimConfig.from_ratios()
    adj_np = h0b.host_adj()
    thr = prune.degree_thresholds(adj_np, h0b.levels, adj_np[0].shape[1],
                                  cfg_s)
    pick = np.random.default_rng(0).choice(n_per, min(4096, n_per),
                                           replace=False)
    deg_0 = (adj_np[0][pick] >= 0).sum(1)
    budget = torch.as_tensor(np.where(deg_0 > thr[0], cfg_s.top_M0,
                                      cfg_s.low_m0).astype(np.int32),
                             device=dev)
    b_ids = torch.as_tensor(pick.astype(np.int32), device=dev)
    cand = g0b.adjs[0][b_ids.long()].contiguous()
    kw_g = dict(keep_all_under_m=False, keep_pruned=False,
                out_width=cfg_s.top_M0)
    g_args = (h0b.vectors, h0b.vn, b_ids, cand, budget)
    ks, kc = heuristic.rng_prune(*g_args, **kw_g)
    ps, pc = heuristic.rng_prune_plain(*g_args, **kw_g)
    valid = int((cand >= 0).sum())
    report["rng_prune.bf16"] = dict(
        rows_agree=float((ks == ps).all(dim=1).float().mean()),
        counts_agree=float((kc == pc).float().mean()),
        max_abs_err=float((kc - pc).abs().max()),
        ms=cuda_ms(lambda: heuristic.rng_prune(*g_args, **kw_g)),
        plain_ms=cuda_ms(lambda: heuristic.rng_prune_plain(*g_args, **kw_g),
                         1),
        bound=bound(cand.numel() * 4 + valid * (d * 2 + 4)
                    + len(pick) * (d * 2 + 8 + cfg_s.top_M0 * 4),
                    valid * 2 * d),
        shapes=f"bf16 shard 0 conversion stage 2: {len(pick)} rows, C "
               f"{cand.shape[1]}; max_abs_err is the largest kept-count "
               "difference")
    check(report["rng_prune.bf16"]["rows_agree"] >= 0.99
          and report["rng_prune.bf16"]["counts_agree"] >= 0.99,
          f"rng_prune (bf16) disagrees with its plain version: "
          f"{report['rng_prune.bf16']}")
    return summary, launch_par


def same_graph(a_np, n_a, b_np, n_b) -> bool:
    """Two flat CHAL mirrors hold the same logical graph (rows are packed in
    canonical order, so the arrays themselves compare)."""
    import numpy as np

    if n_a != n_b:
        return False
    ea, eb = int(a_np["lvl_off"][n_a - 1, -1]), int(b_np["lvl_off"][n_b - 1,
                                                                     -1])
    return (ea == eb
            and np.array_equal(a_np["level"][:n_a], b_np["level"][:n_b])
            and np.array_equal(a_np["lvl_off"][:n_a], b_np["lvl_off"][:n_b])
            and np.array_equal(a_np["nbr"][:ea], b_np["nbr"][:eb]))


class NndRecorder:
    """Records, during an NN-descent build, the kernel inputs of the warm
    start (nnd.rp_candidates), of the second round's candidate generation
    (nnd._nnd_candidates) and of the level-0 mutual union (the first
    build.mutual_union call over all n nodes), and times HnswIndex.build.
    The wrapped calls run unchanged."""

    def __init__(self, n: int):
        self.n = n
        self.rounds = 0
        self.rec: dict = {}
        self.build_s = None

    @contextlib.contextmanager
    def installed(self):
        import torch

        from hnsw_slim_tpu_torch.graph import build as tb
        from hnsw_slim_tpu_torch.graph import nnd
        from hnsw_slim_tpu_torch.index.hnsw import HnswIndex

        rp, cands, union = nnd.rp_candidates, nnd._nnd_candidates, \
            tb.mutual_union
        build = HnswIndex.build

        def rp_w(proj, n_valid, w, rnd):
            if "rp" not in self.rec:
                self.rec["rp"] = (proj.clone(), n_valid, w, rnd.clone())
            return rp(proj, n_valid, w, rnd)

        def cands_w(ids, newf, n_valid, *, s_fwd, r_rev, draws):
            self.rounds += 1
            if self.rounds == 2:
                self.rec["round"] = (ids.clone(), newf.clone(), n_valid,
                                     s_fwd, r_rev,
                                     tuple(a.clone() for a in draws))
            return cands(ids, newf, n_valid, s_fwd=s_fwd, r_rev=r_rev,
                         draws=draws)

        def union_w(sel, d_sel, *, w_union):
            if "union" not in self.rec and sel.shape[0] == self.n:
                self.rec["union"] = (sel.clone(), d_sel.clone(), w_union)
            return union(sel, d_sel, w_union=w_union)

        def build_w(index, vectors, verbose=False):
            t0 = time.perf_counter()
            build(index, vectors, verbose=verbose)
            torch.cuda.synchronize()
            self.build_s = time.perf_counter() - t0

        nnd.rp_candidates, nnd._nnd_candidates = rp_w, cands_w
        tb.mutual_union, HnswIndex.build = union_w, build_w
        try:
            yield self
        finally:
            nnd.rp_candidates, nnd._nnd_candidates = rp, cands
            tb.mutual_union, HnswIndex.build = union, build


@contextlib.contextmanager
def plain_nnd_twins():
    """Swap every NN-descent sort kernel's wrapper for its plain version
    (Kκ, Kλ both modes, Kμ both modes, Kν), as the CPU route runs them."""
    from hnsw_slim_tpu_torch.graph import build as tb
    from hnsw_slim_tpu_torch.graph import nnd
    from hnsw_slim_tpu_torch.ops import sort

    swaps = [(sort, "kv_radix_sort", sort.kv_radix_sort_plain),
             (nnd, "kv_radix_sort", sort.kv_radix_sort_plain),
             (nnd, "run_scatter", sort.run_scatter_plain),
             (tb, "run_scatter", sort.run_scatter_plain),
             (tb, "dedup_pairs", sort.dedup_pairs_plain),
             (nnd, "rp_window", nnd.rp_window_plain),
             (nnd, "nnd_pivot", nnd.nnd_pivot_plain),
             (nnd, "nnd_join", nnd.nnd_join_plain)]
    saved = [(m, a, getattr(m, a)) for m, a, _ in swaps]
    for m, a, f in swaps:
        setattr(m, a, f)
    try:
        yield
    finally:
        for m, a, f in saved:
            setattr(m, a, f)


PROFILE_GROUPS = (  # (group, regex over a kernel's demangled name)
    ("sorts: Kκ radix_sort", r"hist_kernel|pass_kernel"),
    ("sorts: Kμ run_scatter", r"scatter_kernel\(int|dedup_kernel"),
    ("sorts: Kλ nnd_cand", r"pivot_kernel|join_kernel"),
    ("sorts: Kν rp_window", r"window_kernel"),
    ("Kδ cand_merge", r"(?<![a-z_])merge_kernel"),
    ("Kγ rng_prune", r"prune_kernel"),
    ("Kα topk_dist", r"topk_|strata_sort"),
    ("K1 point_dist", r"point_kernel"),
    ("Kθ row_deg", r"row_deg_kernel"),
)


def profile_nnd_build(base, hcfg, dev) -> dict:
    """One more NN-descent build of ``base`` under torch.profiler: wall
    seconds and device seconds by kernel group (PROFILE_GROUPS; the rest of
    the device events, PyTorch's own kernels, copies and sets, as
    "other device"); host = wall - device busy."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    from hnsw_slim_tpu_torch.index.hnsw import HnswIndex

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    h = HnswIndex(hcfg, strategy="nnd", device=dev)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        h.build(base)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def self_dev_us(evt) -> float:
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(evt, name):
                return float(getattr(evt, name))
        return 0.0

    groups = {g: 0.0 for g, _ in PROFILE_GROUPS}
    groups["other device"] = 0.0
    for e in prof.key_averages():
        us = self_dev_us(e)
        if us <= 0 or "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        g = next((g for g, rx in PROFILE_GROUPS if re.search(rx, e.key)),
                 "other device")
        groups[g] += us / 1e6
    busy = sum(groups.values())
    out = {"wall_s": round(wall, 3), "device_busy_s": round(busy, 3),
           "host_s": round(wall - busy, 3)}
    out.update({g: round(v, 4) for g, v in groups.items()})
    return out


def http_client_proc(port, qs, rows, threads, go, conn) -> None:
    """One HTTP client process of server_phase: imports the client, says
    "ready", waits for ``go``, then ``threads`` threads send qs (strided)
    to /query, each request on its own connection, as SlimClient sends it.
    Sends (rows, latency s, labels i64[len(qs), 10], error strings)."""
    import numpy as np

    from hnsw_slim_tpu_torch.serve.client import SlimClient

    labels = np.full((len(qs), 10), -1, np.int64)
    lat = np.zeros(len(qs))
    errors = []

    def worker(t):
        c = SlimClient(port=port)
        try:
            for i in range(t, len(qs), threads):
                t0 = time.perf_counter()
                dd, ll = c.query(qs[i], k=10)
                lat[i] = time.perf_counter() - t0
                labels[i, :len(ll)] = ll
                if len(ll) != 10 or np.any(np.diff(dd) < 0):
                    errors.append(f"/query {i}: a short or unsorted answer")
        except Exception as e:  # reported to the parent
            errors.append(repr(e))

    conn.send("ready")
    go.wait()
    ts = [threading.Thread(target=worker, args=(t,)) for t in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    conn.send((rows, lat, labels, errors))
    conn.close()


def kpi_pair(graph, chunks, synced) -> dict:
    """Kπ (``persist/patch.py repack``) against its plain version
    (``repack_plain``, on the card) on ``chunks`` staged as ``apply_patch``
    stages them, from ``graph``, chunk after chunk: every array equal
    after each, the last equal to ``synced`` (the copy sync_patches made);
    the timings and the byte bound of the first (largest) chunk."""
    import torch

    from hnsw_slim_tpu_torch.persist import patch as patchlib

    agree, err, first = True, 0.0, None
    for blob in chunks:
        dec = patchlib.decode_records(blob)
        win = patchlib._last_of_each(dec["ids"])
        lmax = max(graph.max_level, int(dec["levels"][win].max(initial=-1)))
        n_total = max(dec["cur_count"], graph.n)
        rec = patchlib.stage_records(dec, lmax, graph.level.device)
        args = (graph, rec, n_total, lmax)
        kout, pout = patchlib.repack(*args), patchlib.repack_plain(*args)
        for a in ("nbr", "lvl_off", "level"):
            ka, pa = getattr(kout, a), getattr(pout, a)
            same = ka.shape == pa.shape
            agree &= same and torch.equal(ka, pa)
            err = max(err, float((ka - pa).abs().max()) if same and
                      ka.numel() else (0.0 if same else float("inf")))
        agree &= (kout.n_real, kout.max_level) == (pout.n_real,
                                                  pout.max_level)
        if first is None:
            moved = (graph.lvl_off.numel() + graph.level.numel()
                     + int(graph.lvl_off[graph.n - 1, -1])
                     + sum(t.numel() for t in rec.values())
                     + kout.lvl_off.numel() + kout.level.numel()
                     + kout.nbr.numel())
            first = dict(
                ms=cuda_ms(lambda: patchlib.repack(*args), 10),
                plain_ms=cuda_ms(lambda: patchlib.repack_plain(*args), 2),
                bound=bound(4 * moved, 0),
                shapes=f"{n_total} nodes, levels 0..{lmax}, one "
                       f"{len(blob)}-byte chunk of {len(dec['ids'])} "
                       "records from /getLastBatch (the warm 1000-vector "
                       "batch), staged as apply_patch stages them; ms: the "
                       "three launches and the one read-back (CUDA "
                       "events); bound: old offsets, levels and ids, the "
                       "records, new offsets, levels and ids, once each")
        graph = kout
    agree &= all(torch.equal(getattr(graph, a), getattr(synced, a))
                 for a in ("nbr", "lvl_off", "level"))
    return dict(first, agree=float(agree), max_abs_err=err,
                chunks=len(chunks))


def server_phase(base, queries, gt, hcfg, make_cfg, report, dev) -> tuple:
    """Phase 6: the HTTP server on an NN-descent-built index, with its own
    launch counts: SlimServer(base, build_strategy="nnd") (the NND build on
    Kν, Kκ, Kλ, Kμ, Kδ, the mutual union on Kκ + Kμ + Kθ, Kγ, Kα, K1),
    integrity, the seeded sweep on server.slim, then over HTTP /setEf, /stats,
    /query from 1 and 64 client threads (latency, QPS, the batches the
    _Batcher formed, recall@10 at ef 64), /getIndex, a cold and a warm
    1000-vector /updateIndex (zlib), /getLastBatch chunks and sync_patches
    onto the bootstrapped client copy (Kπ on the card, three launches a
    chunk; equal to the server's graph and vectors), /markDelete of 1000 labels (none served after), /getIndex and
    /getVectors again. Then, outside the path's counts: at min(n, 100000)
    points the NN-descent build with the kernels against the build with
    every plain twin, row for row; the new kernels against their plain
    versions on the inputs recorded from the server's build (into
    ``report``); and the build once more under torch.profiler. Returns
    (summary, the path's launch counts, the seeded sweep's rows, the NND
    index as it was built: vectors, vn, graph, levels). Kπ is held against
    its plain version on the warm batch's chunks as the copy received
    them."""
    import types

    import numpy as np
    import torch

    from hnsw_slim_tpu_torch.graph import build as tb
    from hnsw_slim_tpu_torch.graph import nnd, revconn
    from hnsw_slim_tpu_torch.index.hnsw import HnswIndex
    from hnsw_slim_tpu_torch.ops import cuda, sort
    from hnsw_slim_tpu_torch.persist import patch as patchlib
    from hnsw_slim_tpu_torch.serve.client import SlimClient
    from hnsw_slim_tpu_torch.serve.server import SlimServer
    from hnsw_slim_tpu_torch.utils.data import clustered

    n = len(base)
    rec = NndRecorder(n)
    cuda.reset_launches()
    t_phase = time.perf_counter()
    with rec.installed(), cuda.tagged("nnd build"):
        server = SlimServer(base, hnsw_cfg=hcfg, build_strategy="nnd",
                            host="127.0.0.1", port=0,
                            patch_chunk_bytes=1 << 20, device=dev)
    torch.cuda.synchronize()
    t_server = time.perf_counter() - t_phase
    h2 = server.hnsw
    # growth makes new tensors, so these objects keep the graph as built
    built = types.SimpleNamespace(vectors=h2.vectors, vn=h2.vn,
                                  graph=h2.graph, levels=h2.levels)
    t_build = rec.build_s
    t_conv = t_server - t_build
    integ = {"hnsw": h2.check_integrity(),
             "slim": server.slim.check_integrity()}
    say(f"server nnd: SlimServer {t_server:.2f} s = NND build {t_build:.2f} "
        f"s + IncrementalSlim.full and layouts {t_conv:.2f} s (full split "
        f"{json.dumps({k: round(v, 3) for k, v in server.inc.last_stats['seconds'].items() if v >= 0.05})}"
        f"), NND rounds {rec.rounds}, index_size {server.slim.index_size()} "
        f"B, max_level {h2.graph.max_level}, integrity {integ}")
    slim_nnd = serve_sweep(server.slim, queries, gt, base, make_cfg,
                           "slim(nnd) server.slim")

    # ---- over HTTP: the server's Slim index keeps the sweep's knobs
    # (seed_width 32, pop 8); /setEf sets ef
    server.slim.scfg = make_cfg(64)
    server.start_background()
    port = server._httpd.server_address[1]
    client = SlimClient(port=port)
    check(client.set_ef(64), "/setEf did not answer ok with ef 64")
    stats0 = client.stats()
    check(stats0["n"] == n, f"/stats: {stats0}")

    def http_run(threads: int, qs) -> dict:
        """qs through /query from ``threads`` client threads in client
        processes of their own (one, or HTTP_PROCS of threads / HTTP_PROCS
        each, so that the clients do not share the server's interpreter):
        per-request latency, QPS from the start signal to the last answer,
        the batches the _Batcher formed, and the labels (numpy
        [len(qs), 10])."""
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        procs = 1 if threads == 1 else HTTP_PROCS
        go = ctx.Event()
        jobs = []
        for p_ in range(procs):
            rx, tx = ctx.Pipe(duplex=False)
            rows = np.arange(p_, len(qs), procs)
            pr = ctx.Process(target=http_client_proc,
                             args=(port, qs[rows], rows, threads // procs, go,
                                   tx))
            pr.start()
            jobs.append((pr, rx))
        for _, rx in jobs:  # each process has imported the client
            check(rx.poll(300) and rx.recv() == "ready",
                  "an HTTP client process did not start")
        server.batcher.batch_sizes.clear()
        labels = np.full((len(qs), 10), -1, np.int64)
        lat = np.zeros(len(qs))
        errors = []
        t0 = time.perf_counter()
        go.set()
        for _, rx in jobs:
            check(rx.poll(900), "an HTTP client process did not answer")
            rows, lat_p, lab_p, err_p = rx.recv()
            lat[rows], labels[rows] = lat_p, lab_p
            errors += err_p
        wall = time.perf_counter() - t0
        for pr, _ in jobs:
            pr.join(60)
        check(not errors, f"/query from {threads} threads: {errors[:1]}")
        sizes = np.asarray(server.batcher.batch_sizes)
        return {"threads": threads, "processes": procs, "queries": len(qs),
                "p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 3),
                "p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 3),
                "qps": round(len(qs) / wall, 1),
                "batches": int(len(sizes)),
                "batch_mean": round(float(sizes.mean()), 2),
                "batch_max": int(sizes.max()), "labels": labels}

    _, ref = server.search(queries, 10)  # one batch of all the queries
    http = {}
    for threads, nq_ in ((1, 512), (64, len(queries))):
        row = http_run(threads, queries[:nq_])
        lab = row.pop("labels")
        row["recall@10"] = round(recall(lab, gt[:nq_]), 4)
        row["rows_as_one_batch"] = round(float(
            (lab == ref[:nq_]).all(axis=1).mean()), 4)
        http[f"threads_{threads}"] = row
        say(f"server /query ef=64: {json.dumps(row)}")
        check(row["rows_as_one_batch"] >= 0.99,
              f"the HTTP answers from {threads} threads are not the ids of "
              f"one batched search: {row['rows_as_one_batch']}")

    # ---- /getIndex, two 1000-vector updates, patch sync onto the copy
    t0 = time.perf_counter()
    local = client.bootstrap(device=dev)
    t_boot = time.perf_counter() - t0
    check(same_graph(patchlib.to_np(local.graph), local.graph.n,
                     patchlib.to_np(server.chal_unpadded), n),
          "/getIndex: the bootstrapped copy differs from the server's graph")
    extra, _ = clustered(2 * UPD_BATCH, 128, n_queries=0,
                         n_clusters=max(64, n // 1000), seed=7, scale=0.3)
    chunks = []
    fetch = client.get_last_batch

    def counted():
        blob, fin = fetch()
        chunks.append(blob)
        return blob, fin

    client.get_last_batch = counted
    upd = []
    ef64_recall = slim_nnd[EFS.index(64)]["recall@10"]
    for b_ in range(2):
        lo = n + b_ * UPD_BATCH
        vecs = extra[b_ * UPD_BATCH:(b_ + 1) * UPD_BATCH]
        chunks.clear()
        t0 = time.perf_counter()
        blob, fin = client.update_index(range(lo, lo + UPD_BATCH), vecs)
        t_http = time.perf_counter() - t0
        chunks.append(blob)
        ust = h2.last_update_stats
        pre, kpi0 = local.graph, cuda.launches["patch_apply"]
        t0 = time.perf_counter()
        local = client.sync_patches(local, blob, fin)
        torch.cuda.synchronize()
        t_sync = time.perf_counter() - t0
        kpi_launches = cuda.launches["patch_apply"] - kpi0
        kpi_in = (pre, list(chunks), local.graph)
        n_now = h2.graph.n
        equal = (same_graph(patchlib.to_np(local.graph), local.graph.n,
                            server.inc.host_chal, n_now)
                 and torch.equal(local.vectors.cpu(), torch.as_tensor(
                     server.vectors_np[:n_now])))
        n_hit = min(256, len(vecs))
        _, hit = server.slim.search(vecs[:n_hit], k=1)
        row = {"batch": "cold" if b_ == 0 else "warm", "n": n_now,
               "update_http_s": round(t_http, 3),
               "insert_s": round(sum(ust["seconds"].values()), 3),
               "inc_update_s": round(sum(
                   server.inc.last_stats["seconds"].values()), 3),
               "patch_bytes": sum(len(c_) for c_ in chunks),
               "patch_chunks": len(chunks),
               "sync_patches_s": round(t_sync, 3),
               "patch_apply_launches": kpi_launches,
               "client_equals_server": bool(equal),
               "self_hit@1": round(float(
                   (hit[:, 0] == np.arange(lo, lo + n_hit)).mean()), 4)}
        say(f"server /updateIndex: {json.dumps(row)}")
        check(equal, f"{row['batch']} update: the patched client differs "
                     "from the server's graph or vectors")
        check(kpi_launches == 3 * len(chunks) and local.graph.nbr.is_cuda,
              f"{row['batch']} update: the copy was not patched on the card "
              f"by Kπ ({kpi_launches} launches for {len(chunks)} chunks)")
        check(row["self_hit@1"] >= ef64_recall - 0.05,
              f"{row['batch']} update: self-hit@1 {row['self_hit@1']} more "
              f"than 0.05 under the index's recall@10 {ef64_recall} at ef 64")
        upd.append(row)
    client.get_last_batch = fetch

    # ---- /markDelete of 1000 labels, served through filter_mask
    dead = np.random.default_rng(29).choice(n, UPD_BATCH, replace=False)
    check(client.mark_delete(dead) == UPD_BATCH, "/markDelete count")
    row = http_run(64, queries[:1024])
    lab = row.pop("labels")
    check((lab >= 0).all() and not np.isin(lab, dead).any(),
          "a deleted label was served, or an answer was short")
    row["recall@10_pre_delete_gt"] = round(recall(lab, gt[:1024]), 4)
    say(f"server /query after /markDelete of {UPD_BATCH} labels: "
        f"{json.dumps(row)}")
    http["after_delete"] = row
    t0 = time.perf_counter()
    again = client.bootstrap(device=dev)
    t_boot2 = time.perf_counter() - t0
    n_now = h2.graph.n
    check(same_graph(patchlib.to_np(again.graph), again.graph.n,
                     server.inc.host_chal, n_now),
          "/getIndex after the updates differs from the server's graph")
    got = client.get_vectors(n_now - UPD_BATCH - 5, 2 * UPD_BATCH)
    check(got.shape == (UPD_BATCH + 5, 128) and np.array_equal(
        got, server.vectors_np[n_now - UPD_BATCH - 5:n_now]),
        "/getVectors rows differ from the server's vectors")
    launch_srv = dict(cuda.launches)
    keep_shapes()
    cost = {k: round(v, 3) if isinstance(v, float) else v
            for k, v in server.query_cost.items()}
    say(f"server-path launches: {launch_srv}")
    for name in SERVER_PATH:
        check(launch_srv[name] > 0, f"{name} never launched on the server "
                                    "path")
    check(launch_srv["nnd_cand"] > launch_srv["nnd_cand.join"]
          and launch_srv["run_scatter"] > launch_srv["run_scatter.dedup"],
          "nnd_cand's pivot mode or run_scatter's scatter mode never "
          "launched on the server path")
    server.shutdown()
    report["patch_apply"] = kpi_pair(*kpi_in)
    say(f"kernel patch_apply: {json.dumps(report['patch_apply'])}")
    check(report["patch_apply"]["agree"] == 1.0,
          f"patch_apply differs from its plain version on the warm batch's "
          f"chunks: {report['patch_apply']}")
    summary = {"n": n, "server_s": round(t_server, 2),
               "build_s": round(t_build, 2), "convert_s": round(t_conv, 2),
               "nnd_rounds": rec.rounds, "integrity": integ,
               "index_size": server.slim.index_size(), "slim": slim_nnd,
               "http": http, "query_cost": cost,
               "bootstrap_s": [round(t_boot, 3), round(t_boot2, 3)],
               "updates": upd}
    del server, local, again

    # ---- the build with the kernels against the build with the twins
    n_par = min(n, 100_000)
    adjs = []
    for twins in (False, True):
        with plain_nnd_twins() if twins else contextlib.nullcontext():
            t0 = time.perf_counter()
            hp = HnswIndex(hcfg, strategy="nnd", device=dev)
            hp.build(base[:n_par])
            torch.cuda.synchronize()
            adjs.append(([a.clone() for a in hp.graph.adjs],
                         time.perf_counter() - t0))
        del hp
    eq = len(adjs[0][0]) == len(adjs[1][0]) and all(
        torch.equal(a, b) for a, b in zip(adjs[0][0], adjs[1][0]))
    summary["twin_build"] = {"n": n_par, "equal": bool(eq),
                             "levels": len(adjs[0][0]),
                             "kernels_s": round(adjs[0][1], 2),
                             "twins_s": round(adjs[1][1], 2)}
    say(f"NND build at {n_par} with the kernels against the plain twins: "
        f"{json.dumps(summary['twin_build'])}")
    check(eq, f"the {n_par}-point NND build with the kernels differs from "
              "the build with the plain twins")
    del adjs

    # ---- the new kernels against their plain versions, real inputs
    ids, newf, n_valid, s_fwd, r_rev, draws = rec.rec["round"]
    rand_key, r2, r3, r4 = draws
    nn, k = ids.shape
    c = 2 * s_fwd + r_rev
    tgt_s = torch.where(ids >= 0, ids, nn).reshape(-1).contiguous()
    src = torch.arange(nn, dtype=torch.int32,
                       device=dev).repeat_interleave(k)
    bits = nn.bit_length()
    e_ = tgt_s.numel()
    st, ss = sort.kv_radix_sort(tgt_s, src, bits)
    pst, pss = sort.kv_radix_sort_plain(tgt_s, src, bits)
    passes = -(-bits // 8)
    report["radix_sort"] = dict(
        agree=float(torch.equal(st, pst) and torch.equal(ss, pss)),
        max_abs_err=0.0,
        ms=cuda_ms(lambda: sort.kv_radix_sort(tgt_s, src, bits), 5),
        plain_ms=cuda_ms(lambda: sort.kv_radix_sort_plain(tgt_s, src, bits),
                         3),
        library_ms=cuda_ms(lambda: src[torch.sort(tgt_s, stable=True)[1]],
                           3),
        bound=bound(e_ * 16, 0), sweep_bound_ms=sweep_bound(e_, bits),
        device_launches=sort_launches(
            lambda: sort.kv_radix_sort(tgt_s, src, bits), bits))
    check(report["radix_sort"]["agree"] == 1.0,
          "radix_sort differs from its plain version on the reverse edges")
    # the same E with all keys equal (one digit run through every tile: the
    # longest look-back chain) and with strictly descending keys
    adversarial = {}
    for what, keys_, bits_ in (
            ("all equal", torch.full_like(tgt_s, nn // 2), bits),
            ("descending", torch.arange(e_ - 1, -1, -1, dtype=torch.int32,
                                        device=dev), e_.bit_length())):
        ak_, ap_ = sort.kv_radix_sort(keys_, src, bits_)
        pk_, pp_ = sort.kv_radix_sort_plain(keys_, src, bits_)
        adversarial[what] = dict(
            E=e_, key_bits=bits_,
            equal=bool(torch.equal(ak_, pk_) and torch.equal(ap_, pp_)),
            ms=cuda_ms(lambda: sort.kv_radix_sort(keys_, src, bits_), 3),
            library_ms=cuda_ms(
                lambda: src[torch.sort(keys_, stable=True)[1]], 3),
            sweep_bound_ms=sweep_bound(e_, bits_))
        say(f"kernel radix_sort on {what} keys: "
            f"{json.dumps(adversarial[what])}")
        check(adversarial[what]["equal"], f"radix_sort differs from its "
                                          f"plain version on {what} keys")
        del ak_, ap_, pk_, pp_, keys_
    report["radix_sort"]["adversarial"] = adversarial
    # the warm start's f32 keys and the level-0 union's lexsorts
    proj, rp_valid, w, rnd = rec.rec["rp"]
    iota = torch.arange(nn, dtype=torch.int32, device=dev)
    key0 = torch.where(iota < rp_valid, proj[:, 0], float("inf")).contiguous()
    fk, fo = sort.kv_radix_sort(key0, iota, 32, "f32")
    pfk, pfo = sort.kv_radix_sort_plain(key0, iota, 32, "f32")
    f_ms = cuda_ms(lambda: sort.kv_radix_sort(key0, iota, 32, "f32"), 10)
    f_lib = cuda_ms(lambda: torch.sort(key0, stable=True), 10)
    f_launch = sort_launches(
        lambda: sort.kv_radix_sort(key0, iota, 32, "f32"), 32)
    sel, d_sel, w_union = rec.rec["union"]
    ku, kc = tb.mutual_union(sel, d_sel, w_union=w_union)
    with plain_nnd_twins():
        pu, pc = tb.mutual_union(sel, d_sel, w_union=w_union)
        u_plain = cuda_ms(lambda: tb.mutual_union(sel, d_sel,
                                                  w_union=w_union), 3)
    u_ms = cuda_ms(lambda: tb.mutual_union(sel, d_sel, w_union=w_union), 3)
    eq_f = torch.equal(fo, pfo) and torch.equal(fk.view(torch.int32),
                                                pfk.view(torch.int32))
    eq_u = torch.equal(ku, pu) and torch.equal(kc, pc)
    # Kι's device launches at a 4096-insert build batch's shape (E = 4096 M
    # ids below n and its key bits, the ids map), counted here: on the card
    # a profiler session in the update phase, after the profiled build
    # below, saw no device events at all
    e_i = min(e_, 4096 * hcfg.M)
    ids_k, ids_p = tgt_s[:e_i].contiguous(), src[:e_i].contiguous()
    report["radix_sort"]["ids_launches"] = dict(
        E=e_i, key_bits=bits, launches=sort_launches(
            lambda: revconn.kv_sort(ids_k, ids_p, nn), bits))
    report["radix_sort"]["f32"] = dict(
        E=nn, ms=f_ms, library_ms=f_lib, equal=bool(eq_f),
        bound_ms=bound(nn * 16, 0)[0], sweep_bound_ms=sweep_bound(nn, 32),
        device_launches=f_launch)
    report["radix_sort"]["shapes"] = (
        f"E {e_} (target, source) pairs of NND round 2, {bits}-bit keys, "
        f"1 + {passes} launches (the one-sweep form moves 4 + {passes} x 16 "
        f"B an element: {sweep_bound(e_, bits):.4f} ms); rp_init's f32 "
        f"keys E {nn} (1 + 4 launches): {f_ms:.4f} ms vs torch.sort "
        f"{f_lib:.4f} ms, equal {eq_f}; the level-0 mutual_union (E "
        f"{2 * sel.numel()}, two lexsorts, dedup, scatter, counts): "
        f"{u_ms:.4f} ms vs the plain twins {u_plain:.4f} ms, rows and counts "
        f"equal {eq_u}")
    check(eq_f and eq_u, "radix_sort on f32 keys or the mutual union "
                         "differs from its plain version")

    # Kμ scatter: the round's reverse samples; dedup: the union's pairs
    rev = sort.run_scatter(st, ss, nn, r_rev, n_valid)
    prev = sort.run_scatter_plain(st, ss, nn, r_rev, n_valid)
    report["run_scatter"] = dict(
        agree=float(torch.equal(rev, prev)), max_abs_err=0.0,
        ms=cuda_ms(lambda: sort.run_scatter(st, ss, nn, r_rev, n_valid), 5),
        plain_ms=cuda_ms(lambda: sort.run_scatter_plain(st, ss, nn, r_rev,
                                                        n_valid), 3),
        bound=bound(e_ * 8 + rev.numel() * 4, 0),
        shapes=f"E {e_} sorted pairs -> rev i32[{nn}, {r_rev}]")
    n_u = sel.shape[0]
    src1 = torch.arange(n_u, dtype=torch.int32,
                        device=dev).repeat_interleave(sel.shape[1])
    tgt1 = sel.reshape(-1)
    ok = torch.cat([tgt1 >= 0] * 2)
    src_m = torch.where(ok, torch.cat([src1, tgt1]), n_u).contiguous()
    tgt_m = torch.where(ok, torch.cat([tgt1, src1]), n_u).contiguous()
    s1, o = sort.lexsort_stable(src_m, tgt_m, n_u.bit_length())
    t1s = torch.index_select(tgt_m, 0, o)
    dk = sort.dedup_pairs(s1, t1s, n_u)
    report["run_scatter.dedup"] = dict(
        agree=float(torch.equal(dk, sort.dedup_pairs_plain(s1, t1s, n_u))),
        max_abs_err=0.0,
        ms=cuda_ms(lambda: sort.dedup_pairs(s1, t1s, n_u), 10),
        plain_ms=cuda_ms(lambda: sort.dedup_pairs_plain(s1, t1s, n_u), 10),
        bound=bound(s1.numel() * 12, 0),
        shapes=f"E {s1.numel()} (src, tgt) pairs of the level-0 union")
    for key_ in ("run_scatter", "run_scatter.dedup"):
        check(report[key_]["agree"] == 1.0,
              f"{key_} differs from its plain version")

    # Kλ pivot and join modes on the recorded round
    def pivot(fn):
        cand = torch.full((nn, c), -7, dtype=torch.int32, device=dev)
        return fn(ids, newf, rand_key, r2, cand), cand

    fk_, ck_ = pivot(nnd.nnd_pivot)
    fp_, cp_ = pivot(nnd.nnd_pivot_plain)
    report["nnd_cand"] = dict(
        agree=float(torch.equal(fk_, fp_) and torch.equal(ck_, cp_)),
        max_abs_err=0.0, ms=cuda_ms(lambda: pivot(nnd.nnd_pivot), 5),
        plain_ms=cuda_ms(lambda: pivot(nnd.nnd_pivot_plain), 3),
        bound=bound(ids.numel() * 16 + r2.numel() * (8 + 4 + 4), 0),
        shapes=f"{nn} rows, k {k}, s_fwd {s_fwd} (pivot mode; ms include "
               "the -1 fill of the candidate buffer)")

    def join(fn):
        cand = torch.full((nn, c), -7, dtype=torch.int32, device=dev)
        fn(ids, rev, r3, r4, cand)
        return cand

    report["nnd_cand.join"] = dict(
        agree=float(torch.equal(join(nnd.nnd_join),
                                join(nnd.nnd_join_plain))),
        max_abs_err=0.0, ms=cuda_ms(lambda: join(nnd.nnd_join), 5),
        plain_ms=cuda_ms(lambda: join(nnd.nnd_join_plain), 3),
        bound=bound(rev.numel() * 8 + r3.numel() * (16 + 4 + 4), 0),
        shapes=f"{nn} rows, r_rev {r_rev}, s_fwd {s_fwd}")
    # Kν on the warm start's four orders
    orders = torch.stack([sort.kv_radix_sort(
        torch.where(iota < rp_valid, proj[:, p], float("inf")).contiguous(),
        iota, 32, "f32")[1] for p in range(proj.shape[1])])
    kw_ = nnd.rp_window(orders, rnd, rp_valid, w)
    report["rp_window"] = dict(
        agree=float(torch.equal(kw_, nnd.rp_window_plain(orders, rnd,
                                                          rp_valid, w))),
        max_abs_err=0.0,
        ms=cuda_ms(lambda: nnd.rp_window(orders, rnd, rp_valid, w), 10),
        plain_ms=cuda_ms(lambda: nnd.rp_window_plain(orders, rnd, rp_valid,
                                                     w), 3),
        bound=bound(orders.numel() * 4 + rnd.numel() * 8 + kw_.numel() * 4,
                    0),
        shapes=f"{proj.shape[1]} orders of {nn}, w {w}, random fill "
               f"{rnd.shape[1]} -> i32[{nn}, {kw_.shape[1]}]")
    for key_ in ("nnd_cand", "nnd_cand.join", "rp_window"):
        check(report[key_]["agree"] == 1.0,
              f"{key_} differs from its plain version")
    del rec
    summary["profile"] = profile_nnd_build(base, hcfg, dev)
    say(f"NND build under torch.profiler: {json.dumps(summary['profile'])}")
    summary["phase_s"] = round(time.perf_counter() - t_phase, 1)
    return summary, launch_srv, slim_nnd, built


def _runs(counts):
    """(owner, position) of every element of runs of the given lengths."""
    import numpy as np

    owner = np.repeat(np.arange(len(counts)), counts)
    starts = np.cumsum(counts) - counts
    return owner, np.arange(len(owner)) - starts[owner]


def write_slim_dump(path, nbr, lvl_off, level, *, entry, max_level,
                    threshold_level, cap, cap0) -> None:
    """A CHAL graph in parity/ref_harness.cc's dump_slim_graph format:
    header, then per node its level, its total neighbour count, the end
    offset of each of its levels 0..level, and its ids."""
    import struct

    import numpy as np

    nbr, level = np.asarray(nbr), np.asarray(level, np.int64)
    off = np.asarray(lvl_off, np.int64)
    n = len(level)
    start = off[:, 0]
    ends = off[:, 1:] - start[:, None]
    total = ends[np.arange(n), level]
    words = 3 + level + total
    at = np.cumsum(words) - words
    out = np.empty(int(words.sum()), np.int32)
    out[at], out[at + 1] = level, total
    v, l_ = _runs(level + 1)
    out[at[v] + 2 + l_] = ends[v, l_]
    v, j = _runs(total)
    out[at[v] + 3 + level[v] + j] = nbr[start[v] + j]
    with open(path, "wb") as f:
        f.write(struct.pack("<IIiIiII", 0x48534C47, n, max_level, entry,
                            threshold_level, cap, cap0))
        f.write(out.tobytes())


def write_hnsw_dump(path, adjs, level, *, entry, max_level, maxm,
                    maxm0) -> None:
    """A per-level adjacency (rows -1 padded) in dump_hnsw_graph's format:
    header, then per node its level and, for each level 0..level, the count
    of its ids and the ids."""
    import struct

    import numpy as np

    level = np.asarray(level, np.int64)
    n = len(level)
    cnt = np.zeros((n, max_level + 1), np.int64)
    for l_, a in enumerate(adjs):
        cnt[level >= l_, l_] = (np.asarray(a)[level >= l_] >= 0).sum(1)
    per_level = np.where(np.arange(max_level + 1)[None] <= level[:, None],
                         1 + cnt, 0)
    words = 1 + per_level.sum(1)
    at = np.cumsum(words) - words
    out = np.empty(int(words.sum()), np.int32)
    out[at] = level
    before = 1 + np.cumsum(per_level, axis=1) - per_level
    for l_, a in enumerate(adjs):
        rows = np.nonzero(level >= l_)[0]
        pos = at[rows] + before[rows, l_]
        out[pos] = cnt[rows, l_]
        a = np.asarray(a)[rows]
        keep = a >= 0
        col = np.cumsum(keep, axis=1) - 1
        r, c = np.nonzero(keep)
        out[pos[r] + 1 + col[r, c]] = a[r, c]
    with open(path, "wb") as f:
        f.write(struct.pack("<IIiIII", 0x484E5347, n, max_level, entry, maxm,
                            maxm0))
        f.write(out.tobytes())


def cli_phase(base, queries, gt, h, idx, lines, report, dev) -> tuple:
    """Phase 11: the strategy CLI (hnsw_slim_tpu_torch.strategy.main, in
    process) on phase 2's data written as fvecs, at the reference's
    defaults, with its own launch counts: bruteforce (the 100-NN ground
    truth on Kα with k = 100), hnsw, hnsw_slim built and saved then loaded
    again (--index_dir), hnsw_slimzero, hnsw_slimq plain and with --use_ex;
    the tools (recall_knn on the knn ivecs hnsw_slim wrote; prep_data
    slicing 100,000 rows into a dataset of their own, which gets its own
    ground truth and the profiled hnsw run, NN-descent at that size); the
    import of reference dumps of phase 2's Slim graph and of the insertion
    index's vanilla graph (as phase 8 left it), searched at ef 64 bit for
    bit like the in-memory indexes. ``lines`` holds the earlier phases'
    rows at ef 128 that each CLI recall is printed beside: hnsw must come
    within 0.01 of vanilla's, hnsw_slim (seed_width 0, CHAL rows) within
    0.02 of phase 3's seed_width=0 line; SlimZero and SlimQ, which no
    earlier phase serves at seed_width 0, above 0.1 (random ids score
    1e-5). Then, outside the counts, Kξ against its plain version on the
    fp32 store, a bf16 copy and the queries, and Kα at k = 100 against its
    plain version and beside a chunked torch.cdist().topk() composite.
    Returns (summary, launches)."""
    import io
    import shutil
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from hnsw_slim_tpu_torch import strategy, tools
    from hnsw_slim_tpu_torch.config import SearchConfig
    from hnsw_slim_tpu_torch.graph import import_ref
    from hnsw_slim_tpu_torch.index import bruteforce as bf
    from hnsw_slim_tpu_torch.ops import cuda
    from hnsw_slim_tpu_torch.ops import distance as dist
    from hnsw_slim_tpu_torch.utils.io import read_ivecs, write_fvecs

    t_phase = time.perf_counter()
    n, d = base.shape
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = Path(tmp_dir.name)
    data = tmp / "data"
    files = data / "smoke"
    files.mkdir(parents=True)
    t0 = time.perf_counter()
    write_fvecs(files / "smoke_base.fvecs", base)
    write_fvecs(files / "smoke_query.fvecs", queries)
    say(f"cli: {n} x {d} base and {len(queries)} queries written as fvecs "
        f"in {time.perf_counter() - t0:.2f} s")
    rows = {}

    def quiet(fn, *a):
        """fn(*a) with its printed lines kept: (result, {key: value})."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = fn(*a)
        lines = (ln.partition(": ") for ln in buf.getvalue().splitlines())
        return out, {k_: v_ for k_, _, v_ in lines if v_}

    def cli(label, *argv, dataset="smoke"):
        """strategy.main on a dataset's fvecs files; the row of what it
        printed."""
        t0 = time.perf_counter()
        r, printed = quiet(strategy.main, ["--dataset", dataset, "--data_dir",
                                           str(data), *argv])
        printed.pop("Recall", None)  # the value main returns
        rows[label] = {"seconds": round(time.perf_counter() - t0, 2),
                       "recall@10": r, **printed}
        say(f"cli {label}: {json.dumps(rows[label])}")
        return r

    def beside(label, key, tol):
        """The CLI's recall@10 beside the ef-128 line of an earlier phase,
        within tol of it."""
        r, ref = rows[label]["recall@10"], lines[key]["recall@10"]
        rows[label][f"{key} line recall@10"] = ref
        check(abs(r - ref) <= tol, f"cli {label}: recall@10 {r} is not "
                                   f"within {tol} of the {key} line's {ref}")

    from hnsw_slim_tpu_torch.index.hnsw import resolve_build_strategy

    args = tuple(CLI_ARGS)
    if resolve_build_strategy("auto", n) != "insert":
        args += ("--build_strategy", "insert")
        say(f"CUT: cli --build_strategy insert (auto picks NN-descent at "
            f"N={n})")
    cuda.reset_launches()
    with cuda.tagged("cli"):
        cli("bruteforce", "--solve_strategy", "bruteforce", *args)
        gt100 = read_ivecs(files / "smoke_groundtruth.ivecs")
        check(gt100.shape == (len(queries), 100),
              f"cli bruteforce: ground truth of shape {gt100.shape}")
        cli("hnsw", "--solve_strategy", "hnsw", *args)
        beside("hnsw", "vanilla", 0.01)
        slim_argv = ("--solve_strategy", "hnsw_slim", *args,
                     "--index_dir", str(tmp / "index"))
        r_built = cli("hnsw_slim build+save", *slim_argv)
        r_loaded = cli("hnsw_slim load", *slim_argv)
        check("build cost" in rows["hnsw_slim build+save"]
              and "load cost" in rows["hnsw_slim load"],
              "cli hnsw_slim: the second run did not load the saved index")
        check(r_loaded == r_built,
              f"cli hnsw_slim: recall {r_built} built, {r_loaded} loaded")
        beside("hnsw_slim load", "slim seed_width=0", 0.02)
        r_tool, _ = quiet(tools.recall_knn, [
            "--base", str(files / "smoke_base.fvecs"),
            "--query", str(files / "smoke_query.fvecs"),
            "--gt", str(files / "smoke_groundtruth.ivecs"),
            "--knn", str(files / "smoke_knn.ivecs"), "--k", "10"])
        check(r_tool == r_loaded, f"tools.recall_knn {r_tool} != the CLI's "
                                  f"recall {r_loaded}")
        # a 100,000-row dataset cut by prep_data, its own ground truth, and
        # the profiled run on it
        part = data / "smoke100k"
        part.mkdir()
        _, _ = quiet(tools.prep_data, [
            "--src", str(files / "smoke_base.fvecs"),
            "--dst", str(part / "smoke100k_base.fvecs"), "--num", "100000"])
        with open(files / "smoke_base.fvecs", "rb") as fh:
            head = fh.read(100000 * (d + 1) * 4)
        check((part / "smoke100k_base.fvecs").read_bytes() == head,
              "tools.prep_data: the slice is not the first 100,000 rows")
        shutil.copy(files / "smoke_query.fvecs",
                    part / "smoke100k_query.fvecs")
        cli("bruteforce 100k", "--solve_strategy", "bruteforce", *CLI_ARGS,
            dataset="smoke100k")
        prof = tmp / "profile"
        cli("hnsw 100k profiled", "--solve_strategy", "hnsw", *CLI_ARGS,
            "--build_strategy", "nnd", "--profile_dir", str(prof),
            dataset="smoke100k")
        cli("hnsw_slimzero", "--solve_strategy", "hnsw_slimzero", *args)
        beside("hnsw_slimzero", "slimzero seeded", 1.0)
        check(rows["hnsw_slimzero"]["recall@10"] > 0.1,
              "cli hnsw_slimzero: recall@10 not above 0.1")
        for ex in ((), ("--use_ex",)):
            label = "hnsw_slimq" + (" use_ex" if ex else "")
            check(cli(label, "--solve_strategy", "hnsw_slimq",
                      "--total_bits", "4", *args, *ex) > 0.1,
                  f"cli {label}: recall@10 not above 0.1")

        # the reference dumps of the in-memory graphs, imported
        t0 = time.perf_counter()
        g, hc = idx.graph, idx._host_chal()
        write_slim_dump(tmp / "g.slimgraph", hc["nbr"], hc["lvl_off"][:g.n],
                        hc["level"][:g.n], entry=int(g.entry),
                        max_level=g.max_level,
                        threshold_level=g.threshold_level, cap=g.cap,
                        cap0=g.cap0)
        nh = h.graph.n
        write_hnsw_dump(tmp / "g.hnsw", [a[:nh] for a in h.host_adj()],
                        h.levels[:nh], entry=int(h.graph.entry),
                        max_level=h.graph.max_level, maxm=h.cfg.maxM,
                        maxm0=h.cfg.maxM0)
        t_dump = time.perf_counter() - t0
        t0 = time.perf_counter()
        rs = import_ref.slim_index_from_ref(str(tmp / "g.slimgraph"), base,
                                            device=dev)
        rs.densify_level0()  # the layouts phase 2 and 3 gave idx
        rs.densify_upper()
        rh = import_ref.hnsw_index_from_ref(
            str(tmp / "g.hnsw"), h.vectors[:nh].cpu().numpy(), M=h.cfg.M,
            ef_construction=h.cfg.ef_construction, device=dev)
        torch.cuda.synchronize()
        t_import = time.perf_counter() - t0
        imports = {}
        for label, mem, ref, scfg in (
                ("slim", idx, rs, SearchConfig(ef=64, pop_width=8,
                                               scan_width=0, seed_width=32)),
                ("vanilla", h, rh, SearchConfig(ef=64, pop_width=4))):
            kept = mem.scfg
            mem.scfg = ref.scfg = scfg
            d_m, i_m = mem.search(queries, k=10)
            d_r, i_r = ref.search(queries, k=10)
            mem.scfg = kept
            same = bool(np.array_equal(i_m, i_r) and np.array_equal(d_m, d_r))
            imports[label] = {"equal": same, "recall@10": recall(i_r, gt)}
            check(same, f"import_ref {label}: the imported graph's ids or "
                        "distances at ef 64 differ from the in-memory index's")
        del rs, rh
    launch_cli = dict(cuda.launches)
    keep_shapes()
    say(f"cli import_ref: dumps written in {t_dump:.2f} s, both imported in "
        f"{t_import:.2f} s, at ef 64 {json.dumps(imports)}")
    trace = prof / "trace.json"
    check(trace.exists(), "cli --profile_dir wrote no trace")
    names = trace.read_text()
    traced = {k_: names.count(k_) for k_ in ("scan_kernel", "beam_kernel",
                                             "greedy_kernel")}
    say(f"cli --profile_dir: {trace.stat().st_size} B of Chrome trace, "
        f"kernel names {json.dumps(traced)} (Kα scan_kernel, Kβ beam_kernel, "
        f"Kε greedy_kernel)")
    check(all(traced.values()), f"the profiled CLI run's trace names no "
                                f"launch of one of Kα, Kβ, Kε: {traced}")
    say(f"cli-path launches: {launch_cli}")
    for name in CLI_PATH:
        check(launch_cli[name] > 0, f"{name} never launched on the CLI path")

    # ---- Kξ and Kα with 128-slot lists against their plain versions -------
    xb = torch.as_tensor(base, device=dev)
    qall = torch.as_tensor(queries, device=dev)
    xn = dist.sq_norms(xb)

    def norm_part(what, x):
        kn, pn = dist.sq_norms(x), dist.sq_norms_plain(x)
        part = dict(
            what=what, shape=list(x.shape), dtype=str(x.dtype),
            max_rel_err=float(((kn - pn).abs() / pn.abs()).max()),
            max_abs_err=float((kn - pn).abs().max()),
            # host-inclusive: 20 eager calls back to back; device-only:
            # the card's work for one call
            ms=cuda_ms(lambda: dist.sq_norms(x), 20),
            device_ms=device_ms(lambda _: dist.sq_norms(x)),
            plain_ms=cuda_ms(lambda: dist.sq_norms_plain(x), 20),
            sum_ms=cuda_ms(lambda: torch.sum(x * x, -1), 20),
            sum_device_ms=device_ms(lambda _: torch.sum(x * x, -1)),
            library_ms=cuda_ms(lambda: torch.linalg.vector_norm(
                x, dim=-1, dtype=torch.float32), 20),
            library_device_ms=device_ms(lambda _: torch.linalg.vector_norm(
                x, dim=-1, dtype=torch.float32)),
            bound=bound(x.numel() * x.element_size() + x.shape[0] * 4,
                        2 * x.numel()))
        say(f"kernel row_norms part: {json.dumps(part)}")
        check(bool(((kn - pn).abs() <= 1e-6 * pn.abs()).all()),
              f"row_norms differs from its plain version by more than 1e-6 "
              f"relative on {what}: {part}")
        return part

    n32 = norm_part(f"the {n} x {d} fp32 store", xb)
    nq = norm_part(f"the {len(queries)} queries", qall)
    n16 = norm_part(f"a bf16 copy of the store", xb.to(torch.bfloat16))
    for name, part in (("row_norms", n32), ("row_norms.bf16", n16)):
        report[name] = dict(
            agree=1.0, max_abs_err=part["max_abs_err"], ms=part["ms"],
            plain_ms=part["plain_ms"], library_ms=part["library_ms"],
            bound=part["bound"], parts=[part] + ([nq] if name == "row_norms"
                                                 else []),
            shapes=f"{part['what']}: max relative error "
                   f"{part['max_rel_err']:.3g}; torch.sum(x * x, -1) "
                   f"{part['sum_ms']:.4f} ms; the library call is "
                   "torch.linalg.vector_norm(x, dim=-1, dtype=float32), "
                   "the root of the same sum" + (
                       f"; the {len(queries)} queries host-inclusive "
                       f"{nq['ms']:.4f} ms (device {nq['device_ms']:.4f}) "
                       f"against torch.sum {nq['sum_ms']:.4f} "
                       f"({nq['sum_device_ms']:.4f}) and vector_norm "
                       f"{nq['library_ms']:.4f} "
                       f"({nq['library_device_ms']:.4f})"
                       if name == "row_norms" else ""))

    kd, ki = bf.topk_dist(qall, xb, xn, 100)
    ki_np = ki.cpu().numpy()
    d_ref = kd[:, :11].cpu().numpy()
    cli_equal = bool(np.array_equal(gt100, ki_np))
    gt_agree = tie_ok(gt100[:, :10], gt, d_ref, 10)
    q64 = qall[:64].contiguous()
    pd_, pi_ = bf.topk_dist_plain(q64, xb, xn, 101)
    agree = tie_ok(ki_np[:64], pi_.cpu().numpy(), pd_.cpu().numpy(), 100)
    err = float((kd[:64] - pd_[:, :100]).abs().max())

    def cdist_topk(k, rows_=131072):
        """torch.cdist + topk over row chunks of the store, with a running
        top-k (the two-call composite of PERF.md, at a size that fits)."""
        best_d = best_i = None
        for s_ in range(0, n, rows_):
            c_d, c_i = torch.cdist(qall, xb[s_:s_ + rows_]).topk(
                k, largest=False)
            c_i = c_i + s_
            if best_d is not None:
                c_d, o_ = torch.cat([best_d, c_d], 1).topk(k, largest=False)
                c_i = torch.gather(torch.cat([best_i, c_i], 1), 1, o_)
            best_d, best_i = c_d, c_i
        return best_d, best_i

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        composite_ms = cuda_ms(lambda: cdist_topk(100), 1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    plan = bf._plan(qall, n, 100)
    report["topk_dist.k128"] = dict(
        agree=agree, max_abs_err=err,
        ms=cuda_ms(lambda: bf.topk_dist(qall, xb, xn, 100)),
        k10_ms=cuda_ms(lambda: bf.topk_dist(qall, xb, xn, 10)),
        plain_ms=cuda_ms(lambda: bf.topk_dist_plain(qall, xb, xn, 100), 1),
        cdist_topk_ms=composite_ms,
        bound=bound(xb.numel() * 4 + n * 4 + qall.numel() * 4
                    + len(queries) * 100 * 8, 2 * len(queries) * n * d),
        shapes=f"the CLI's ground truth {len(queries)}x{n} k=100 (plan "
               f"{plan.tile}, {plan.splits} splits, {plan.smem} B): ids "
               f"equal to the CLI's {cli_equal}, its top 10 against phase "
               f"2's {gt_agree:.6f} near-ties aside; against the plain "
               f"version on 64 queries {agree:.6f}")
    say(f"kernel topk_dist.k128: {json.dumps(report['topk_dist.k128'])}")
    check(cli_equal, "the CLI's 100-NN ground truth differs from Kα k=100")
    check(gt_agree >= 0.999, f"the CLI's top 10 agree with phase 2's ground "
                             f"truth on {gt_agree} of queries")
    check(agree >= 0.99 and err <= 1e-4 * (1 + float(pd_.abs().max())),
          f"topk_dist k=100 disagrees with its plain version: "
          f"{report['topk_dist.k128']}")
    tmp_dir.cleanup()
    summary = {"lines": rows, "import_ref": imports,
               "profile_trace_kernels": traced,
               "phase_s": round(time.perf_counter() - t_phase, 1)}
    say(f"cli phase: {summary['phase_s']} s")
    return summary, launch_cli


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import tempfile
    from pathlib import Path

    from hnsw_slim_tpu_torch.config import (HnswConfig, QuantConfig,
                                            SearchConfig, SlimConfig)
    from hnsw_slim_tpu_torch.graph import build as tb
    from hnsw_slim_tpu_torch.graph import heuristic, nnd, prune, revconn
    from hnsw_slim_tpu_torch.graph import search as gs
    from hnsw_slim_tpu_torch.graph.incremental import IncrementalSlimZero
    from hnsw_slim_tpu_torch.index import bruteforce as bf
    from hnsw_slim_tpu_torch.index import hnsw as hnsw_mod
    from hnsw_slim_tpu_torch.index.hnsw import (HnswIndex,
                                                resolve_build_strategy)
    from hnsw_slim_tpu_torch.index.slim import HnswSlimIndex, autotune_index
    from hnsw_slim_tpu_torch.index import slimq as slimq_mod
    from hnsw_slim_tpu_torch.index.slimq import HnswSlimQIndex
    from hnsw_slim_tpu_torch.index.slimzero import HnswSlimZeroIndex
    from hnsw_slim_tpu_torch.ops import cuda
    from hnsw_slim_tpu_torch.persist.checkpoint import load_slimq, save_slimq
    from hnsw_slim_tpu_torch.persist import patch as patchlib
    from hnsw_slim_tpu_torch.persist.patch import _level_rows
    from hnsw_slim_tpu_torch.quant import estimator as qest
    from hnsw_slim_tpu_torch.quant import kmeans as qkm
    from hnsw_slim_tpu_torch.quant import rotator as qrot
    from hnsw_slim_tpu_torch.serve.server import SlimServer
    from hnsw_slim_tpu_torch.utils.data import clustered, manifold

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = (smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else
            "nvidia-smi: no output")
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    built, usage = cuda.build()
    cuda.lib()
    say(f"kernel build: {built:.1f} s of parallel nvcc + link "
        f"({time.perf_counter() - t0:.1f} s with load)")
    for line in usage.splitlines():
        if line.startswith("Compiling"):
            fn = line.split("'")[1] if "'" in line else line
            kernel = next((k for k in ("topk_scan", "topk_merge",
                                       "strata_sort", "beam_kernel", "prune_kernel",
                                       "shard_merge_kernel",
                                       "merge_kernel", "greedy_kernel",
                                       "append_kernel", "settle_kernel",
                                       "write_kernel",
                                       "fht_kernel", "g_tables_kernel",
                                       "row_deg_kernel", "point_kernel",
                                       "hist_kernel", "pass_kernel",
                                       "scatter_kernel", "dedup_kernel",
                                       "pivot_kernel", "join_kernel",
                                       "window_kernel", "row_norms_kernel")
                           if k in fn), "?")
            if kernel in ("hist_kernel", "pass_kernel") and "_kernelI" in fn:
                # Kκ's instantiations: <digit map, payload>
                kernel += "<" + fn.split("_kernelI", 1)[1].split("EEv")[0] + ">"
            elif "ILb1E" in fn:  # the quantized / estimate instantiation
                kernel += "<quant>"
            if "nv_bfloat16" in fn:  # the bfloat16-row instantiation
                kernel += "<bf16>"
        elif line.startswith("Used"):
            say(f"  ptxas {kernel}: {line}")

    n = args.n
    base, queries = clustered(n, 128, n_queries=NQ,
                              n_clusters=max(64, n // 1000), seed=7,
                              scale=0.3)
    if n != 1_000_000:
        say(f"CUT: N={n} (the slice's size is 1,000,000)")
    hcfg = HnswConfig(M=30, ef_construction=128)
    def scfg_slim(ef):
        return SearchConfig(ef=ef, pop_width=8, scan_width=0, seed_width=32)
    t0 = time.perf_counter()
    gt_d, gt = bf.BruteForceIndex(base, device=dev).search(queries, k=10)
    say(f"ground truth: {time.perf_counter() - t0:.3f} s for {NQ} x {n}")
    check(np.all(np.diff(gt_d, axis=1) >= 0), "ground truth not sorted")

    # ---- 2. the insertion path -------------------------------------------
    strategy = "auto" if resolve_build_strategy("auto", n) == "insert" \
        else "insert"
    if strategy != "auto":
        say(f"CUT: strategy='insert' forced (auto picks NN-descent at N={n})")
    recorder = BatchRecorder(max(1, full_batches(n) // 2), hcfg.maxM0)
    cuda.reset_launches()
    with recorder.installed(), cuda.tagged("build"):
        t0 = time.perf_counter()
        h = HnswIndex(hcfg, device=dev, strategy=strategy)
        h.build(base)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
    ph, ov = h.build_stats["phase_s"], h.build_stats["overflow"]
    say(f"insert build: {t_build:.2f} s, max_level {h.graph.max_level}, "
        f"split (s) {json.dumps({k: round(v, 3) for k, v in ph.items()})}, "
        f"overflow {json.dumps(ov)}")
    check(ov["truncated_applies"] == 0, f"reverse-connect truncated: {ov}")
    t0 = time.perf_counter()
    integ_h = h.check_integrity()
    say(f"insert graph integrity: {integ_h} ({time.perf_counter() - t0:.2f} "
        "s, the host mirror's pull included)")
    vanilla = serve_sweep(h, queries, gt, base,
                          lambda ef: SearchConfig(ef=ef, pop_width=4),
                          "vanilla")
    t0 = time.perf_counter()
    with cuda.tagged("convert"):
        idx = HnswSlimIndex.from_hnsw(h, SlimConfig.from_ratios())
    dense_bytes = idx.densify_level0()
    torch.cuda.synchronize()
    t_conv = time.perf_counter() - t0
    integ_s = idx.check_integrity()
    say(f"insert slim: conversion+densify {t_conv:.2f} s, index_size "
        f"{idx.index_size()} B, dense0 {dense_bytes} B, integrity {integ_s}")
    slim_ins = serve_sweep(idx, queries, gt, base, scfg_slim, "slim(insert)")
    launch_ins = dict(cuda.launches)
    keep_shapes()
    say(f"insertion-path launches: {launch_ins}")
    for name in INSERT_PATH:
        check(launch_ins[name] > 0, f"{name} never launched on the "
                                    "insertion path")
    check(bool(recorder.rec.get("adj0") is not None
               and recorder.rec.get("q") is not None),
          "no 4096-insert batch was recorded")

    # ---- 3. the query surface on the insertion graph ----------------------
    cuda.reset_launches()
    qs_rows = {}

    def view(src, layout, scfg):
        """A second index object over src's graph and vectors in serving
        layout "chal" (flat CHAL arrays only), "dense0" or "dense" (dense
        level 0 + dense upper rows)."""
        v = HnswSlimIndex(metric=src.metric, search_cfg=scfg, device=dev)
        v.graph, v.vectors, v.vn = src.graph, src.vectors, src.vn
        if layout != "chal":
            v.dense0 = src.dense0
        if layout == "dense":
            v.dense_up, v.rank_up = src.dense_up, src.rank_up
        return v

    def layouts(src, scfg, label):
        """One configuration served over the three layouts; checks that ids,
        hops and dcomp are identical. Returns the dense-level-0 row."""
        rows = [serve_line(view(src, lay, scfg), queries, gt,
                           f"{label} [{lay}]")
                for lay in ("chal", "dense0", "dense")]
        for r in rows[1:]:
            check((r["ids"] == rows[0]["ids"]).all()
                  and r["hops"] == rows[0]["hops"]
                  and r["dcomp"] == rows[0]["dcomp"],
                  f"{label}: the serving layouts disagree")
        return rows[1]

    up_bytes = idx.densify_upper()
    say(f"dense upper layout: {up_bytes} B")
    for ef in (64, 128):
        qs_rows[f"seeded ef={ef}"] = layouts(idx, scfg_slim(ef),
                                             f"slim seeded ef={ef}")
    for ef in (32, 64, 128):
        qs_rows[f"greedy ef={ef}"] = layouts(
            idx, SearchConfig(ef=ef, pop_width=8, seed_width=0),
            f"slim seed_width=0 ef={ef}")
    t0 = time.perf_counter()
    idx_t1 = HnswSlimIndex.from_hnsw(
        h, SlimConfig.from_ratios(threshold_level=1))
    idx_t1.densify_level0()
    idx_t1.densify_upper()
    torch.cuda.synchronize()
    say(f"threshold_level=1 conversion+densify: "
        f"{time.perf_counter() - t0:.2f} s, index_size "
        f"{idx_t1.index_size()} B, integrity {idx_t1.check_integrity()}")
    for ef in (64, 128):
        qs_rows[f"threshold1 ef={ef}"] = layouts(
            idx_t1, SearchConfig(ef=ef, pop_width=8, seed_width=0),
            f"slim threshold_level=1 seed_width=0 ef={ef}")
    idx.scfg = SearchConfig(ef=64, pop_width=8, seed_width=32, seed_strata=4)
    qs_rows["strata4 ef=64"] = serve_line(idx, queries, gt,
                                          "slim seed_strata=4 ef=64")
    masks = {}
    for share in (0.5, 0.1):
        allowed = np.random.default_rng(17).random(n) < share
        sub = np.nonzero(allowed)[0]
        t0 = time.perf_counter()
        _, sub_gt = bf.BruteForceIndex(base[allowed], device=dev).search(
            queries, k=10)
        masks[share] = (allowed, sub[sub_gt])
        say(f"filter {share}: {len(sub)} allowed, ground truth over them "
            f"{time.perf_counter() - t0:.3f} s")
        for ef in (64, 128):
            idx.scfg = scfg_slim(ef)
            qs_rows[f"slim allowed={share} ef={ef}"] = serve_line(
                idx, queries, masks[share][1],
                f"slim filtered allowed={share} ef={ef}", allowed=allowed,
                need_full=n == 1_000_000)
            h.scfg = SearchConfig(ef=ef, pop_width=4)
            qs_rows[f"vanilla allowed={share} ef={ef}"] = serve_line(
                h, queries, masks[share][1],
                f"vanilla filtered allowed={share} ef={ef}", allowed=allowed,
                need_full=n == 1_000_000)
    # one label predicate a query, as the label cell sends them: a uniform
    # label of 12 a base row and a query, one-hot words; the ground truth
    # of a label's queries over that label's rows
    rng_l = np.random.default_rng(19)
    one = np.uint32(1)
    tags = one << rng_l.integers(0, 12, n).astype(np.uint32)
    need = one << rng_l.integers(0, 12, NQ).astype(np.uint32)
    t0 = time.perf_counter()
    idx.set_tags(tags)
    say(f"set_tags: {time.perf_counter() - t0:.3f} s for {n} tag words")
    tag_gt = np.full((NQ, 10), -1, np.int64)
    for w in np.unique(need):
        sub, rows_ = np.nonzero(tags == w)[0], np.nonzero(need == w)[0]
        _, g_ = bf.BruteForceIndex(base[sub], device=dev).search(
            queries[rows_], k=10)
        tag_gt[rows_] = sub[g_]
    idx.scfg = scfg_slim(128)
    row = serve_line(idx, queries, tag_gt, "slim labels=12 ef=128",
                     need=need)
    qs_rows["slim labels=12 ef=128"] = row
    t_ids = row["ids"]
    t_ok = t_ids >= 0
    check(bool(((tags[t_ids[t_ok]] & need[np.nonzero(t_ok)[0]])
                == need[np.nonzero(t_ok)[0]]).all()),
          "slim labels=12: a returned id fails its query's predicate")
    check(t_ok.all() or n != 1_000_000,
          "slim labels=12: a filtered row is not full")
    r_d, r_i = idx.search(queries, k=10, need=need)
    a_d, a_i, a_h, a_c = idx.search_async(queries, 10, need=need)
    check(idx._replay._graphs and (a_i.cpu().numpy() == r_i).all()
          and (a_d.cpu().numpy() == r_d).all()
          and int(a_h.sum()) == idx.last_stats["hops"]
          and int(a_c.sum()) == idx.last_stats["distance_computations"],
          "slim labels=12: the replayed search differs from the eager one")
    say("slim labels=12: replayed search equal to the eager one (ids, "
        "distances, hops, dcomp); every id passes its predicate")
    idx.scfg = scfg_slim(64)
    s_d, s_i = idx.search(queries, k=10)
    a_d, a_i, a_h, a_c = idx.search_async(queries, 10)
    torch.cuda.synchronize()
    check((a_i.cpu().numpy() == s_i).all()
          and (a_d.cpu().numpy() == s_d).all()
          and int(a_h.sum()) == idx.last_stats["hops"]
          and int(a_c.sum()) == idx.last_stats["distance_computations"],
          "search_async differs from search")
    say("search_async: equal to search (ids, distances, hops, dcomp)")
    t0 = time.perf_counter()
    tune = autotune_index(idx, 128)
    say(f"autotune_index(ef=128): {json.dumps(tune)} "
        f"({time.perf_counter() - t0:.2f} s)")
    grid = {(g_["pop_width"], g_["scan_width"]): g_["recall"]
            for g_ in tune["grid"]}
    check((8, 0) in grid and grid[(tune["knobs"]["pop_width"],
                                   tune["knobs"]["scan_width"])]
          >= grid[(8, 0)] - 0.002 - 1e-4,
          f"autotune landed below the lossless configuration: {tune}")
    launch_qs = dict(cuda.launches)
    keep_shapes()
    say(f"query-surface launches: {launch_qs}")
    for name in QUERY_PATH:
        check(launch_qs[name] > 0, f"{name} never launched on the query "
                                   "surface")
    for key, row in qs_rows.items():
        check(row["recall@10"] >= 0.5, f"{key}: recall implausible: "
                                       f"{row['recall@10']}")

    # ---- 4. SlimZero -------------------------------------------------------
    class GuardRecorder:
        """Clones the inputs of one guarded prune call of the conversion
        (the `which`-th 8192-row chunk); the call runs unchanged."""

        def __init__(self, which):
            self.which, self.calls, self.rec = which, 0, None

        def __call__(self, vectors, vn, base_ids, cand, valid, guard, **kw):
            self.calls += 1
            if self.calls == self.which and len(base_ids) == \
                    prune.GUARD_CHUNK:
                self.rec = (base_ids.clone(), cand.clone(), guard.clone(),
                            kw["m_per_row"].clone(), kw["out_width"])
            return guarded(vectors, vn, base_ids, cand, valid, guard, **kw)

    cuda.reset_launches()
    zcfg = SlimConfig.from_ratios()
    guarded = prune.prune_batch_guarded
    g_rec = GuardRecorder(max(1, n // prune.GUARD_CHUNK // 2))
    prune.prune_batch_guarded = g_rec
    try:
        t0 = time.perf_counter()
        with cuda.tagged("convert"):
            z = HnswSlimZeroIndex.from_hnsw(h, zcfg)
        torch.cuda.synchronize()
        t_zconv = time.perf_counter() - t0
    finally:
        prune.prune_batch_guarded = guarded
    z_dense = z.densify_level0()
    integ_z = z.check_integrity()
    zc = z._host_chal()
    z_rows0 = _level_rows(zc, 0, n, z.graph.cap0)
    z_indeg = np.bincount(z_rows0[z_rows0 >= 0], minlength=n)
    donor = prune.level_indegrees(h.host_adj(), h.levels)[0]
    floor = np.minimum(donor, zcfg.min_indegree0)
    floor_share = float((z_indeg >= floor).mean())
    say(f"slimzero: conversion {t_zconv:.2f} s ({g_rec.calls} guarded prune "
        f"calls), index_size {z.index_size()} B (size_estimate "
        f"{HnswSlimZeroIndex.size_estimate(n, hcfg.branching_factor, zcfg):.0f}"
        f" B), dense0 {z_dense} B, integrity {integ_z}, level-0 in-degree "
        f"min {int(z_indeg.min())} mean {z_indeg.mean():.2f} against "
        f"min_indegree0 {zcfg.min_indegree0}: {floor_share:.6f} of nodes at "
        f"or above min(floor, donor in-degree); donor in-degree min "
        f"{int(donor.min())}")
    check(floor_share >= 0.999, "SlimZero's in-degree floor is broken: "
                                f"{floor_share}")
    slim_zero = serve_sweep(z, queries, gt, base, scfg_slim, "slimzero")
    launch_sz = dict(cuda.launches)
    keep_shapes()
    say(f"slimzero-path launches: {launch_sz}")
    for name in SLIMZERO_PATH:
        check(launch_sz[name] > 0, f"{name} never launched on the SlimZero "
                                   "path")
    check(g_rec.rec is not None, "no guarded prune chunk was recorded")
    check(slim_zero[-1]["recall@10"] >= slim_ins[-1]["recall@10"] - 0.02,
          f"SlimZero recall@10 at ef={EFS[-1]} more than 0.02 under the "
          f"Slim index's: {slim_zero[-1]['recall@10']} vs "
          f"{slim_ins[-1]['recall@10']}")


    # ---- 5. SlimQ ----------------------------------------------------------
    cuda.reset_launches()
    mbase, mq = manifold(n, 128, latent_dim=24, n_queries=NQ, n_clusters=250,
                         seed=5)
    km_launches = []  # Kα launches of the build's KMeans step (K18)

    def kmeans_counted(*a, **kw):
        before = cuda.launches["topk_dist"]
        out = qkm.kmeans(*a, **kw)
        km_launches.append(cuda.launches["topk_dist"] - before)
        return out

    slimq_mod.kmeans = kmeans_counted
    try:
        t0 = time.perf_counter()
        with cuda.tagged("slimq build"):
            sq = HnswSlimQIndex.build(
                mbase, hnsw_cfg=HnswConfig(M=32, ef_construction=128),
                slim_cfg=SlimConfig(top_M0=32, low_m0=8, top_M=16, low_m=4),
                quant_cfg=QuantConfig(total_bits=4), strategy=strategy,
                device=dev)
        torch.cuda.synchronize()
        t_qbuild = time.perf_counter() - t0
    finally:
        slimq_mod.kmeans = qkm.kmeans
    q_dense = sq.densify_level0() + sq.densify_upper()
    fp32_slim = sq.graph.chal_bytes() + mbase.nbytes
    sq_size = {"index_size": sq.index_size(),
               "runtime_memory": sq.runtime_memory(),
               "raw_vectors": int(mbase.nbytes),
               "fp32_slim_serving_set": int(fp32_slim),
               "of_raw": round(sq.index_size() / mbase.nbytes, 4),
               "of_fp32_slim": round(sq.index_size() / fp32_slim, 4),
               "dense_layouts": q_dense}
    say(f"slimq build: {t_qbuild:.2f} s, split (s) "
        f"{json.dumps({k: round(v, 3) for k, v in sq.build_stats.items()})}, "
        f"max_level {sq.graph.max_level}, sizes (B) {json.dumps(sq_size)}, "
        f"topk_dist launches of the KMeans step (k=1, 16 centroids): "
        f"{sum(km_launches)}")
    check(sum(km_launches) > 0, "the SlimQ build's KMeans step never "
                                "launched topk_dist")
    check(sq.index_size() < 0.35 * mbase.nbytes,
          f"SlimQ index_size {sq.index_size()} is not under 0.35 of the raw "
          f"vectors' {mbase.nbytes} B")
    t0 = time.perf_counter()
    _, mgt = bf.BruteForceIndex(mbase, device=dev).search(mq, k=10)
    say(f"slimq ground truth (manifold data): {time.perf_counter() - t0:.3f} "
        f"s for {NQ} x {n}")

    def slimq_line(label, scfg, rerank=True):
        """serve_line plus the SlimQ checks: ids in range and, with the
        rerank, returned distances the true ones."""
        sq.scfg = scfg
        row = serve_line(sq, mq, mgt, label, rerank=rerank)
        d_, ids_ = row.pop("d"), row.pop("ids")
        check(((ids_ >= 0) & (ids_ < n)).all(), f"{label}: id range")
        if rerank:
            true_d = ((mq[:, None, :] - mbase[ids_]) ** 2).sum(-1)
            check(np.allclose(d_, true_d, rtol=1e-3, atol=1e-3),
                  f"{label}: returned distances are not the true ones")
        row["ids"] = ids_
        return row

    def sq_cfg(ef, **kw):
        return SearchConfig(**{**dict(ef=ef, pop_width=8, seed_width=32),
                               **kw})

    sq_rows = {}
    for ef in SLIMQ_EFS:
        sq_rows[f"rerank ef={ef}"] = slimq_line(f"slimq ef={ef}", sq_cfg(ef))
    rec_q = [sq_rows[f"rerank ef={ef}"]["recall@10"] for ef in SLIMQ_EFS]
    check(all(b_ >= a_ for a_, b_ in zip(rec_q, rec_q[1:])) and
          rec_q[-1] >= 0.5, f"SlimQ recall falls with ef: {rec_q}")
    for ef in (64, 128):
        sq_rows[f"use_ex ef={ef}"] = slimq_line(
            f"slimq use_ex ef={ef}", sq_cfg(ef, use_ex=True))
        sq_rows[f"estimate-only ef={ef}"] = slimq_line(
            f"slimq rerank=False ef={ef}", sq_cfg(ef), rerank=False)
        sq_rows[f"estimate-only use_ex ef={ef}"] = slimq_line(
            f"slimq rerank=False use_ex ef={ef}", sq_cfg(ef, use_ex=True),
            rerank=False)
        sq_rows[f"seed_width=0 ef={ef}"] = slimq_line(
            f"slimq seed_width=0 ef={ef}", sq_cfg(ef, seed_width=0))
        for ex in ("", "use_ex "):
            a_ = sq_rows[f"{ex or 'rerank '}ef={ef}"]["recall@10"]
            b_ = sq_rows[f"estimate-only {ex}ef={ef}"]["recall@10"]
            check(a_ >= b_, f"SlimQ ef={ef} {ex}: reranked recall {a_} under "
                            f"the estimate-only recall {b_}")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        save_slimq(Path(tmp) / "slimq.npz", sq)
        t_save = time.perf_counter() - t0
        file_b = (Path(tmp) / "slimq.npz").stat().st_size
        t0 = time.perf_counter()
        sq2 = load_slimq(Path(tmp) / "slimq.npz", search_cfg=sq_cfg(64),
                         device=dev)
        t_load = time.perf_counter() - t0
    sq2.set_dataset(mbase)
    sq2.densify_level0()
    sq2.densify_upper()
    _, ids2 = sq2.search(mq, k=10)
    check((ids2 == sq_rows["rerank ef=64"]["ids"]).all(),
          "the save_slimq -> load_slimq round trip changed the search's ids")
    say(f"slimq save_slimq {t_save:.2f} s ({file_b} B) -> load_slimq "
        f"{t_load:.2f} s: identical ids at ef=64")
    del sq2
    launch_sq = dict(cuda.launches)
    keep_shapes()
    say(f"slimq-path launches: {launch_sq}")
    for name in SLIMQ_PATH:
        check(launch_sq[name] > 0, f"{name} never launched on the SlimQ path")
    for row in sq_rows.values():
        row.pop("ids")

    # ---- 6. the HTTP server on an NN-descent-built index ------------------
    report = {}
    srv_summary, launch_nnd, slim_nnd, h2 = server_phase(
        base, queries, gt, hcfg, scfg_slim, report, dev)
    say(f"recall@10 at ef={EFS[-1]}: insertion-built Slim "
        f"{slim_ins[-1]['recall@10']}, NND-built Slim "
        f"{slim_nnd[-1]['recall@10']}")
    if n == 1_000_000:  # smaller sets saturate both near 1.0
        check(slim_ins[-1]["recall@10"] > slim_nnd[-1]["recall@10"],
              "the insertion-built Slim index does not beat the NND-built "
              f"one at ef={EFS[-1]}")

    # ---- 7. each kernel against its plain version -------------------------
    x, xn = h.vectors, h.vn
    d = x.shape[1]
    r = recorder.rec
    q4, adjs, entry = r["q"], r["adjs"], r["entry"]
    qn4 = (q4 * q4).sum(1)
    act = r["active"]
    efc = hcfg.ef_construction

    # Kε: the recorded batch's descent, levels max_level..1, its own active
    # rows (the level-0-only inserts), each level from the plain state
    top = len(adjs) - 1
    pc, pd = gs.entry_dist(x, xn, q4, qn4, entry)
    # its bound: the distinct rows fetched at each level and vectors scored
    # over all levels (the plain walk's ids; the top levels' few nodes are
    # read again and again), the queries once for the one launch
    eq, tot, err, k_ms, p_ms, e_bytes, e_flops = 0, 0, 0.0, 0.0, 0.0, 0, 0
    vecs = []
    for l in range(top, 0, -1):
        st = (x, q4, qn4, adjs[l], pc, pd, act)
        kc, kd, kh, kdc = gs.greedy_descent(*st)
        k_ms += cuda_ms(lambda: gs.greedy_descent(*st))
        p_ms += cuda_ms(lambda: gs.greedy_descent_plain(*st), 1)
        npc, npd, _, _ = gs.greedy_descent_plain(*st, seen=(sn := []))
        same = kc == npc
        eq, tot = eq + int(same.sum()), tot + len(same)
        if same.any():
            err = max(err, float((kd - npd)[same].abs().max()))
        e_bytes += distinct([a for a, _ in sn]) * adjs[l].shape[1] * 4
        vecs += [v for _, v in sn]
        e_flops += int(kdc.sum()) * 4 * d
        pc, pd = npc, npd
    e_bytes += distinct(vecs) * d * 4 + q4.numel() * 4 + len(q4) * 16
    # the one launch _build_search0 makes: levels top..1, the inactive rows
    # stopping at the top
    c0, d0 = gs.entry_dist(x, xn, q4, qn4, entry)
    fused = descent_pair((x, q4, qn4, adjs[top:0:-1], top, c0, d0),
                         dict(stop=torch.where(act, 0, top).to(torch.int32)))
    report["greedy_descent"] = dict(
        agree=min(eq / max(1, tot), fused["agree"]),
        max_abs_err=max(err, fused["max_abs_err"]), ms=fused["ms"],
        plain_ms=fused["plain_ms"], per_level_ms=k_ms,
        per_level_plain_ms=p_ms, fused=fused, bound=bound(e_bytes, e_flops),
        shapes=f"{len(q4)} queries of one insert batch, levels {top}..1, "
               f"{int(act.sum())} active: one launch {fused['ms']:.4f} ms "
               f"(the main path's), {top} per-level launches "
               f"{k_ms:.4f} ms")
    check(eq / max(1, tot) >= 0.99 and fused["agree"] >= 0.99
          and fused["path_agree"] >= 0.99,
          f"greedy_descent disagrees: {report['greedy_descent']}")

    # Kβ in build mode: _build_search0's level-0 beam from the greedy seeds
    # (S=1, P=efc, E=8), on the recorded pre-batch graph
    pop = tb.INSERT_POP_WIDTH
    kw0 = dict(P=efc, ef_eff=efc, pop_width=pop,
               cw=gs.cand_width(efc, pop, adjs[0].shape[1], 0),
               max_iters=2 * efc + 64, k=efc)
    b_args = (x, q4, qn4, adjs[0],
              torch.where(act, pd, float("inf"))[:, None].contiguous(),
              torch.where(act, pc, -1)[:, None].contiguous())
    bd, bi, bh, bc = gs.beam_search(*b_args, **kw0)
    pbd, pbi, _, pbc = gs.beam_search_plain(*b_args, **kw0, seen=(sn := []))
    same = bi == pbi
    slots = float(same[act].float().mean())
    # its bound: the distinct rows fetched and vectors scored (the plain
    # run's ids), the queries, the seeds and the results
    b_bytes = (distinct([a for a, _ in sn]) * adjs[0].shape[1] * 4
               + distinct([v for _, v in sn]) * d * 4
               + q4.numel() * 4 + len(q4) * (8 + efc * 8))
    report["beam_search"] = dict(
        agree=slots, max_abs_err=float(
            (bd - pbd)[same & act[:, None] & torch.isfinite(pbd)].abs().max()),
        ms=cuda_ms(lambda: gs.beam_search(*b_args, **kw0)),
        plain_ms=cuda_ms(lambda: gs.beam_search_plain(*b_args, **kw0), 1),
        bound=bound(b_bytes, int(bc.sum()) * 4 * d),
        shapes=f"build mode: {int(act.sum())} of {len(q4)} queries, efc "
               f"{efc}, E=8, cw {kw0['cw']}; dcomp {int(bc.sum())} vs "
               f"{int(pbc.sum())}")
    check(slots >= 0.99, f"beam_search (build) disagrees: "
                         f"{report['beam_search']}")
    # Kβ from a carried buffer, E=1, one level up: the level-2 beam's buffer
    # (or a fresh seed when the graph has one upper level) seeds level 1
    lv = min(2, top)
    cc, cd = gs.entry_dist(x, xn, q4, qn4, entry)
    for l in range(top, lv, -1):
        cc, cd, _, _ = gs.greedy_descent(x, q4, qn4, adjs[l], cc, cd)
    buf_d, buf_id = gs.beam_init(cc, cd, efc)
    if lv == 2:
        buf_d, buf_id, _, _ = gs.beam_level(
            x, q4, qn4, adjs[2], buf_d, buf_id,
            torch.ones(len(q4), dtype=torch.bool, device=dev),
            max_iters=2 * efc + 64)
    kw1 = dict(P=efc, ef_eff=efc, pop_width=1, cw=adjs[1].shape[1],
               max_iters=2 * efc + 64, k=efc)
    c_args = (x, q4, qn4, adjs[1], buf_d.contiguous(), buf_id.contiguous())
    cdk, cik, chk, cdc = gs.beam_search(*c_args, **kw1)
    cdp, cip, _, _ = gs.beam_search_plain(*c_args, **kw1, seen=(sn := []))
    c_slots = float((cik == cip).float().mean())
    c_ms = cuda_ms(lambda: gs.beam_search(*c_args, **kw1))
    c_pms = cuda_ms(lambda: gs.beam_search_plain(*c_args, **kw1), 1)
    # its bound: the distinct rows fetched and vectors scored (level 1 holds
    # few nodes, each scored for many queries), the queries, and the
    # carried buffer read and written whole
    c_bound = bound(distinct([a for a, _ in sn]) * adjs[1].shape[1] * 4
                    + distinct([v for _, v in sn]) * d * 4 + q4.numel() * 4
                    + len(q4) * (8 + 2 * efc * 8), int(cdc.sum()) * 4 * d)
    report["beam_search"]["carried"] = dict(
        ms=c_ms, plain_ms=c_pms, bound=c_bound, hops=int(chk.sum()),
        dcomp=int(cdc.sum()), slots=c_slots)
    report["beam_search"]["shapes"] += (
        f"; carried buffer at level 1 (E=1, S=P={efc}, {len(q4)} queries): "
        f"slots {c_slots:.5f}, {c_ms:.3f} ms vs plain {c_pms:.3f} ms, bound "
        f"{c_bound[0]:.4f} ms ({c_bound[1]}; hops {int(chk.sum())}, dcomp "
        f"{int(cdc.sum())})")
    check(c_slots >= 0.99, f"beam_search (carried buffer) disagrees: "
                           f"{c_slots}")

    # Kγ and Kζ: the recorded batch's level-0 apply, on copies of its
    # pre-apply adjacency and degrees
    kw = r["ap_kw"]
    a_ids, cand, adj0, deg0 = r["a_ids"], r["cand"], r["adj0"], r["deg0"]
    cap0, M = adj0.shape[1], kw["M"]
    b4 = len(a_ids)
    m_fwd = torch.full((b4,), M, dtype=torch.int32, device=dev)
    fwd = dict(keep_all_under_m=True, keep_pruned=False, out_width=M)
    kg_parts = []

    def kg_part(what, x, xn, b_ids, cnd, m_row, kw_g):
        """Kγ and its plain version on one prune call's real rows: report
        and check agreement and times; returns the kernel's (sel, cnt)."""
        ks, kc = heuristic.rng_prune(x, xn, b_ids, cnd, m_row, **kw_g)
        ps_, pc_ = heuristic.rng_prune_plain(x, xn, b_ids, cnd, m_row, **kw_g)
        valid = int((cnd >= 0).sum())
        part = dict(
            what=what, rows=len(b_ids), C=cnd.shape[1],
            rows_agree=float((ks == ps_).all(dim=1).float().mean()),
            counts_agree=float((kc == pc_).float().mean()),
            max_abs_err=float((kc - pc_).abs().max()),
            ms=cuda_ms(lambda: heuristic.rng_prune(x, xn, b_ids, cnd, m_row,
                                                   **kw_g)),
            plain_ms=cuda_ms(lambda: heuristic.rng_prune_plain(
                x, xn, b_ids, cnd, m_row, **kw_g), 1),
            bound=bound(cnd.numel() * 4 + valid * (d + 1) * 4
                        + len(b_ids) * (d + 2 + kw_g["out_width"]) * 4,
                        valid * 2 * d), **kw_g)
        kg_parts.append(part)
        say(f"kernel rng_prune part: {json.dumps(part)}")
        if len(b_ids) >= 1000:
            check(part["rows_agree"] >= 0.99 and part["counts_agree"] >= 0.99,
                  f"rng_prune disagrees with its plain version: {part}")
        return ks, kc

    sel, cnt = kg_part("insert forward prune, m=M", x, xn, a_ids, cand,
                       m_fwd, fwd)

    def forward(adj, deg):
        adj[a_ids.long()] = torch.nn.functional.pad(sel, (0, cap0 - M),
                                                    value=-1)
        deg[a_ids.long()] = cnt

    n_rows = adj0.shape[0]  # the ids map's node bound, as apply_insert
    us, ps = revconn.reverse_edges(a_ids, sel, n_rows)
    pre_a, pre_d = adj0.clone(), deg0.clone()
    forward(pre_a, pre_d)
    of_t, new_w = kw["of_t"], kw["new_w"]
    ak, dk = pre_a.clone(), pre_d.clone()
    pa, pdg = pre_a.clone(), pre_d.clone()
    zk = revconn.append_overflow(ak, dk, us, ps, of_t, new_w)
    zp = revconn.append_overflow_plain(pa, pdg, us, ps, of_t, new_w)
    # ut, base, candidate rows, both counters; then adj and deg
    z_eq = [bool(torch.equal(a_, b_)) for a_, b_ in zip(zk, zp)]
    z_eq += [bool(torch.equal(ak, pa)), bool(torch.equal(dk, pdg))]
    ut, bk, ck, of_e, of_tc = zk
    n_t = int(of_tc)
    m_of = torch.full((len(ut),), cap0, dtype=torch.int32, device=dev)
    ofw = dict(keep_all_under_m=False, keep_pruned=False, out_width=cap0)
    osel, ocnt = kg_part(f"insert overflow re-prune ({n_t} targets of "
                         f"{len(ut)} rows), m=cap", x, xn, bk, ck, m_of, ofw)
    revconn.write_rows(ak, dk, ut, osel, ocnt)
    revconn.write_rows_plain(pa, pdg, ut, osel, ocnt)
    z_eq += [bool(torch.equal(ak, pa)), bool(torch.equal(dk, pdg))]
    fa, fd = adj0.clone(), deg0.clone()
    before = {k_: cuda.launches[k_] for k_ in ("rev_connect", "radix_sort.ids")}
    revconn.apply_insert(fa, fd, x, xn, a_ids, cand, **kw)
    per_apply = {k_: cuda.launches[k_] - v_ for k_, v_ in before.items()}
    z_eq += [bool(torch.equal(fa, ak)), bool(torch.equal(fd, dk))]

    def pre():
        return pre_a.clone(), pre_d.clone()

    def zeta_calls(kernel: bool):
        """Kζ's calls of the apply, on a state from ``pre``: append +
        settle (one call, two launches), then the write-back of the
        re-pruned rows."""
        app = revconn.append_overflow if kernel else \
            revconn.append_overflow_plain
        wr = revconn.write_rows if kernel else revconn.write_rows_plain

        def call(st):
            a, g = st
            tt = app(a, g, us, ps, of_t, new_w)[0]
            wr(a, g, tt, osel, ocnt)
        return call

    def zeta_ms(kernel: bool, reps: int = 5) -> float:
        """Kζ's calls on fresh copies of the post-forward state: CUDA
        events around the calls alone, the host's enqueue included."""
        call, tot_ms = zeta_calls(kernel), 0.0
        for rep in range(reps + 1):
            st = pre()
            evs = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            evs[0].record()
            call(st)
            evs[1].record()
            torch.cuda.synchronize()
            if rep:  # the first pass warms up
                tot_ms += evs[0].elapsed_time(evs[1])
        return tot_ms / reps

    def apply_host_ms(reps: int = 10) -> float:
        """The whole level-0 apply, ``reps`` calls back to back on fresh
        copies of the recorded state (CUDA events around the run)."""
        sts = [(adj0.clone(), deg0.clone()) for _ in range(reps)]
        torch.cuda.synchronize()
        evs = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        evs[0].record()
        for a, g in sts:
            revconn.apply_insert(a, g, x, xn, a_ids, cand, **kw)
        evs[1].record()
        evs[1].synchronize()
        return evs[0].elapsed_time(evs[1]) / reps

    # the least bytes Kζ's function moves, each once: per edge us and ps
    # read; per target run deg read and written; per appended edge one adj
    # word; per valid overflow target (padding rows need no memory) its
    # row and the new edges it takes read, its id, base id and candidate
    # row written, the pruned row and count read, and its row and degree
    # written
    e = len(us)
    valid_e = us < 2**30
    appended = int(valid_e.sum()) - int(of_e)
    runs = int(torch.unique(us[valid_e]).numel())
    valid_t = min(n_t, len(ut))
    taken = int((ck[:valid_t, cap0:] >= 0).sum())
    z_bytes = (e * 8 + runs * 8 + appended * 4
               + valid_t * (cap0 * 4 + 8 + (cap0 + new_w) * 4)
               + taken * 4 + valid_t * (cap0 * 8 + 8))
    report["rev_connect"] = dict(
        agree=float(all(z_eq)), max_abs_err=0.0 if all(z_eq) else 1.0,
        ms=zeta_ms(True), plain_ms=zeta_ms(False),
        device_ms=device_ms(zeta_calls(True), prep=pre),
        plain_device_ms=device_ms(zeta_calls(False), 5, prep=pre),
        apply_ms=apply_host_ms(),
        apply_device_ms=device_ms(
            lambda st: revconn.apply_insert(*st, x, xn, a_ids, cand, **kw),
            prep=lambda: (adj0.clone(), deg0.clone())),
        per_apply=per_apply, bound=bound(z_bytes, 0),
        shapes=f"one level-0 apply of {b4} inserts: {e} reverse edges, "
               f"{appended} appended, {int(of_e)} overflowing into {n_t} "
               f"targets; Kζ's two calls (append + settle, write-back), "
               f"{per_apply['rev_connect']} rev_connect calls and "
               f"{per_apply['radix_sort.ids']} radix_sort.ids sort per "
               f"apply; equal {z_eq}")
    say(f"kernel rev_connect: level-0 apply {json.dumps(report['rev_connect'])}")
    check(all(z_eq), f"rev_connect differs from its plain version: {z_eq}")
    check(per_apply == {"rev_connect": 2, "radix_sort.ids": 1},
          f"a level-0 apply made {per_apply} rev_connect calls and Kι sorts "
          "(want 2 and 1)")
    # a seeded Slim search takes its queries' norms from Kξ once: the seed
    # scan reuses them
    scfg_was, idx.scfg = idx.scfg, scfg_slim(64)
    idx.search_async(queries[:512], 10)
    kxi_0 = cuda.launches["row_norms"]
    idx.search_async(queries[:512], 10)
    kxi_per_search = cuda.launches["row_norms"] - kxi_0
    idx.scfg = scfg_was
    say(f"row_norms launches in one seeded Slim search: {kxi_per_search}")
    check(kxi_per_search == 1, f"a seeded Slim search launched Kξ "
                               f"{kxi_per_search} times (want 1)")

    # Kα: ground truth (512 queries over all N) and the seed block (k=32) of
    # the insertion-built Slim index
    up_vecs, up_vn, up_ids = idx._seed_table()
    qall = torch.as_tensor(queries, device=dev)
    q512 = qall[:512].contiguous()
    kd, ki = bf.topk_dist(q512, x, xn, 10)
    pd_, pi = bf.topk_dist_plain(q512, x, xn, 11)
    agree_gt = tie_ok(ki.cpu().numpy(), pi.cpu().numpy(), pd_.cpu().numpy(),
                      10)
    err_gt = float((kd - pd_[:, :10]).abs().max())
    sd, si = bf.topk_dist(qall, up_vecs, up_vn, 32, row_ids=up_ids)
    psd, psi = bf.topk_dist_plain(qall, up_vecs, up_vn, 33, row_ids=up_ids)
    agree_seed = tie_ok(si.cpu().numpy(), psi.cpu().numpy(),
                        psd.cpu().numpy(), 32)
    err_seed = float((sd - psd[:, :32]).abs().max())
    seed_ms = cuda_ms(lambda: bf.topk_dist(qall, up_vecs, up_vn, 32,
                                           row_ids=up_ids))
    # a server batch (12 queries, as the HTTP batcher forms them) over the
    # same seed table
    q12 = qall[:12].contiguous()
    vd_, vi_ = bf.topk_dist(q12, up_vecs, up_vn, 32, row_ids=up_ids)
    pvd, pvi = bf.topk_dist_plain(q12, up_vecs, up_vn, 33, row_ids=up_ids)
    agree_sv = tie_ok(vi_.cpu().numpy(), pvi.cpu().numpy(),
                      pvd.cpu().numpy(), 32)
    err_sv = float((vd_ - pvd[:, :32]).abs().max())
    server_ms = cuda_ms(lambda: bf.topk_dist(q12, up_vecs, up_vn, 32,
                                             row_ids=up_ids), 20)
    n_up = up_vecs.shape[0]
    server_bound = bound(n_up * (d * 4 + 8) + 12 * (d * 4 + 32 * 8),
                         2 * 12 * n_up * d)
    # the two-call composite torch.cdist(q, x).topk(k, largest=False), fp32
    # with TF32 off, at both shapes: a yardstick, not one library call
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cdist_topk_ms = {
            "gt": cuda_ms(lambda: torch.cdist(q512, x).topk(
                10, largest=False)),
            "seeds": cuda_ms(lambda: torch.cdist(qall, up_vecs).topk(
                32, largest=False))}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    report["topk_dist"] = dict(
        cdist_topk_ms=cdist_topk_ms, seed_ms=seed_ms, server_ms=server_ms,
        server_bound=server_bound,
        agree=min(agree_gt, agree_seed, agree_sv),
        max_abs_err=max(err_gt, err_seed, err_sv),
        ms=cuda_ms(lambda: bf.topk_dist(q512, x, xn, 10)),
        plain_ms=cuda_ms(lambda: bf.topk_dist_plain(q512, x, xn, 10), 1),
        bound=bound(x.numel() * 4 + n * 4 + q512.numel() * 4 + 512 * 80,
                    2 * 512 * n * d),
        shapes=f"GT 512x{n} k=10 (agree {agree_gt:.4f}); seeds {NQ}x"
               f"{up_vecs.shape[0]} k=32 (agree {agree_seed:.4f}, kernel "
               f"{seed_ms:.3f} ms); server batch 12x{n_up} k=32 (agree "
               f"{agree_sv:.4f}, kernel {server_ms:.4f} ms, bound "
               f"{server_bound[0]:.4f} ms)")
    check(min(agree_gt, agree_seed, agree_sv) >= 0.99 and
          max(err_gt, err_seed, err_sv) <= 1e-4 * (1 + float(pd_.abs().max())),
          f"topk_dist disagrees with its plain version: {report['topk_dist']}")

    # Kβ serving: 512 queries, ef=64, pop 8, seeds as chal_search makes them;
    # and where a Slim search() call's time goes per ef
    def seeds(qt):
        s_d, s_pos = bf.topk_dist(qt, up_vecs, up_vn, 32, row_ids=up_ids)
        s_id = torch.where(s_pos >= 0, up_ids[s_pos.clamp(min=0).long()], -1)
        s_id = torch.where(torch.isinf(s_d), -1, s_id)
        return s_d, s_id.to(torch.int32).contiguous()

    def beam_kw(ef):
        P = gs.buffer_width(ef)
        return dict(P=P, ef_eff=ef, pop_width=8,
                    cw=gs.cand_width(P, 8, idx.dense0.shape[1], 0),
                    max_iters=SearchConfig(ef=ef, pop_width=8).iters(), k=10)

    s_all = seeds(qall)
    qn_all = (qall * qall).sum(-1)
    for row in slim_ins:
        beam_ms = cuda_ms(lambda: gs.beam_search(
            x, qall, qn_all, idx.dense0, *s_all, **beam_kw(row["ef"])))
        say(f"time split slim(insert) ef={row['ef']}: seeds {seed_ms:.3f} ms,"
            f" beam {beam_ms:.3f} ms, search() {row['search_ms']:.3f} ms"
            f" for {NQ} queries")
    # where a vanilla search() call's time goes: the greedy descent (Kε,
    # levels max..1 in one launch, as level_search runs it) and the level-0
    # beam (Kβ, pop 4) on the card
    g = h.graph

    def descend():
        cur, dist = gs.entry_dist(x, xn, qall, qn_all, g.entry)
        cur, dist, _, _ = gs.greedy_descent_levels(
            x, qall, qn_all, g.adjs[g.max_level:0:-1], g.max_level, cur,
            dist)
        return cur[:, None].contiguous(), dist[:, None].contiguous()

    greedy_ms = cuda_ms(descend)
    v_cur, v_dist = descend()
    for row in vanilla:
        ef = row["ef"]
        beam_ms = cuda_ms(lambda: gs.beam_search(
            x, qall, qn_all, g.adjs[0], v_dist, v_cur, P=ef, ef_eff=ef,
            pop_width=4, cw=gs.cand_width(ef, 4, g.adjs[0].shape[1], 0),
            max_iters=SearchConfig(ef=ef, pop_width=4).iters(), k=10))
        say(f"time split vanilla ef={ef}: greedy {greedy_ms:.3f} ms, beam "
            f"{beam_ms:.3f} ms, search() {row['search_ms']:.3f} ms for "
            f"{NQ} queries")
    kw_s = beam_kw(64)
    args_s = (x, q512, qn_all[:512], idx.dense0, *seeds(q512))
    sbd, sbi, _, sbc = gs.beam_search(*args_s, **kw_s)
    _, spi, _, spc = gs.beam_search_plain(*args_s, **kw_s)
    s_slots = float((sbi == spi).float().mean())
    s_ms = cuda_ms(lambda: gs.beam_search(*args_s, **kw_s))
    s_pms = cuda_ms(lambda: gs.beam_search_plain(*args_s, **kw_s), 1)
    report["beam_search"]["shapes"] += (
        f"; serving 512 q ef=64 pop 8 on the insertion Slim graph: slots "
        f"{s_slots:.5f}, {s_ms:.3f} ms vs plain {s_pms:.3f} ms, dcomp "
        f"{int(sbc.sum())} vs {int(spc.sum())}")
    check(s_slots >= 0.99, f"beam_search (serving) disagrees: {s_slots}")

    # Kγ on the NND build's and the conversion's prunes, 4096 real rows each
    x2, xn2 = h2.vectors, h2.vn
    cfg = SlimConfig.from_ratios()
    sel_rows = np.random.default_rng(0).choice(n, min(4096, n),
                                               replace=False)
    pick = torch.as_tensor(sel_rows, device=dev)
    b_sel = pick.to(torch.int32)
    knn, _ = nnd.nn_descent(x2, xn2, k=max(hcfg.maxM0, 48), rounds=25,
                            metric=hcfg.metric, seed=hcfg.seed)
    cand0 = torch.as_tensor(tb.level0_candidates(knn.cpu().numpy(), 16,
                                                 hcfg.seed), device=dev)
    all_ids = torch.arange(n, dtype=torch.int32, device=dev)
    sel0 = heuristic.prune_all(
        x2, xn2, all_ids, cand0,
        torch.full((n,), hcfg.M, dtype=torch.int32, device=dev),
        M=hcfg.M, keep_all_under_m=True, keep_pruned=True)
    u_rows, u_m = tb.level0_union(x2, xn2, sel0, hcfg.maxM0, hcfg.metric)
    adj_np = [a.cpu().numpy() for a in h2.graph.adjs]
    thr = prune.degree_thresholds(adj_np, h2.levels, adj_np[0].shape[1], cfg)
    deg_0 = (adj_np[0] >= 0).sum(1)
    budget = torch.as_tensor(np.where(deg_0 > thr[0], cfg.top_M0, cfg.low_m0)
                             .astype(np.int32), device=dev)
    pruned = heuristic.prune_all(x2, xn2, all_ids, h2.graph.adjs[0], budget,
                                 M=cfg.top_M0, keep_all_under_m=False,
                                 out_width=cfg.top_M0)
    p_np = pruned.cpu().numpy()
    s_ids = np.repeat(np.arange(n), cfg.top_M0)[p_np.ravel() >= 0]
    t_ids = p_np.ravel()[p_np.ravel() >= 0].astype(np.int64)
    key = np.unique(np.concatenate([(s_ids << 31) | t_ids,
                                    (t_ids << 31) | s_ids]))
    rows_u, counts = prune._group_rows(
        key >> 31, (key & ((1 << 31) - 1)).astype(np.int32),
        np.arange(n), n)
    over = np.argsort(-counts)[: min(32, int((counts > 60).sum()))]
    kg_in = [  # (what, base ids, candidates, budgets, flags)
        ("nnd knn_to_level0 prune", b_sel, cand0[pick].contiguous(),
         torch.full((len(sel_rows),), hcfg.M, dtype=torch.int32, device=dev),
         dict(keep_all_under_m=True, keep_pruned=True, out_width=hcfg.M)),
        ("nnd union re-prune", b_sel, u_rows[pick].contiguous(),
         u_m[pick].contiguous(),
         dict(keep_all_under_m=True, keep_pruned=False,
              out_width=hcfg.maxM0)),
        ("nnd conversion stage 2", b_sel,
         h2.graph.adjs[0][pick].contiguous(), budget[pick].contiguous(),
         dict(keep_all_under_m=False, keep_pruned=False,
              out_width=cfg.top_M0)),
    ]
    if len(over):
        kg_in.append((
            "nnd conversion stage 4 hub rows",
            torch.as_tensor(over.astype(np.int32), device=dev),
            torch.as_tensor(rows_u[over], device=dev),
            torch.full((len(over),), 60, dtype=torch.int32, device=dev),
            dict(keep_all_under_m=False, keep_pruned=False, out_width=60)))
    for what, b_ids, cnd, m_row, kw_g in kg_in:
        kg_part(what, x2, xn2, b_ids, cnd, m_row, kw_g)
    first = kg_parts[0]
    tot_rows = sum(p["rows"] for p in kg_parts)
    report["rng_prune"] = dict(
        rows_agree=sum(p["rows_agree"] * p["rows"] for p in kg_parts)
        / tot_rows,
        counts_agree=sum(p["counts_agree"] * p["rows"] for p in kg_parts)
        / tot_rows,
        max_abs_err=max(p["max_abs_err"] for p in kg_parts),
        ms=first["ms"], plain_ms=first["plain_ms"], bound=first["bound"],
        shapes=f"{len(kg_parts)} parts; max_abs_err is the largest "
               "kept-count difference; ms, plain_ms and bound of the first "
               f"part; widest stage-4 row {int(counts.max())} ids")
    check(report["rng_prune"]["rows_agree"] >= 0.99
          and report["rng_prune"]["counts_agree"] >= 0.99,
          f"rng_prune disagrees with its plain version: {report['rng_prune']}")

    # Kδ: one NND chunk (8192 nodes) of a real round
    gen = torch.Generator(device=dev).manual_seed(0)
    st_i, st_d, st_f = nnd.rp_init(gen, x2, xn2, n, k=60, n_proj=4,
                                   metric="l2")
    cnd, st_f = nnd._nnd_candidates(st_i, st_f, n, s_fwd=60, r_rev=30,
                                    draws=nnd.nnd_draws(gen, n, 60, 60,
                                                        30, dev))
    c = min(8192, n)
    ch = (x2, xn2, st_i[:c].contiguous(), st_d[:c].contiguous(),
          st_f[:c].contiguous(), cnd[:c].contiguous())
    ki_, kd_, kf_, kins = nnd._chunked_cand_merge(*ch)
    pi_, pd2, pf_, pins = nnd.cand_merge_plain(*ch, chunk=c)
    rows_eq = (ki_ == pi_).all(dim=1)
    fin = torch.isfinite(pd2) & rows_eq[:, None]
    ins_diff = abs(int(kins) - int(pins)) / max(1, int(pins))
    valid_c = int((ch[5] >= 0).sum())
    report["cand_merge"] = dict(
        agree=float(rows_eq.float().mean()),
        max_abs_err=float((kd_ - pd2)[fin].abs().max()) if fin.any() else 0.0,
        ms=cuda_ms(lambda: nnd._chunked_cand_merge(*ch)),
        plain_ms=cuda_ms(lambda: nnd.cand_merge_plain(*ch, chunk=c), 1),
        bound=bound(valid_c * (d + 1) * 4 + ch[5].numel() * 4
                    + c * 60 * 12 * 2 + c * d * 4, valid_c * 2 * d),
        shapes=f"{c} rows K=60 C={cnd.shape[1]}; inserted {int(kins)} vs "
               f"{int(pins)}")
    check(report["cand_merge"]["agree"] >= 0.99 and ins_diff <= 0.01,
          f"cand_merge disagrees with its plain version: "
          f"{report['cand_merge']}")
    # ---- the modes of phases 3 and 4, each against its plain version ------
    def beam_pair(what, fetch, seeds_, kw_b, nq, filt=None):
        """Kβ and its plain version on one call's inputs: agreement of the
        returned ids (the track's when filtered, and then also of each
        query's admitted count), both times, the bound from this call's own
        hops and distance computations. ``filt``: beam_search's filter
        keywords, {"allowed"} or {"tags", "need", "iters"}, over the first
        ``nq`` queries."""
        args_b = (x, qall[:nq].contiguous(), qn_all[:nq].contiguous(), fetch,
                  seeds_[0][:nq].contiguous(), seeds_[1][:nq].contiguous())
        extra = {}
        if filt is not None:
            t_d, t_i = gs.filter_track_init(
                filt.get("allowed"), args_b[5][:, 0], args_b[4][:, 0],
                kw_b["P"], filt.get("tags"), filt.get("need"))
            extra = dict(filt, track_d=t_d, track_id=t_i)
        k_o = gs.beam_search(*args_b, **kw_b, **extra)
        p_o = gs.beam_search_plain(*args_b, **kw_b, **extra,
                                   seen=(sn := []))
        col = 5 if filt is not None else 1
        same = k_o[col] == p_o[col]
        agree = float(same.float().mean())
        if filt is not None:
            agree = min(agree, float((k_o[6] == p_o[6]).float().mean()))
        fin = same & torch.isfinite(p_o[col - 1])
        hops_, dc_ = int(k_o[2].sum()), int(k_o[3].sum())
        n_vec = distinct([v for _, v in sn])
        n_bytes = (distinct([a for a, _ in sn]) * fetch.width * 4
                   + n_vec * d * 4 + nq * d * 4
                   + nq * (kw_b["k"] * 8 + 8) + args_b[4].numel() * 8)
        if filt is not None:  # the track; a scored node's allowed byte or
            # tag word, a query's need word and cap
            n_bytes += 2 * nq * kw_b["P"] * 8 + (
                n_vec if "allowed" in filt else 4 * n_vec + 8 * nq)
        rep = dict(
            agree=agree,
            max_abs_err=float((k_o[col - 1] - p_o[col - 1])[fin].abs().max()),
            ms=cuda_ms(lambda: gs.beam_search(*args_b, **kw_b, **extra)),
            plain_ms=cuda_ms(
                lambda: gs.beam_search_plain(*args_b, **kw_b, **extra), 1),
            bound=bound(n_bytes, dc_ * 4 * d),
            shapes=f"{what}: {nq} queries, P {kw_b['P']}, E "
                   f"{kw_b['pop_width']}, W {fetch.width}, hops {hops_} vs "
                   f"{int(p_o[2].sum())}, dcomp {dc_} vs {int(p_o[3].sum())}"
                   + ("" if filt is None else
                      f", admitted {int(k_o[6].sum())} vs "
                      f"{int(p_o[6].sum())}"))
        check(rep["agree"] >= 0.99, f"beam_search ({what}) disagrees with "
                                    f"its plain version: {rep}")
        return rep, k_o

    gq = idx.graph
    chal0 = gs.chal_fetch(gq.nbr, gq.lvl_off, 0, gq.cap0)
    s_512 = seeds(q512)
    rep_d, out_d = beam_pair("dense rows, level 0, seeded ef=64",
                             gs.dense_fetch(idx.dense0), s_512, kw_s, 512)
    report["beam_search.chal"], out_c = beam_pair(
        "CHAL slices, level 0, seeded ef=64", chal0, s_512, kw_s, 512)
    check(all(torch.equal(a, b_) for a, b_ in zip(out_d, out_c)),
          "Kβ over CHAL slices differs from Kβ over dense rows")
    report["beam_search.chal"]["shapes"] += (
        f"; identical to the dense form ({rep_d['ms']:.3f} ms)")
    # level 1 of the threshold_level=1 graph: descend to level 2 (Kε over
    # rank rows), then the ef=64 beam over rank rows and over CHAL slices
    g1 = idx_t1.graph
    c1, d1 = gs.entry_dist(x, xn, q512, qn_all[:512], g1.entry)
    for l in range(g1.max_level, min(1, g1.max_level), -1):
        c1, d1, _, _ = gs.greedy_descent(
            x, q512, qn_all[:512],
            gs.rank_fetch(idx_t1.rank_up, idx_t1.dense_up[l - 1]), c1, d1)
    s_l1 = (d1[:, None].contiguous(), c1[:, None].contiguous())
    kw_l1 = dict(P=64, ef_eff=64, pop_width=8,
                 cw=gs.cand_width(64, 8, g1.cap, 0),
                 max_iters=SearchConfig(ef=64, pop_width=8).iters(), k=64)
    lv1 = min(1, g1.max_level)
    rank1 = gs.rank_fetch(idx_t1.rank_up, idx_t1.dense_up[lv1 - 1]) \
        if lv1 else gs.dense_fetch(idx_t1.dense0)
    report["beam_search.rank"], out_r = beam_pair(
        f"rank rows, level {lv1} of the threshold_level=1 graph, ef=64",
        rank1, s_l1, kw_l1, 512)
    _, out_rc = beam_pair(
        f"CHAL slices, level {lv1} of the threshold_level=1 graph",
        gs.chal_fetch(g1.nbr, g1.lvl_off, lv1, g1.cap if lv1 else g1.cap0),
        s_l1, kw_l1, 512)
    check(all(torch.equal(a, b_) for a, b_ in zip(out_r, out_rc)),
          "Kβ over rank rows differs from Kβ over CHAL slices")
    f_parts = []
    for share in (0.5, 0.1):
        allowed_t = torch.as_tensor(masks[share][0], device=dev)
        kw_f = dict(kw_s, cw=gs.cand_width(kw_s["P"], 8, gq.cap0, 0),
                    max_iters=int(kw_s["max_iters"] / max(share, 0.05)) + 8)
        rep_f, out_f = beam_pair(f"filtered, {share} allowed, dense rows, "
                                 "seeded ef=64", gs.dense_fetch(idx.dense0),
                                 s_512, kw_f, 512, filt=dict(allowed=allowed_t))
        check(bool(allowed_t[out_f[5][out_f[5] >= 0].long()].all()),
              "Kβ filtered returned a disallowed id")
        say(f"kernel beam_search.filtered part: {json.dumps(rep_f)}")
        f_parts.append(rep_f)
    report["beam_search.filtered"] = dict(
        f_parts[0], agree=min(p_["agree"] for p_ in f_parts),
        max_abs_err=max(p_["max_abs_err"] for p_ in f_parts),
        shapes=f_parts[0]["shapes"] + "; at 0.1 allowed: "
        + f_parts[1]["shapes"] + f", {f_parts[1]['ms']:.3f} ms vs plain "
        f"{f_parts[1]['plain_ms']:.3f} ms")
    # the tag mode at the label cell's shapes: all 4096 queries with their
    # exact seeds, ef 128 (P 128, E 8) over dense rows, the query phase's
    # one-hot words of 12 labels, each query capped by its label's share
    t_tags = torch.as_tensor(tags.view(np.int32), device=dev)
    t_need = torch.as_tensor(need.view(np.int32), device=dev)
    share_l = {int(w): float((tags == w).mean()) for w in np.unique(need)}
    kw_t = dict(beam_kw(128), cw=gs.cand_width(gs.buffer_width(128), 8,
                                               gq.cap0, 0))
    t_iters = hnsw_mod.share_iters(kw_t["max_iters"],
                                   [share_l[int(w)] for w in need])
    kw_t["max_iters"] = int(t_iters.max())
    rep_t, out_t = beam_pair(
        "tags, 12 one-hot labels, dense rows, seeded ef=128",
        gs.dense_fetch(idx.dense0), s_all, kw_t, NQ,
        filt=dict(tags=t_tags, need=t_need,
                  iters=torch.as_tensor(t_iters, device=dev)))
    t_ti = out_t[5]
    t_row = t_tags[t_ti.clamp(min=0).long()]
    check(bool(((t_row & t_need[:, None]) == t_need[:, None])[t_ti >= 0]
               .all()), "Kβ tag mode returned an id its query's predicate "
                        "fails")
    report["beam_search.tags"] = rep_t

    # Kε over rank rows and over CHAL slices: the seed_width=0 descent of
    # the Slim index, all 4096 queries, each level from the plain state
    def greedy_pair(form):
        pc_, pd_ = gs.entry_dist(x, xn, qall, qn_all, gq.entry)
        eq_, tot_, err_, kms, pms, byt, flo = 0, 0, 0.0, 0.0, 0.0, 0, 0
        curs, vecs = [], []
        for l in range(gq.max_level, 0, -1):
            fch = gs.rank_fetch(idx.rank_up, idx.dense_up[l - 1]) \
                if form == "rank" else gs.chal_fetch(gq.nbr, gq.lvl_off, l,
                                                     gq.cap)
            st_ = (x, qall, qn_all, fch, pc_, pd_)
            kc_, kd_, kh_, kdc_ = gs.greedy_descent(*st_)
            kms += cuda_ms(lambda: gs.greedy_descent(*st_))
            pms += cuda_ms(lambda: gs.greedy_descent_plain(*st_), 1)
            npc, npd, _, _ = gs.greedy_descent_plain(*st_, seen=(sn := []))
            same_ = kc_ == npc
            eq_, tot_ = eq_ + int(same_.sum()), tot_ + len(same_)
            if same_.any():
                err_ = max(err_, float((kd_ - npd)[same_].abs().max()))
            byt += distinct([a for a, _ in sn]) * (fch.width * 4 + 8)
            vecs += [v for _, v in sn]
            flo += int(kdc_.sum()) * 4 * d
            curs.append(kc_)
            pc_, pd_ = npc, npd
        byt += distinct(vecs) * d * 4 + qall.numel() * 4 + NQ * 16
        fl = [gs.rank_fetch(idx.rank_up, idx.dense_up[l - 1])
              if form == "rank" else gs.chal_fetch(gq.nbr, gq.lvl_off, l,
                                                   gq.cap)
              for l in range(gq.max_level, 0, -1)]
        c0, d0 = gs.entry_dist(x, xn, qall, qn_all, gq.entry)
        fused = descent_pair((x, qall, qn_all, fl, gq.max_level, c0, d0), {})
        rep = dict(agree=min(eq_ / max(1, tot_), fused["agree"]),
                   max_abs_err=max(err_, fused["max_abs_err"]),
                   ms=fused["ms"], plain_ms=fused["plain_ms"],
                   per_level_ms=kms, per_level_plain_ms=pms, fused=fused,
                   bound=bound(byt, flo),
                   shapes=f"{NQ} queries, levels {gq.max_level}..1 of the "
                          f"Slim graph through {form} rows: one launch "
                          f"{fused['ms']:.4f} ms, per level {kms:.4f} ms")
        check(rep["agree"] >= 0.99 and fused["path_agree"] >= 0.99,
              f"greedy_descent ({form}) disagrees with its plain version: "
              f"{rep}")
        return rep, curs

    report["greedy_descent.rank"], cur_r = greedy_pair("rank")
    report["greedy_descent.chal"], cur_c = greedy_pair("chal")
    check(all(torch.equal(a, b_) for a, b_ in zip(cur_r, cur_c)),
          "Kε over rank rows differs from Kε over CHAL slices")

    # Kα in strata mode: the seed block of seed_strata=4, all 4096 queries
    st_args = (qall, up_vecs, up_vn, up_ids, 32, 4)
    ksd, ksi = bf.topk_dist_strata(*st_args)
    psd_, psi_ = bf.topk_dist_strata_plain(*st_args)
    fin = torch.isfinite(psd_)
    n_upv = int((up_ids >= 0).sum())
    report["topk_dist.strata"] = dict(
        agree=float((ksi == psi_).float().mean()),
        max_abs_err=float((ksd - psd_)[fin].abs().max()),
        ms=cuda_ms(lambda: bf.topk_dist_strata(*st_args)),
        plain_ms=cuda_ms(lambda: bf.topk_dist_strata_plain(*st_args), 1),
        bound=bound(up_vecs.numel() * 4 + up_vecs.shape[0] * 8
                    + qall.numel() * 4 + NQ * 32 * 8,
                    2 * NQ * up_vecs.shape[0] * d),
        shapes=f"{NQ} x {up_vecs.shape[0]} rows ({n_upv} valid), 4 segments "
               "x 8 seeds")
    check(report["topk_dist.strata"]["agree"] >= 0.99
          and bool(torch.equal(torch.isfinite(ksd), fin)),
          f"topk_dist (strata) disagrees with its plain version: "
          f"{report['topk_dist.strata']}")

    # Kγ guarded: one chunk of the SlimZero conversion with its live guard
    gb, gc, gg, gm, gw = g_rec.rec
    kw_gd = dict(keep_all_under_m=False, keep_pruned=False, out_width=gw)
    kgs, kgc = heuristic.rng_prune(x, xn, gb, gc, gm, guard=gg, **kw_gd)
    pgs, pgc = heuristic.rng_prune_plain(x, xn, gb, gc, gm, guard=gg,
                                         **kw_gd)
    g_valid = int((gc >= 0).sum())
    report["rng_prune.guarded"] = dict(
        rows_agree=float((kgs == pgs).all(dim=1).float().mean()),
        counts_agree=float((kgc == pgc).float().mean()),
        max_abs_err=float((kgc - pgc).abs().max()),
        ms=cuda_ms(lambda: heuristic.rng_prune(x, xn, gb, gc, gm, guard=gg,
                                               **kw_gd)),
        plain_ms=cuda_ms(lambda: heuristic.rng_prune_plain(
            x, xn, gb, gc, gm, guard=gg, **kw_gd), 1),
        bound=bound(gc.numel() * 5 + g_valid * (d + 1) * 4
                    + len(gb) * (d + 2 + gw) * 4, g_valid * 2 * d),
        shapes=f"one recorded chunk: {len(gb)} rows, C {gc.shape[1]}, "
               f"{int(gg.sum())} guarded of {g_valid} candidates, "
               f"{int((kgc > gm).sum())} rows kept past their budget; "
               "max_abs_err is the largest kept-count difference")
    check(report["rng_prune.guarded"]["rows_agree"] >= 0.99
          and report["rng_prune.guarded"]["counts_agree"] >= 0.99,
          f"rng_prune (guarded) disagrees with its plain version: "
          f"{report['rng_prune.guarded']}")


    # ---- SlimQ's kernels and modes, on the SlimQ index ---------------------
    mq_t = torch.as_tensor(mq, device=dev)
    mx = sq._dataset_dev
    rot = sq.rotator
    p_rot = rot.padded_dim
    nbq, exq = int(sq.codes.bin_code.shape[1]), int(sq.codes.ex_bits)

    def cand_b(use_ex):
        """Bytes a scored candidate needs of its packed row: the bit planes
        the mode reads (the 1-bit plane, with use_ex also the ex planes), one
        factor pair and the cluster id."""
        return 4 * nbq * (1 + exq if use_ex else 1) + 12

    n_c = int(sq.centroids_rot.shape[0])
    up_rows, up_ids_q = sq._seed_table()

    def est_err(a, b_):
        """max |a - b| relative to 1 + |b| (estimates cancel large terms)"""
        return float(((a - b_).abs() / (1 + b_.abs())).max())

    # Kη on the 4096 queries (and its rate on one 262144-row build chunk)
    k_rot = qrot.fht_rotate(mq_t, rot.signs, rot.fac)
    p_rot_out = qrot._rotate(mq_t, rot.signs, rot.fac)
    chunk_x = mx[:min(n, 262144)].contiguous()
    build_ms = cuda_ms(lambda: qrot.fht_rotate(chunk_x, rot.signs, rot.fac))
    report["fht_rotate"] = dict(
        agree=float((k_rot == p_rot_out).float().mean()),
        max_abs_err=float((k_rot - p_rot_out).abs().max()),
        ms=cuda_ms(lambda: qrot.fht_rotate(mq_t, rot.signs, rot.fac), 10),
        plain_ms=cuda_ms(lambda: qrot._rotate(mq_t, rot.signs, rot.fac)),
        bound=bound(8 * p_rot * NQ + 16 * p_rot,
                    NQ * p_rot * 4 * (2 + p_rot.bit_length() - 1)),
        shapes=f"{NQ} queries, dim 128 -> P {p_rot}; one build chunk of "
               f"{len(chunk_x)} rows: {build_ms:.3f} ms (bound "
               f"{bound(8 * p_rot * len(chunk_x), 0)[0]:.3f} ms)")
    check(report["fht_rotate"]["max_abs_err"] <= 1e-6,
          f"fht_rotate disagrees with its plain version: "
          f"{report['fht_rotate']}")
    ks_, kg_ = qrot.g_tables(k_rot, sq.centroids_rot)
    ps_, pg_ = qrot.g_tables_plain(k_rot, sq.centroids_rot)
    report["fht_rotate.g_tables"] = dict(
        agree=1.0, max_abs_err=max(est_err(ks_, ps_), est_err(kg_, pg_)),
        ms=cuda_ms(lambda: qrot.g_tables(k_rot, sq.centroids_rot), 10),
        plain_ms=cuda_ms(lambda: qrot.g_tables_plain(k_rot,
                                                     sq.centroids_rot)),
        bound=bound(4 * (NQ * p_rot + n_c * p_rot + NQ * (n_c + 1)),
                    3 * NQ * n_c * p_rot + NQ * p_rot),
        shapes=f"{NQ} rotated queries x {n_c} centroids, P {p_rot}; "
               "max_abs_err relative to 1 + |value|")
    check(report["fht_rotate.g_tables"]["max_abs_err"] <= 1e-5,
          f"g_tables disagrees with its plain version: "
          f"{report['fht_rotate.g_tables']}")

    def scorer_for(qt, use_ex):
        q_rot_ = rot.rotate(qt)
        sumq_, g_add_ = qrot.g_tables(q_rot_, sq.centroids_rot)
        return qest.QuantScorer(sq._packed_rows(), nbq, exq, use_ex, q_rot_,
                                sumq_, g_add_)

    def est_seeds(sc):
        s_d, s_pos = bf.topk_estimate(
            sc._replace(rows=up_rows, use_ex=False), up_ids_q, 32)
        s_id = torch.where(s_pos >= 0,
                           up_ids_q[s_pos.clamp(min=0).long()], -1)
        return s_d.contiguous(), s_id.to(torch.int32).contiguous()

    # Kα in estimate mode: the seed block, all 4096 queries
    sc_all = scorer_for(mq_t, False)
    st_all = sc_all._replace(rows=up_rows)
    ked, kep = bf.topk_estimate(st_all, up_ids_q, 32)
    ped, pep = bf.topk_estimate_plain(st_all, up_ids_q, 33)
    n_upq = int((up_ids_q >= 0).sum())
    agree_e = tie_ok(kep.cpu().numpy(), pep.cpu().numpy(), ped.cpu().numpy(),
                     32)
    est_ms = cuda_ms(lambda: bf.topk_estimate(st_all, up_ids_q, 32))
    report["topk_dist.estimate"] = dict(
        agree=agree_e, max_abs_err=est_err(ked, ped[:, :32]), ms=est_ms,
        plain_ms=cuda_ms(lambda: bf.topk_estimate_plain(st_all, up_ids_q,
                                                        32), 1),
        bound=bound(up_rows.shape[0] * (cand_b(False) + 4)
                    + NQ * (p_rot + n_c + 1) * 4 + NQ * 32 * 8,
                    2 * NQ * up_rows.shape[0] * p_rot),
        shapes=f"{NQ} x {up_rows.shape[0]} packed rows ({n_upq} valid, "
               f"{cand_b(False)} B of each read), k=32; max_abs_err relative "
               "to 1 + |estimate|")
    check(agree_e >= 0.99 and report["topk_dist.estimate"]["max_abs_err"]
          <= 1e-4, f"topk_dist (estimate) disagrees with its plain version: "
                   f"{report['topk_dist.estimate']}")

    # Kα with k=1 over the 16 centroids: one KMeans assignment chunk, beside
    # the one PyTorch call that computes it (the same kernel as every other
    # topk_dist call, so a line of its own and no row of the kernel table)
    cent_q, _ = qkm.kmeans(chunk_x[:65536], k=16, iters=2)
    cent_t = torch.as_tensor(cent_q, device=dev)
    cn_t = (cent_t * cent_t).sum(1)
    k_as = qkm._assign(chunk_x, cent_t)
    p_as_d, p_as = bf.topk_dist_plain(chunk_x, cent_t, cn_t, 2)
    lib_as = torch.cdist(chunk_x, cent_t).argmin(dim=1)
    near = (p_as_d[:, 1] - p_as_d[:, 0]) <= 1e-5 * (1 + p_as_d[:, 0].abs())
    report[KM_PAIR] = dict(
        agree=float(((k_as == p_as[:, 0].long()) | near).float().mean()),
        max_abs_err=float((bf.topk_dist(chunk_x, cent_t, cn_t, 1)[0][:, 0]
                           - p_as_d[:, 0]).abs().max()),
        ms=cuda_ms(lambda: qkm._assign(chunk_x, cent_t)),
        plain_ms=cuda_ms(lambda: bf.topk_dist_plain(chunk_x, cent_t, cn_t,
                                                    1)),
        library_ms=cuda_ms(lambda: torch.cdist(chunk_x, cent_t).argmin(dim=1)),
        bound=bound(chunk_x.numel() * 4 + cent_t.numel() * 4
                    + len(chunk_x) * 8, 2 * len(chunk_x) * 16 * d),
        shapes=f"{len(chunk_x)} rows x 16 centroids, k=1; equal to "
               f"torch.cdist().argmin() on "
               f"{float((k_as == lib_as).float().mean()):.5f} of rows")
    check(report[KM_PAIR]["agree"] >= 0.999,
          f"topk_dist (k=1, KMeans assignment) disagrees with its plain "
          f"version: {report[KM_PAIR]}")

    # Kβ quant / quant_ex / rerank: 512 queries, ef 64, pop 8, seeded as the
    # SlimQ search seeds them
    mq512 = mq_t[:512].contiguous()
    kw_q = dict(P=64, ef_eff=64, pop_width=8,
                cw=gs.cand_width(64, 8, sq.graph.cap0, 0),
                max_iters=SearchConfig(ef=64, pop_width=8).iters(), k=64)
    track0 = gs.pop_track_init(mx, mq512, 16)

    def quant_beam_pair(what, use_ex, with_track):
        sc = scorer_for(mq512, use_ex)
        args_q = (None, None, None, gs.dense_fetch(sq.dense0), *est_seeds(sc))
        extra = dict(scorer=sc, pop_track=track0 if with_track else None)
        k_o = gs.beam_search(*args_q, **kw_q, **extra)
        p_o = gs.beam_search_plain(*args_q, **kw_q, **extra,
                                   seen=(sn := []))
        if with_track:
            same = k_o[4].ids == p_o[4].ids
            fin = same & torch.isfinite(p_o[4].d)
            err_ = float((k_o[4].d - p_o[4].d)[fin].abs().max())
        else:
            same = k_o[1] == p_o[1]
            fin = same & torch.isfinite(p_o[0])
            err_ = est_err(k_o[0][fin], p_o[0][fin])
        hops_, dc_ = int(k_o[2].sum()), int(k_o[3].sum())
        planes = 1 + exq if use_ex else 1
        n_pop = distinct([a for a, _ in sn])
        n_bytes = (n_pop * sq.dense0.shape[1] * 4
                   + distinct([v for _, v in sn]) * cand_b(use_ex)
                   + 512 * (p_rot + n_c + 1) * 4 + 512 * 32 * 8
                   + 512 * 64 * 8)
        n_flops = dc_ * 2 * p_rot * planes
        if with_track:  # one raw row per pop, the raw query, the track
            n_bytes += n_pop * d * 4 + 512 * (d * 4 + 2 * 16 * 8)
            n_flops += hops_ * 4 * d
        rep = dict(
            agree=float(same.float().mean()), max_abs_err=err_,
            ms=cuda_ms(lambda: gs.beam_search(*args_q, **kw_q, **extra)),
            plain_ms=cuda_ms(
                lambda: gs.beam_search_plain(*args_q, **kw_q, **extra), 1),
            bound=bound(n_bytes, n_flops),
            shapes=f"{what}: 512 queries, ef 64, E 8, W "
                   f"{sq.dense0.shape[1]}, {cand_b(use_ex)} B per scored "
                   f"candidate, hops {hops_} vs {int(p_o[2].sum())}, dcomp "
                   f"{dc_} vs {int(p_o[3].sum())}; buffer slots equal "
                   f"{float((k_o[1] == p_o[1]).float().mean()):.5f}")
        check(rep["agree"] >= 0.99, f"beam_search ({what}) disagrees with "
                                    f"its plain version: {rep}")
        return rep, k_o

    report["beam_search.quant"], _ = quant_beam_pair(
        "1-bit estimates, no track; max_abs_err relative to 1 + |estimate|",
        False, False)
    report["beam_search.quant_ex"], _ = quant_beam_pair(
        "full-code estimates (4 planes), no track; max_abs_err relative to "
        "1 + |estimate|", True, False)
    report["beam_search.rerank"], out_rr = quant_beam_pair(
        "1-bit estimates with the rerank track (kk 16); agreement over the "
        "track's ids, max_abs_err over its exact distances", False, True)
    rr_ids = out_rr[4].ids
    rr_true = ((mq512[:, None, :] - mx[rr_ids.clamp(min=0).long()]) ** 2
               ).sum(-1)
    check(bool(torch.allclose(out_rr[4].d[rr_ids >= 0],
                              rr_true[rr_ids >= 0], rtol=1e-3, atol=1e-3)),
          "Kβ's rerank track does not hold the true distances")

    # Kε on estimates: the seed_width=0 descent, all 4096 queries, each
    # level from the plain state; at the top level the kernel scores the
    # entry point itself
    gq_ = sq.graph
    ent = torch.full((NQ,), gq_.entry, dtype=torch.int32, device=dev)
    pc_, pd_ = ent, None
    eq_, tot_, err_, kms, pms, byt, flo = 0, 0, 0.0, 0.0, 0.0, 0, 0
    vecs = []
    for l in range(gq_.max_level, 0, -1):
        fch = gs.rank_fetch(sq.rank_up, sq.dense_up[l - 1])
        st_ = (None, None, None, fch, pc_, pd_)
        kc_, kd_, kh_, kdc_ = gs.greedy_descent(*st_, scorer=sc_all)
        kms += cuda_ms(lambda: gs.greedy_descent(*st_, scorer=sc_all))
        pms += cuda_ms(lambda: gs.greedy_descent_plain(*st_, scorer=sc_all),
                       1)
        npc, npd, _, _ = gs.greedy_descent_plain(*st_, scorer=sc_all,
                                                 seen=(sn := []))
        same_ = kc_ == npc
        eq_, tot_ = eq_ + int(same_.sum()), tot_ + len(same_)
        if same_.any():
            err_ = max(err_, est_err(kd_[same_], npd[same_]))
        byt += distinct([a for a, _ in sn]) * (fch.width * 4 + 8)
        vecs += [v for _, v in sn]
        flo += (int(kdc_.sum()) + NQ * (pd_ is None)) * 2 * p_rot
        pc_, pd_ = npc, npd
    byt += (distinct(vecs) * cand_b(False) + NQ * (p_rot + n_c + 1) * 4
            + NQ * 16)
    fused = descent_pair(
        (None, None, None, [gs.rank_fetch(sq.rank_up, sq.dense_up[l - 1])
                            for l in range(gq_.max_level, 0, -1)],
         gq_.max_level, ent, None), dict(scorer=sc_all), est_err)
    report["greedy_descent.quant"] = dict(
        agree=min(eq_ / max(1, tot_), fused["agree"]),
        max_abs_err=max(err_, fused["max_abs_err"]), ms=fused["ms"],
        plain_ms=fused["plain_ms"], per_level_ms=kms,
        per_level_plain_ms=pms, fused=fused, bound=bound(byt, flo),
        shapes=f"{NQ} queries, levels {gq_.max_level}..1 of the SlimQ graph "
               f"through rank rows, 1-bit estimates ({cand_b(False)} B per "
               "scored candidate), the entry point scored first: one launch "
               f"{fused['ms']:.4f} ms, per level {kms:.4f} ms; max_abs_err "
               "relative to 1 + |estimate|")
    check(report["greedy_descent.quant"]["agree"] >= 0.99
          and fused["path_agree"] >= 0.99,
          f"greedy_descent (quant) disagrees with its plain version: "
          f"{report['greedy_descent.quant']}")

    # where a SlimQ search() call's time goes per ef: rotation + table,
    # seeds, beam with the rerank track (CUDA events, 4096 queries)
    rot_ms = cuda_ms(lambda: scorer_for(mq_t, False), 10)
    s_allq = est_seeds(sc_all)
    track_all = gs.pop_track_init(mx, mq_t, 16)
    for ef in SLIMQ_EFS:
        beam_ms = cuda_ms(lambda: gs.beam_search(
            None, None, None, gs.dense_fetch(sq.dense0), *s_allq,
            **dict(kw_q, P=ef, ef_eff=ef, k=ef,
                   cw=gs.cand_width(ef, 8, sq.graph.cap0, 0),
                   max_iters=SearchConfig(ef=ef, pop_width=8).iters()),
            scorer=sc_all, pop_track=track_all))
        row = sq_rows[f"rerank ef={ef}"]
        row["split_ms"] = {"rotate+table": round(rot_ms, 3),
                           "seeds": round(est_ms, 3),
                           "beam": round(beam_ms, 3)}
        say(f"time split slimq ef={ef}: rotate+table {rot_ms:.3f} ms, seeds "
            f"{est_ms:.3f} ms, beam {beam_ms:.3f} ms, search() "
            f"{row['search_ms']:.3f} ms for {NQ} queries")

    # ---- 8. incremental updates on the insertion index ---------------------
    class UpdateRecorder:
        """Records, during the update rounds, the inputs of one Kι call on
        an update batch's reverse-edge list and of one collect-mode level-0
        apply (its pre-apply adjacency and degrees). The wrapped calls run
        unchanged."""

        def __init__(self):
            self.sort_in = self.apply_in = None

        @contextlib.contextmanager
        def installed(self):
            srt, ap = revconn.kv_sort, revconn.apply_insert

            def srt_w(keys, payload=None, n=None):
                if self.sort_in is None and payload is not None and \
                        len(keys) == UPD_BATCH * hcfg.M:
                    self.sort_in = (keys.clone(), payload.clone(), n)
                return srt(keys, payload, n)

            def ap_w(adj, deg, vecs, vn, a_ids, cand, **kw):
                if self.apply_in is None and kw["of_t"] == 16384:
                    self.apply_in = (adj.clone(), deg.clone(), a_ids.clone(),
                                     cand.clone(), kw)
                return ap(adj, deg, vecs, vn, a_ids, cand, **kw)

            revconn.kv_sort, revconn.apply_insert = srt_w, ap_w
            try:
                yield self
            finally:
                revconn.kv_sort, revconn.apply_insert = srt, ap

    cuda.reset_launches()
    t_phase = time.perf_counter()
    slim_cfg = SlimConfig.from_ratios()
    # update batches reuse the base's cluster centres (same seed: the centres
    # are drawn first), new points around them: four add batches (the last
    # one for SlimZero) and the vectors of the reused slots
    extra, _ = clustered(5 * UPD_BATCH, 128, n_queries=0,
                         n_clusters=max(64, n // 1000), seed=7, scale=0.3)
    vec_np = np.empty((n + 4 * UPD_BATCH, 128), np.float32)
    vec_np[:n] = base
    pre_recall = slim_ins[EFS.index(64)]["recall@10"]
    t0 = time.perf_counter()
    server = SlimServer(h, slim_cfg=slim_cfg, port=0, device=dev)
    torch.cuda.synchronize()
    t_full = time.perf_counter() - t0
    inc, srv, g_inc = server.inc, server.slim, server.chal_unpadded
    say(f"updates: SlimServer(h) {t_full:.2f} s: IncrementalSlim.full, split "
        f"(s) {json.dumps({k: round(v, 3) for k, v in inc.last_stats['seconds'].items() if v >= 0.05})}"
        ", then both dense layouts")
    check(torch.equal(g_inc.nbr, idx.graph.nbr)
          and torch.equal(g_inc.lvl_off, idx.graph.lvl_off)
          and torch.equal(g_inc.level, idx.graph.level),
          "IncrementalSlim.full differs from convert_to_slim")
    srv.scfg = scfg_slim(64)
    client, client_vecs = g_inc, base
    upd_rounds = []

    def update_round(label, new_vecs, slots=None):
        """One SlimServer.update_index call without HTTP (an add batch, or,
        with ``slots``, the batch that reuses those deleted slots): insert,
        incremental re-prune, serving-layout refresh, patch writer; then
        the patch chunks, the client apply and the checks."""
        nonlocal client, client_vecs
        prev = h.graph.n
        # severed slots can cut the Slim graph where the full pass would
        # bridge it again, so the round that reuses slots re-runs the
        # connectivity repair; an add batch links into the graph and the
        # reference repairs nothing there
        inc.repair_updates = slots is not None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with cuda.tagged("update"):
            writer = server.update_index(new_vecs)
        torch.cuda.synchronize()
        t_upd = time.perf_counter() - t0
        if slots is None:
            vec_np[prev:prev + len(new_vecs)] = new_vecs
            new_ids = np.arange(prev, prev + len(new_vecs))
        else:
            vec_np[slots] = new_vecs
            new_ids = slots
        n_now = h.graph.n
        ust = h.last_update_stats
        hc = inc.host_chal
        t_ins = sum(ust["seconds"].values())
        t_inc = sum(inc.last_stats["seconds"].values())
        lvl_pad = srv.graph.level.cpu().numpy()
        t0 = time.perf_counter()
        chunks, finished = [], False
        while not finished:
            blob, finished = writer.next_chunk()
            chunks.append(blob)
        t_patch = time.perf_counter() - t0
        t0 = time.perf_counter()
        for blob in chunks:
            client, client_vecs = patchlib.apply_patch(client, blob,
                                                       client_vecs)
        t_apply = time.perf_counter() - t0
        row = {"round": label, "n": n_now,
               "insert_s": round(t_ins, 3),
               "insert_split_s": {k: round(v, 3)
                                  for k, v in ust["seconds"].items()},
               "insert_device_s": {k: round(v, 3)
                                   for k, v in ust["phase_s"].items()},
               "touched": ust["touched"],
               "overflow": ust.get("overflow"),
               "inc_update_s": round(t_inc, 3),
               "inc_split_s": {k: round(v, 3) for k, v in
                               inc.last_stats["seconds"].items()
                               if v >= 0.01},
               "inc_sizes": inc.last_stats["sizes"],
               "repair_updates": inc.repair_updates,
               "repair_bridges": len(inc.repair_keys),
               "changed_old": len(writer.old),
               "update_index_s": round(t_upd, 3),
               "layouts_and_writer_s": round(t_upd - t_ins - t_inc, 3),
               "patch_s": round(t_patch, 3), "patch_chunks": len(chunks),
               "patch_bytes": sum(len(c_) for c_ in chunks),
               "records": len(writer.old) + len(writer.new),
               "client_apply_s": round(t_apply, 3),
               "update_s": round(t_upd + t_patch, 3)}
        if ust.get("overflow"):
            check(ust["overflow"]["truncated_applies"] == 0,
                  f"{label}: reverse-connect truncated: {ust['overflow']}")
        check(client.n == n_now and same_graph(
            patchlib.to_np(client), client.n, hc, n_now),
            f"{label}: the patched client differs from the server's graph")
        check(np.array_equal(client_vecs, vec_np[:n_now]),
              f"{label}: the patched client's vectors differ")
        fresh = HnswSlimIndex(metric=hcfg.metric, device=dev)
        fresh.graph, fresh.host_chal = srv.graph, hc
        fresh.densify_level0()
        fresh.densify_upper()
        ok_up = True
        for l in range(1, srv.graph.max_level + 1):
            at = torch.as_tensor(np.nonzero(lvl_pad >= l)[0], device=dev)
            ok_up &= bool(torch.equal(
                srv.dense_up[l - 1][srv.rank_up[at].long()],
                fresh.dense_up[l - 1][fresh.rank_up[at].long()]))
        check(bool(torch.equal(srv.dense0, fresh.dense0)) and ok_up,
              f"{label}: the refreshed dense layouts differ from a fresh "
              "densify")
        del fresh
        row["integrity"] = {"hnsw": h.check_integrity(),
                            "slim": srv.check_integrity()}
        t0 = time.perf_counter()
        _, gt_new = bf.exact_topk(h.vectors, h.vn, qall, k=10,
                                  metric=hcfg.metric, n_valid=n_now)
        gt_new = gt_new.cpu().numpy()
        row["gt_s"] = round(time.perf_counter() - t0, 3)
        srv.scfg = scfg_slim(64)
        line = serve_line(srv, queries, gt_new, f"updates {label} slim ef=64")
        check(((line["ids"] >= 0) & (line["ids"] < n_now)).all(),
              f"{label}: id range")
        row["recall@10"], row["qps"] = line["recall@10"], line["qps"]
        _, hit = srv.search(new_vecs, k=1)
        row["self_hit@1"] = round(float((hit[:, 0] == new_ids).mean()), 4)
        say(f"updates {label}: {json.dumps(row)}")
        check(row["recall@10"] >= pre_recall - 0.01,
              f"{label}: recall@10 {row['recall@10']} fell more than 0.01 "
              f"under the pre-update {pre_recall}")
        check(row["self_hit@1"] >= 0.9,
              f"{label}: self-hit@1 of the inserted vectors "
              f"{row['self_hit@1']} < 0.9")
        upd_rounds.append(row)

    def check_equals_full(when: str) -> float:
        """The contract, at full size: the incremental graph equals
        convert_to_slim of the updated vanilla graph on every row. Returns
        the full conversion's seconds."""
        t0 = time.perf_counter()
        g_fresh = prune.convert_to_slim(h.graph, h.vectors, h.vn, slim_cfg,
                                        metric=hcfg.metric)
        dt = time.perf_counter() - t0
        check(same_graph(patchlib.to_np(g_fresh), g_fresh.n, inc.host_chal,
                         h.graph.n),
              f"{when} the incremental graph differs from convert_to_slim "
              "of the updated vanilla graph")
        say(f"updates: {when} the incremental graph equals convert_to_slim "
            f"of the updated vanilla graph exactly (full conversion "
            f"{dt:.2f} s)")
        return dt

    u_rec = UpdateRecorder()
    with u_rec.installed():
        for b_ in range(3):
            update_round(f"add batch {b_ + 1}",
                         extra[b_ * UPD_BATCH:(b_ + 1) * UPD_BATCH])
    check_equals_full("after three add batches, nothing repaired,")
    # deletes and slot reuse
    n_now = h.graph.n
    dead = np.sort(np.random.default_rng(23).choice(n_now, UPD_BATCH,
                                                    replace=False))
    check(server.mark_delete(dead) == UPD_BATCH, "mark_delete count")
    srv.scfg = scfg_slim(64)
    _, del_ids = server.search(queries, 10)
    check((del_ids >= 0).all() and not np.isin(del_ids, dead).any(),
          "a deleted id was served, or a filtered row is not full")
    say(f"updates: {UPD_BATCH} labels marked deleted (SlimServer."
        "mark_delete), served through filter_mask: no deleted label "
        "returned, every row full")
    update_round("delete + replace batch", extra[3 * UPD_BATCH:4 * UPD_BATCH],
                 slots=dead.astype(np.int64))
    t_fresh = check_equals_full(
        "after the delete + replace batch, its update run with "
        "repair_updates=True,")

    # IncrementalSlimZero: full, one 1000-vector update, the invariants
    t0 = time.perf_counter()
    zinc = IncrementalSlimZero(zcfg, metric=hcfg.metric)
    zinc.full(h.host_adj(), h.levels, int(h.graph.entry), h.vectors, h.vn)
    torch.cuda.synchronize()
    t_zfull = time.perf_counter() - t0
    t0 = time.perf_counter()
    z_touched = h.add_points(extra[4 * UPD_BATCH:])
    torch.cuda.synchronize()
    t_zadd = time.perf_counter() - t0
    t0 = time.perf_counter()
    zg, z_changed = zinc.update(h.host_adj(), h.levels, int(h.graph.entry),
                                h.vectors, h.vn, touched=z_touched)
    torch.cuda.synchronize()
    t_zupd = time.perf_counter() - t0
    n_now = h.graph.n
    zsrv = HnswSlimZeroIndex(metric=hcfg.metric, search_cfg=scfg_slim(64),
                             device=dev)
    zsrv.graph, zsrv.vectors, zsrv.vn = zg, h.vectors, h.vn
    zsrv.host_chal = zinc.host_chal
    zsrv.densify_level0()
    integ_zu = zsrv.check_integrity()  # cap and hierarchy rule
    z_rows0 = zinc.final[0][:n_now]
    z_indeg = np.bincount(z_rows0[z_rows0 >= 0], minlength=n_now)
    donor = prune.level_indegrees(h.host_adj(), h.levels)[0][:n_now]
    z_floor = float((z_indeg >= np.minimum(donor, zcfg.min_indegree0)).mean())
    _, gt_z = bf.exact_topk(h.vectors, h.vn, qall, k=10, metric=hcfg.metric,
                            n_valid=n_now)
    z_line = serve_line(zsrv, queries, gt_z.cpu().numpy(),
                        "updates slimzero ef=64")
    z_pre = slim_zero[EFS.index(64)]["recall@10"]
    z_row = {"full_s": round(t_zfull, 3), "add_points_s": round(t_zadd, 3),
             "update_s": round(t_zupd, 3), "sizes": zinc.last_stats["sizes"],
             "changed": len(z_changed), "integrity": integ_zu,
             "floor_share": z_floor, "recall@10": z_line["recall@10"],
             "pre_update_recall@10": z_pre}
    say(f"updates slimzero: {json.dumps(z_row)}")
    check(z_floor >= 0.999, f"SlimZero's in-degree floor is broken after the "
                            f"update: {z_floor}")
    check(z_line["recall@10"] >= z_pre - 0.02,
          f"SlimZero recall@10 after the update {z_line['recall@10']} fell "
          f"more than 0.02 under {z_pre}")
    launch_upd = dict(cuda.launches)
    keep_shapes()
    say(f"update-path launches: {launch_upd}")
    for name in UPDATE_PATH:
        check(launch_upd[name] > 0, f"{name} never launched on the update "
                                    "path")
    check(u_rec.sort_in is not None and u_rec.apply_in is not None,
          "no update batch's sort or collect-mode apply was recorded")
    upd_summary = {"full_s": round(t_full, 2), "rounds": upd_rounds,
                   "reconvert_s": round(t_fresh, 2), "slimzero": z_row,
                   "phase_s": round(time.perf_counter() - t_phase, 1)}

    # Kθ on the level-0 adjacency of the updated index (capacity-padded)
    a0 = h.graph.adjs[0]
    kdeg = hnsw_mod._row_deg(a0)
    pdeg = hnsw_mod.row_deg_plain(a0)
    deg_ms = cuda_ms(lambda: hnsw_mod._row_deg(a0), 10)
    deg_pms = cuda_ms(lambda: hnsw_mod.row_deg_plain(a0), 10)
    report["row_deg"] = dict(
        agree=float((kdeg == pdeg).float().mean()),
        max_abs_err=float((kdeg - pdeg).abs().max()), ms=deg_ms,
        plain_ms=deg_pms, library_ms=deg_pms,
        bound=bound(a0.numel() * 4 + a0.shape[0] * 4, a0.numel()),
        shapes=f"i32[{a0.shape[0]}, {a0.shape[1]}] -> i32[{a0.shape[0]}]; "
               "the plain version (a >= 0).sum(1) is also the library call")
    check(bool(torch.equal(kdeg, pdeg)),
          f"row_deg differs from its plain version: {report['row_deg']}")

    # Kι (Kκ's ids map) on a build batch's reverse-edge list (the recorded
    # 4096-insert batch's forward selection) and on an update batch's
    def sort_pair(what, keys, payload, n_ids):
        bits_ = max(1, n_ids.bit_length())
        ku, kp = revconn.kv_sort(keys, payload, n_ids)
        pu, pp = revconn.kv_sort_plain(keys, payload)
        k_only, _ = revconn.kv_sort(keys, None, n_ids)
        e_ = len(keys)
        part = dict(
            what=what, E=e_, n=n_ids, key_bits=bits_,
            equal=bool(torch.equal(ku, pu) and torch.equal(kp, pp)
                       and torch.equal(k_only, pu)),
            ms=cuda_ms(lambda: revconn.kv_sort(keys, payload, n_ids), 20),
            plain_ms=cuda_ms(lambda: revconn.kv_sort_plain(keys, payload),
                             20),
            key_only_ms=cuda_ms(lambda: revconn.kv_sort(keys, None, n_ids),
                                20),
            key_only_library_ms=cuda_ms(
                lambda: torch.sort(keys, stable=True), 20),
            bound=bound(2 * e_ * 8, 0), sweep_bound_ms=sweep_bound(e_, bits_),
            key_only_sweep_bound_ms=sweep_bound(e_, bits_, payload=False),
            device_launches=1 + -(-bits_ // 8))
        say(f"kernel radix_sort.ids part: {json.dumps(part)}")
        check(part["equal"], f"kv_sort differs from torch.sort(stable=True) "
                             f"on {what}")
        return part

    u_b = torch.where(sel >= 0, sel, revconn.BIG).reshape(-1).contiguous()
    p_b = a_ids[:, None].expand(*sel.shape).reshape(-1).contiguous()
    s_build = sort_pair("the recorded build batch's reverse-edge list", u_b,
                        p_b, n_rows)
    s_upd = sort_pair("an update batch's reverse-edge list", *u_rec.sort_in)
    report["radix_sort.ids"] = dict(
        agree=1.0, max_abs_err=0.0, ms=s_build["ms"],
        plain_ms=s_build["plain_ms"], library_ms=s_build["plain_ms"],
        bound=s_build["bound"], parts=[s_build, s_upd],
        counted_launches=report["radix_sort"]["ids_launches"],
        shapes=f"Kι: E {s_build['E']} (a 4096-insert build batch, ids "
               f"below {s_build['n']} with 2^30 padding, "
               f"{s_build['key_bits']}-bit keys): keys and payload equal to "
               f"torch.sort(stable=True) + gather, which is the plain "
               f"version and the library call; one-sweep traffic "
               f"{s_build['sweep_bound_ms']:.4f} ms; key-only "
               f"{s_build['key_only_ms']:.4f} ms vs torch.sort "
               f"{s_build['key_only_library_ms']:.4f} ms; an update batch's "
               f"list, E {s_upd['E']}: {s_upd['ms']:.4f} ms vs "
               f"{s_upd['plain_ms']:.4f} ms, key-only "
               f"{s_upd['key_only_ms']:.4f} ms vs "
               f"{s_upd['key_only_library_ms']:.4f} ms")

    # Kζ and Kγ in collect mode: the recorded level-0 apply of an update
    # batch (of_t 16384, new_w 32) through the kernels and through every
    # plain version, on copies of its pre-apply state
    c_adj, c_deg, c_a, c_cand, c_kw = u_rec.apply_in
    ak, dk = c_adj.clone(), c_deg.clone()
    ux, uxn = h.vectors, h.vn  # the grown table the update index holds
    ek, tk = revconn.apply_insert(ak, dk, ux, uxn, c_a, c_cand, **c_kw)
    kernel_fns = {k_: getattr(revconn, k_) for k_ in (
        "rng_prune", "kv_sort", "append_overflow", "write_rows")}
    plain_fns = dict(
        rng_prune=lambda *a_, m_max=None, **k_: heuristic.rng_prune_plain(
            *a_, **k_),
        kv_sort=revconn.kv_sort_plain,
        append_overflow=revconn.append_overflow_plain,
        write_rows=revconn.write_rows_plain)
    ap_, dp_ = c_adj.clone(), c_deg.clone()
    for k_, v_ in plain_fns.items():
        setattr(revconn, k_, v_)
    try:
        ep, tp = revconn.apply_insert(ap_, dp_, ux, uxn, c_a, c_cand,
                                      **c_kw)
    finally:
        for k_, v_ in kernel_fns.items():
            setattr(revconn, k_, v_)

    def collect_ms(reps: int = 2) -> float:
        """One whole collect-mode apply on a fresh copy of the recorded
        state each time (CUDA events around the call alone)."""
        tot = 0.0
        for rep in range(reps + 1):
            a_, d_ = c_adj.clone(), c_deg.clone()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            revconn.apply_insert(a_, d_, ux, uxn, c_a, c_cand, **c_kw)
            ev[1].record()
            torch.cuda.synchronize()
            if rep:  # the first pass warms up
                tot += ev[0].elapsed_time(ev[1])
        return tot / reps

    # agreement over the rows either apply wrote (the inserts' and their
    # targets'); a near-tie in a prune may keep another id, as in Kγ's pairs
    wrote = ((ak != c_adj) | (ap_ != c_adj)).any(dim=1)
    same_row = (ak == ap_).all(dim=1)
    rows_eq = float(same_row[wrote].float().mean())
    c_rep = dict(
        rows_written=int(wrote.sum()), rows_equal=rows_eq,
        degrees_equal=bool(torch.equal(dk[same_row], dp_[same_row])),
        counters=[int(ek), int(tk)], plain_counters=[int(ep), int(tp)],
        inserts=len(c_a), of_t=c_kw["of_t"], new_w=c_kw["new_w"],
        C=ak.shape[1] + c_kw["new_w"], apply_ms=collect_ms())
    say(f"kernel rev_connect + rng_prune, collect mode: {json.dumps(c_rep)}")
    check(rows_eq >= 0.99 and c_rep["degrees_equal"]
          and c_rep["counters"] == c_rep["plain_counters"]
          and int(tk) <= c_kw["of_t"],
          f"the collect-mode apply differs from its plain versions: {c_rep}")
    report["rev_connect"]["shapes"] += (
        f"; collect mode (of_t {c_kw['of_t']}, new_w {c_kw['new_w']}): one "
        f"update batch's level-0 apply, {int(ek)} overflow edges into "
        f"{int(tk)} targets, rows equal {rows_eq:.6f}, {c_rep['apply_ms']:.3f}"
        " ms for the whole apply")

    # ---- 9. union and sharded serving, the bfloat16 store ----------------
    shard_summary, launch_par = shard_phase(base, queries, gt, slim_ins,
                                            report, dev)

    # ---- 11. the strategy CLI, its tools, the reference-graph import -------
    cli_summary, launch_cli = cli_phase(
        base, queries, gt, h, idx,
        {"vanilla": vanilla[EFS.index(128)],
         "slim seed_width=0": qs_rows["greedy ef=128"],
         "slimzero seeded": slim_zero[EFS.index(128)]},
        report, dev)

    for name, rep in report.items():
        say(f"kernel {name}: {json.dumps(rep)}")

    # ---- 10. summary -------------------------------------------------------
    paths = (launch_ins, launch_qs, launch_sz, launch_sq, launch_nnd,
             launch_upd, launch_par, launch_cli)
    kernels = [{
        "name": name,
        "route": "cuda",
        "source": ROUTES[MODE_ROUTES[name][0] if name in MODE_ROUTES
                         else name][0],
        "replaces": MODE_ROUTES[name][1] if name in MODE_ROUTES
        else ROUTES[name][1],
        "launches": sum(p_[name] for p_ in paths),
        "max_abs_err": report[name]["max_abs_err"],
        "ms": round(report[name]["ms"], 4),
        "plain_ms": round(report[name]["plain_ms"], 4),
        "bound_ms": round(report[name]["bound"][0], 4),
        "bound_by": report[name]["bound"][1],
        # a PyTorch sort (+ gather), or one call, computes both radix
        # sorts', row_deg's, shard_merge's and point_dist's function; none
        # computes any of the others
        "library_ms": None if "library_ms" not in report[name]
        else round(report[name]["library_ms"], 4),
    } for name in list(ROUTES) + list(MODE_ROUTES)]
    for kern in kernels:
        check(kern["launches"] > 0, f"{kern['name']} was never launched on "
                                    "a main path")
    classes = launch_classes(MAIN_SHAPES)
    say(f"kernel launch classes: {json.dumps(classes)}")
    for kern in ("beam_search", "rng_prune", "topk_dist", "greedy_descent"):
        total = sum(p_[kern] for p_ in paths)
        by_class = sum(v for k_, v in classes.items()
                       if k_.startswith(kern + " "))
        check(by_class == total, f"{kern}: {by_class} launches by shape "
                                 f"class, {total} in all")

    def lines(rows: dict) -> dict:
        return {k_: {a: b_ for a, b_ in r_.items() if a not in ("d", "ids")}
                for k_, r_ in rows.items()}
    say(json.dumps({
        "insert": {"n": n, "build_s": round(t_build, 2),
                   "build_split_s": {k: round(v, 3) for k, v in ph.items()},
                   "overflow": ov, "convert_s": round(t_conv, 2),
                   "index_size": idx.index_size(), "vanilla": vanilla,
                   "slim": slim_ins, "launches": launch_ins},
        "query_surface": {"lines": lines(qs_rows), "autotune": tune,
                          "launches": launch_qs},
        "slimzero": {"convert_s": round(t_zconv, 2),
                     "index_size": z.index_size(),
                     "floor_share": floor_share, "slim": slim_zero,
                     "launches": launch_sz},
        "slimq": {"build_s": round(t_qbuild, 2),
                  "build_split_s": {k: round(v, 3)
                                    for k, v in sq.build_stats.items()},
                  "sizes": sq_size, "lines": sq_rows,
                  "launches": launch_sq},
        "server": dict(srv_summary, launches=launch_nnd),
        "updates": dict(upd_summary, launches=launch_upd),
        "shards": dict(shard_summary, launches=launch_par),
        "cli": dict(cli_summary, launches=launch_cli),
        "launch_classes": classes,
        "nq": NQ, "wall_s": round(time.perf_counter() - t_start, 1)}))
    say(card)
    say(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: CHECK FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
