"""Parity of the PyTorch + CUDA port with the JAX package at 100k x 128.

The data is bench.py's no-harness set at a tenth of its size
(clustered(100_000, 128, n_queries=1024, n_clusters=100, seed=7,
scale=0.3)); the graph is built with M=30, ef_construction=128 by
NN-descent (``--strategy nnd``, the default) or by insertion rounds
(``--strategy insert``), then converted with SlimConfig.from_ratios();
serving is seeded (seed_width 32, pop_width 8) at ef 32..320. The card's
machine has no JAX, so the run has two steps that meet in one directory:

    # on a host with JAX; the reference runs on its CPU (about 6 minutes
    # for nnd)
    python scripts/torch_parity_100k.py jax DIR [--strategy insert]
    # on the card (the port only; no JAX)
    python scripts/torch_parity_100k.py port DIR [--strategy insert]

``jax`` builds and converts with the JAX package, saves the Slim graph
(DIR/jax_slim.npz), and saves its exact ground truth and its search results
per ef (DIR/jax_search.npz). ``port`` loads that graph through the port's
load_slim, searches it on the card at the same settings and prints, per ef,
recall@10 of both engines, the share of (query, rank) slots whose ids are
equal, and both engines' hops and distance-computation sums. It then
builds the port's own graph from the same data and prints its recall, so
the two builds can be compared too.

With ``--strategy insert`` the ``jax`` step also saves the vanilla graph
(DIR/insert_jax_hnsw.npz) and its vanilla HNSW search (pop_width 4) per ef,
and the ``port`` step also searches that graph with the port's
HnswIndex.search, and prints the share of level-0 rows whose edge sets
equal the JAX build's and both engines' vanilla recall on their own graphs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
EFS = (32, 64, 128, 256, 320)


def _data(clustered):
    """(base, queries); each step passes its own package's clustered (the
    two are byte-equal copies)."""
    return clustered(100_000, 128, n_queries=1024, n_clusters=100, seed=7,
                     scale=0.3)


def _recall(ids, gt) -> float:
    return float(np.mean([len(set(a[:10].tolist()) & set(b[:10].tolist()))
                          / 10 for a, b in zip(ids, gt)]))


def _vanilla_cfg(SearchConfig, ef):
    return SearchConfig(ef=ef, pop_width=4)


def jax_step(out: Path, strategy: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from hnsw_slim_tpu.config import HnswConfig, SearchConfig, SlimConfig
    from hnsw_slim_tpu.index.bruteforce import BruteForceIndex
    from hnsw_slim_tpu.index.hnsw import HnswIndex
    from hnsw_slim_tpu.index.slim import HnswSlimIndex
    from hnsw_slim_tpu.persist.checkpoint import save_hnsw, save_slim
    from hnsw_slim_tpu.utils.data import clustered

    tag = "insert_" if strategy == "insert" else ""
    base, q = _data(clustered)
    _, gt = BruteForceIndex(base).search(q, 10)
    t0 = time.perf_counter()
    h = HnswIndex(HnswConfig(M=30, ef_construction=128), strategy=strategy)
    h.build(base)
    print(f"jax {strategy} build {time.perf_counter() - t0:.1f} s",
          flush=True)
    res = {"gt": gt}
    if strategy == "insert":
        save_hnsw(str(out / "insert_jax_hnsw.npz"), h)
        for ef in EFS:
            h.scfg = _vanilla_cfg(SearchConfig, ef)
            _, ids = h.search(q, 10)
            res[f"vids{ef}"] = ids
            res[f"vstats{ef}"] = np.array([
                h.last_stats["hops"], h.last_stats["distance_computations"]])
            print(f"jax vanilla ef={ef}: recall@10 {_recall(ids, gt):.4f}",
                  flush=True)
    t0 = time.perf_counter()
    idx = HnswSlimIndex.from_hnsw(h, SlimConfig.from_ratios())
    print(f"jax conversion {time.perf_counter() - t0:.1f} s, "
          f"index_size {idx.index_size()}", flush=True)
    save_slim(str(out / f"{tag}jax_slim.npz"), idx)
    for ef in EFS:
        idx.scfg = SearchConfig(ef=ef, pop_width=8, seed_width=32)
        _, ids = idx.search(q, 10)
        res[f"ids{ef}"] = ids
        res[f"stats{ef}"] = np.array([idx.last_stats["hops"],
                                      idx.last_stats["distance_computations"]])
        print(f"jax ef={ef}: recall@10 {_recall(ids, gt):.4f}", flush=True)
    np.savez(out / f"{tag}jax_search.npz", **res)


def port_step(out: Path, strategy: str) -> None:
    import torch

    from hnsw_slim_tpu_torch.config import HnswConfig, SearchConfig, SlimConfig
    from hnsw_slim_tpu_torch.index.hnsw import HnswIndex
    from hnsw_slim_tpu_torch.index.slim import HnswSlimIndex
    from hnsw_slim_tpu_torch.persist.checkpoint import load_hnsw, load_slim
    from hnsw_slim_tpu_torch.utils.data import clustered

    if not torch.cuda.is_available():
        sys.exit("torch_parity_100k: the port step needs a CUDA card")
    tag = "insert_" if strategy == "insert" else ""
    base, q = _data(clustered)
    ref = np.load(out / f"{tag}jax_search.npz")
    gt = ref["gt"]
    on_jax = load_slim(str(out / f"{tag}jax_slim.npz"), device="cuda")
    on_jax.densify_level0()
    t0 = time.perf_counter()
    h = HnswIndex(HnswConfig(M=30, ef_construction=128), strategy=strategy,
                  device="cuda")
    h.build(base)
    torch.cuda.synchronize()
    print(f"port {strategy} build {time.perf_counter() - t0:.1f} s",
          flush=True)
    if strategy == "insert":
        jh = load_hnsw(str(out / "insert_jax_hnsw.npz"), device="cuda")
        ja, pa = jh.host_adj()[0], h.host_adj()[0]
        same = np.mean([set(a[a >= 0].tolist()) == set(b[b >= 0].tolist())
                        for a, b in zip(ja, pa)])
        print(f"level-0 rows with equal edge sets: {same:.4f}", flush=True)
        for ef in EFS:
            jh.scfg = h.scfg = _vanilla_cfg(SearchConfig, ef)
            _, ids = jh.search(q, 10)
            _, own_ids = h.search(q, 10)
            j_ids, (j_hops, j_dcomp) = ref[f"vids{ef}"], ref[f"vstats{ef}"]
            print("vanilla " + json.dumps({
                "ef": ef, "recall_jax": round(_recall(j_ids, gt), 4),
                "recall_port_on_jax_graph": round(_recall(ids, gt), 4),
                "slots_equal": round(float((ids == j_ids).mean()), 4),
                "hops_jax": int(j_hops), "hops_port": jh.last_stats["hops"],
                "dcomp_jax": int(j_dcomp),
                "dcomp_port": jh.last_stats["distance_computations"],
                "recall_port_own_graph": round(_recall(own_ids, gt), 4)}),
                flush=True)
    t0 = time.perf_counter()
    own = HnswSlimIndex.from_hnsw(h, SlimConfig.from_ratios())
    own.densify_level0()
    torch.cuda.synchronize()
    print(f"port conversion {time.perf_counter() - t0:.1f} s, "
          f"index_size {own.index_size()}", flush=True)
    for ef in EFS:
        on_jax.scfg = own.scfg = SearchConfig(ef=ef, pop_width=8,
                                              seed_width=32)
        _, ids = on_jax.search(q, 10)
        _, own_ids = own.search(q, 10)
        j_ids, (j_hops, j_dcomp) = ref[f"ids{ef}"], ref[f"stats{ef}"]
        print("parity " + json.dumps({
            "ef": ef, "recall_jax": round(_recall(j_ids, gt), 4),
            "recall_port_on_jax_graph": round(_recall(ids, gt), 4),
            "slots_equal": round(float((ids == j_ids).mean()), 4),
            "hops_jax": int(j_hops), "hops_port": on_jax.last_stats["hops"],
            "dcomp_jax": int(j_dcomp),
            "dcomp_port": on_jax.last_stats["distance_computations"],
            "recall_port_own_graph": round(_recall(own_ids, gt), 4)}),
            flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("step", choices=("jax", "port"))
    ap.add_argument("dir", type=Path)
    ap.add_argument("--strategy", choices=("nnd", "insert"), default="nnd")
    a = ap.parse_args()
    a.dir.mkdir(parents=True, exist_ok=True)
    (jax_step if a.step == "jax" else port_step)(a.dir, a.strategy)
