#!/usr/bin/env python3
"""The 1M insertion build with the hand-written sort (Kι: the ids map of
Kκ, csrc/radix_sort.cu) against the same build with torch.sort(stable=True)
in its place, in one process on one card, in turns (kernel, library,
library, kernel) after one warm-up build.

    python3 scripts/insert_build_sort_ab.py [--n 1000000]

Prints the card, then per build its seconds, the build's phase split and
the launches of the sort's ids mode, then one JSON line with both means.
The two graphs must be equal: the sort's result is the same either way.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("insert_build_sort_ab: no CUDA device", file=sys.stderr)
        return 2
    from hnsw_slim_tpu_torch.config import HnswConfig
    from hnsw_slim_tpu_torch.graph import revconn
    from hnsw_slim_tpu_torch.index.hnsw import HnswIndex
    from hnsw_slim_tpu_torch.ops import cuda
    from hnsw_slim_tpu_torch.utils.data import clustered

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    cuda.lib()
    base, _ = clustered(args.n, 128, n_queries=0,
                        n_clusters=max(64, args.n // 1000), seed=7, scale=0.3)
    cfg = HnswConfig(M=30, ef_construction=128)
    kernel_sort = revconn.kv_sort

    def build(which: str):
        revconn.kv_sort = kernel_sort if which == "kernel" \
            else revconn.kv_sort_plain
        cuda.reset_launches()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h = HnswIndex(cfg, strategy="insert", device="cuda")
            h.build(base)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            revconn.kv_sort = kernel_sort
        print(json.dumps({
            "sort": which, "build_s": round(dt, 3),
            "split_s": {k: round(v, 3)
                        for k, v in h.build_stats["phase_s"].items()},
            "radix_sort.ids_launches": cuda.launches["radix_sort.ids"]}),
              flush=True)
        return dt, h.graph.adjs[0]

    build("kernel")  # warm-up: allocator, kernels loaded
    runs = {"kernel": [], "library": []}
    graphs = {}
    for which in ("kernel", "library", "library", "kernel"):
        dt, adj0 = build(which)
        runs[which].append(dt)
        graphs[which] = adj0
    equal = bool(torch.equal(graphs["kernel"], graphs["library"]))
    print(json.dumps({
        "n": args.n,
        "kernel_sort_build_s": round(sum(runs["kernel"]) / 2, 3),
        "library_sort_build_s": round(sum(runs["library"]) / 2, 3),
        "level0_graphs_equal": equal}), flush=True)
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
