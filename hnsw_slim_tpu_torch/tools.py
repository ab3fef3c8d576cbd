"""Small CLI tools: dataset slicer and standalone recall scorer.

Ports of prep_data.cc:104-135 (slice the first N vectors of a dataset into a
new fvecs) and recall_knn.cc:10-77 (recall@k of an external knn ivecs file
against ground truth, with exact re-rank).
"""

from __future__ import annotations

import argparse

from .eval.recall import recall_at_k
from .utils.io import read_fvecs, read_ivecs, write_fvecs


def prep_data(argv=None):
    p = argparse.ArgumentParser("prep_data: slice a dataset")
    p.add_argument("--src", required=True, help="source fvecs")
    p.add_argument("--dst", required=True, help="output fvecs")
    p.add_argument("--num", type=int, required=True, help="vectors to keep")
    a = p.parse_args(argv)
    data = read_fvecs(a.src, max_num=a.num)
    write_fvecs(a.dst, data)
    print(f"wrote {len(data)} x {data.shape[1]} -> {a.dst}")


def recall_knn(argv=None):
    p = argparse.ArgumentParser("recall_knn: score a knn result file")
    p.add_argument("--base", required=True, help="base fvecs")
    p.add_argument("--query", required=True, help="query fvecs")
    p.add_argument("--gt", required=True, help="groundtruth ivecs")
    p.add_argument("--knn", required=True, help="result ivecs to score")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--metric", default="l2", choices=["l2", "ip"])
    a = p.parse_args(argv)
    base = read_fvecs(a.base)
    queries = read_fvecs(a.query)
    gt = read_ivecs(a.gt)
    knn = read_ivecs(a.knn)
    r = recall_at_k(knn, gt, queries, base, a.k, metric=a.metric)
    print(f"Recall@{a.k}: {r:.6f}")
    return r


if __name__ == "__main__":
    import sys

    cmd = sys.argv[1] if len(sys.argv) > 1 else ""
    if cmd == "prep_data":
        prep_data(sys.argv[2:])
    elif cmd == "recall_knn":
        recall_knn(sys.argv[2:])
    else:
        print("usage: python -m hnsw_slim_tpu.tools {prep_data|recall_knn} ...")
