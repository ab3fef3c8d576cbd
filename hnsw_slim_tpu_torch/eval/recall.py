"""Recall@k scoring with ground-truth re-ranking.

Port of SolveStrategy::recall (reference include/strategy/solve_strategy.h:67-103)
and recall_knn.cc:38-74: the saved ground-truth lists hold 100 exact neighbors;
the true top-k is re-derived by exact distance between the query and the GT
candidates, then set-intersected with the returned labels.
"""

from __future__ import annotations

import numpy as np


def recall_at_k(
    results: np.ndarray,
    gt: np.ndarray,
    queries: np.ndarray,
    base: np.ndarray,
    k: int,
    metric: str = "l2",
) -> float:
    """results i32[Q, >=k], gt i32[Q, G], queries f32[Q, d], base f32[N, d]."""
    q = queries.astype(np.float32)
    cand = base[gt]  # [Q, G, d]
    if metric == "ip":
        d = 1.0 - np.einsum("qd,qgd->qg", q, cand.astype(np.float32))
    else:
        diff = cand.astype(np.float32) - q[:, None, :]
        d = np.einsum("qgd,qgd->qg", diff, diff)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    true_topk = np.take_along_axis(gt, order, axis=1)
    hits = 0
    for r, t in zip(results[:, :k], true_topk):
        hits += len(set(r.tolist()) & set(t.tolist()))
    return hits / (k * len(gt))
