"""The comparisons that decide ``correct``, against the plain reference.

``dist_err`` (search answers): every answered row must hold k distinct ids
of stored rows in ascending distance; each answered distance is compared
with the reference's distance of that query to that id, computed from the
differences in float32, and the gap is taken relative to ||q||^2 + ||x||^2,
the size of the terms a norm-expanded float32 distance rounds. The number
is the largest gap over all rows checked, and inf where a row is malformed.

``recall_miss`` (search answers): the share of the exact top-k (the plain
reference's) that the answers leave out, over every row checked. It holds the search to its neighbours where
``dist_err`` holds it only to the distances of the ids it returned.

``last_batch_miss`` (a client's copy after updates): the share of the last
acknowledged batch's vectors that a search of the copy does not return as
their own nearest neighbour: a vector stored but never linked into the
graph is never found.

``copy_err`` (a client's copy after updates): the largest relative gap
between the copy's vector rows and the reference store's, inf where the row
count differs or the copy's graph is not the server's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference.exact_knn import pair_dist, to_device

INF = float("inf")


def score_answers(base: torch.Tensor, queries: torch.Tensor, q_rows,
                  ids, dists, gt_ids: torch.Tensor | None = None,
                  block: int = 1 << 18) -> dict:
    """Check answered rows: ``ids``/``dists`` [M, k] (host arrays) answer
    ``queries[q_rows]`` over ``base`` (device tensors). ``gt_ids`` [P, k]:
    the exact top-k of every query row, for recall. Returns dist_err,
    recall (or None), rows, malformed."""
    ids = np.asarray(ids)
    dists = np.asarray(dists, np.float32)
    q_rows = np.asarray(q_rows, np.int64)
    m, k = ids.shape if ids.ndim == 2 else (0, 0)
    n = base.shape[0]
    xn = (base * base).sum(1)
    err, bad, hits = 0.0, 0, 0
    for r0 in range(0, m, block):
        i = to_device(ids[r0:r0 + block], base.device).long()
        d = to_device(dists[r0:r0 + block], base.device)
        rows = to_device(q_rows[r0:r0 + block], base.device)
        q = queries[rows]
        in_range = ((i >= 0) & (i < n)).all(1)
        srt = torch.sort(i, dim=1).values
        distinct = (srt[:, 1:] != srt[:, :-1]).all(1)
        ordered = (d[:, 1:] >= d[:, :-1]).all(1) & torch.isfinite(d).all(1)
        good = in_range & distinct & ordered
        bad += int((~good).sum())
        ref = pair_dist(base, q, i)
        scale = (q * q).sum(1, keepdim=True) + xn[i.clamp(0, n - 1)]
        gap = ((d - ref).abs() / scale)[good]
        if gap.numel():
            err = max(err, float(gap.max()))
        if gt_ids is not None:
            g = gt_ids[rows]
            hits += int((i[:, :, None] == g[:, None, :]).any(-1).sum())
    if bad or math.isnan(err):
        err = INF
    recall = hits / (m * k) if gt_ids is not None and m else None
    return {"dist_err": err, "recall": recall, "rows": int(m),
            "malformed": int(bad)}


def recall_miss(recall: float | None) -> float:
    """1 - recall; inf where nothing was answered."""
    return INF if recall is None else 1.0 - recall


def copy_err(copy_vectors: np.ndarray, ref_vectors: np.ndarray,
             graph_equal: bool) -> float:
    """Largest |copy - reference| over the largest |reference| of the rows;
    inf where the counts differ or the graphs do."""
    if not graph_equal or copy_vectors.shape != ref_vectors.shape:
        return INF
    scale = float(np.abs(ref_vectors).max()) or 1.0
    return float(np.abs(copy_vectors.astype(np.float64)
                        - ref_vectors.astype(np.float64)).max()) / scale


def same_graph(a: dict, n_a: int, b: dict, n_b: int) -> bool:
    """Two flat CHAL host mirrors ({nbr, lvl_off, level}) hold the same
    logical graph (rows are packed in canonical order, so the arrays
    compare)."""
    if n_a != n_b:
        return False
    ea = int(a["lvl_off"][n_a - 1, -1])
    eb = int(b["lvl_off"][n_b - 1, -1])
    return (ea == eb
            and np.array_equal(a["level"][:n_a], b["level"][:n_b])
            and np.array_equal(a["lvl_off"][:n_a], b["lvl_off"][:n_b])
            and np.array_equal(a["nbr"][:ea], b["nbr"][:eb]))


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}): every number at or under its
    limit, and finite."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = numbers[name]
        out[name] = {"value": v if math.isfinite(v) else str(v),
                     "limit": limit}
        ok = ok and math.isfinite(v) and v <= limit
    return ok, out
