"""``closed_batch``'s loop over a label-filtered Slim index: the same load
and the same pool queries as the Slim cell, each query with its own label
predicate.

Labels, from the seed: each base row gets a label uniform over the
configuration's ``labels.count``, independent of the clusters, and each pool
query one too (the ACORN / NHQ SIFT1M setup). A label becomes a one-hot u32
word: the rows' tag words go to the index once in set-up
(``system.set_tags``), and every call carries the need words of its rows,
so a call of 4096 queries mixes every label.

End to end: ``qps`` and ``recall_at_10``, the latter against the plain
reference's exact top 10 among the rows each query's predicate allows.
Compared, over every answer of the window:

- ``dist_err``: as ``harness/check.py`` has it, over the ids answered;
- ``recall_miss``: the share of the filtered exact top-k that the answers
  leave out;
- ``filter_miss``: the share of the ids answered whose row fails its
  query's predicate (the configuration's guarantee: 0).

A row answers ids >= 0 first, then -1 at inf distance where its search found
fewer than k allowed rows (a recall miss, not a malformed row); a row that
is otherwise out of shape (an id out of range, a repeat, distances not
ascending, -1 before an id) makes ``dist_err`` inf.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from drivers import closed_batch
from drivers.closed_batch import _offset
from harness import check, stats

SYSTEM = "slim_label_index"
INF = float("inf")


def labels(run) -> tuple:
    """(tag words u32[n] of the base rows, need words u32[pool_n] of the
    pool queries), one-hot, drawn from the seed."""
    rng = np.random.default_rng([run.seed, 3])
    count = run.cfg["labels"]["count"]
    base = rng.integers(0, count, run.info["n"])
    pool = rng.integers(0, count, run.data.pool_n)
    one = np.uint32(1)
    return one << base.astype(np.uint32), one << pool.astype(np.uint32)


def _needs(run, start: int, count: int) -> np.ndarray:
    """The need words of pool rows start, start + 1, ... (wrapping)."""
    return run.rec["need2"][start % run.data.pool_n:][:count]


def setup(run) -> None:
    tags, need = labels(run)
    run.rec.update(tags=tags, need=need, need2=np.concatenate([need, need]))
    run.system.set_tags(tags)
    b = run.traffic["batch"]
    for j in range(run.traffic["warm_calls"]):
        run.system.search(run.data.queries(j * b, b), run.cfg["k"],
                          need=_needs(run, j * b, b))


def window(run) -> None:
    b, k = run.traffic["batch"], run.cfg["k"]
    search, span = run.system.search, run.tracer.span
    start = _offset(run)
    starts, out, ends = [], [], []
    t0 = time.monotonic()
    t_end = t0 + run.seconds
    while time.monotonic() < t_end:
        q = run.data.queries(start, b)
        need = _needs(run, start, b)
        with span("search_call"):
            out.append(search(q, k, need=need))
        ends.append(time.monotonic())
        starts.append(start)
        start = (start + b) % run.data.pool_n
    wall = time.monotonic() - t0
    run.rec.update(calls=len(out), window_s=wall, starts=starts, out=out,
                   ends=np.asarray(ends) - t0, attempted=len(out) * b,
                   failed=0)


def score(run, q_rows, ids, dists, block: int = 1 << 18) -> dict:
    """Answers to pool queries (``q_rows`` index the pool) against the
    plain reference: dist_err, recall, filter_miss, rows, malformed,
    short (rows with fewer than k ids)."""
    ref, dev, k = run.reference, run.device, run.cfg["k"]
    pool_n = run.data.pool_n
    base = ref.to_device(run.data.base, dev)
    pool = ref.to_device(run.data.pool[:pool_n], dev)
    tags = ref.words(run.rec["tags"]).to(dev)
    need = ref.words(run.rec["need"]).to(dev)
    _, gt = ref.filtered_topk(base, pool, tags, need, k)
    ids = np.asarray(ids)
    dists = np.asarray(dists, np.float32)
    q_rows = np.asarray(q_rows, np.int64) % pool_n
    m = len(ids)
    n = base.shape[0]
    xn = (base * base).sum(1)
    err, bad, hits, short, answered, missed, want = (0.0, 0, 0, 0, 0, 0,
                                                     0)
    for r0 in range(0, m, block):
        i = ref.to_device(ids[r0:r0 + block], dev).long()
        d = ref.to_device(dists[r0:r0 + block], dev)
        rows = ref.to_device(q_rows[r0:r0 + block], dev)
        q, nd = pool[rows], need[rows]
        ok = i >= 0
        pad = (i == -1) & torch.isinf(d) & (d > 0)
        prefix = (ok[:, 1:] <= ok[:, :-1]).all(1)
        in_range = (ok & (i < n)) | pad
        srt = torch.sort(torch.where(ok, i, -1 - torch.arange(
            i.shape[1], device=dev)), dim=1).values
        distinct = (srt[:, 1:] != srt[:, :-1]).all(1)
        dv = torch.where(ok, d, INF)
        ordered = (dv[:, 1:] >= dv[:, :-1]).all(1) & \
            (torch.isfinite(d) | ~ok).all(1)
        good = in_range.all(1) & prefix & distinct & ordered
        bad += int((~good).sum())
        short += int((~ok[:, -1]).sum())
        ref_d = ref.pair_dist(base, q, i.clamp(min=0))
        scale = (q * q).sum(1, keepdim=True) + xn[i.clamp(0, n - 1)]
        gap = ((d - ref_d).abs() / scale)[good[:, None] & ok]
        if gap.numel():
            err = max(err, float(gap.max()))
        g = gt[rows]
        want += int((g >= 0).sum())
        hits += int(((i[:, :, None] == g[:, None, :]) & ok[:, :, None]
                     & (g[:, None, :] >= 0)).any(-1).sum())
        answered += int(ok.sum())
        missed += ref.filter_misses(tags, nd, i.clamp(max=n - 1))
    if bad or math.isnan(err):
        err = INF
    out = {"dist_err": err, "recall": hits / want if want else None,
           "filter_miss": missed / answered if answered else INF,
           "rows": int(m), "malformed": int(bad), "short": short}
    run.say(f"answers checked: {m} rows, {bad} malformed, {short} short; "
            f"recall@{k} {out['recall']}; dist_err {err}; filter_miss "
            f"{out['filter_miss']}")
    return out


def evaluate(run):
    b, rec = run.traffic["batch"], run.rec
    rows = (np.asarray(rec["starts"], np.int64)[:, None]
            + np.arange(b)[None, :]).reshape(-1)
    ids = np.concatenate([i for _, i in rec["out"]])
    dists = np.concatenate([d for d, _ in rec["out"]])
    rec["out"] = None
    sc = score(run, rows, ids, dists)
    half = rec["window_s"] / 2
    first = int((rec["ends"] <= half).sum())
    run.say(f"window: {rec['calls']} calls of {b} in {rec['window_s']:.4f} s;"
            f" halves {first * b / half:.0f} and "
            f"{(rec['calls'] - first) * b / half:.0f} queries/s")
    e2e = {"qps": stats.window_rate(rec["calls"] * b, rec["window_s"]),
           "recall_at_10": sc["recall"]}
    return e2e, {"dist_err": sc["dist_err"],
                 "recall_miss": check.recall_miss(sc["recall"]),
                 "filter_miss": sc["filter_miss"]}


checked = closed_batch.checked
