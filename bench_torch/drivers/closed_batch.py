"""A closed loop with one caller: each call searches ``batch`` consecutive
pool queries (from an offset the seed sets, wrapping), the next call starts
when the last has answered. The window runs calls until ``--seconds`` have
passed; the last call runs to its end.

End to end: ``qps`` (every query answered over the whole window) and
``recall_at_10`` (every answer of the window against the exact top-k).
Compared: ``dist_err`` and ``recall_miss`` over every answer of the window
(``harness/check.py``)."""

from __future__ import annotations

import time

import numpy as np

from harness import answers, check, stats

SYSTEM = "slim_index"


def _offset(run) -> int:
    return int(np.random.default_rng(run.seed).integers(run.data.pool_n))


def setup(run) -> None:
    b = run.traffic["batch"]
    for j in range(run.traffic["warm_calls"]):
        run.system.search(run.data.queries(j * b, b), run.cfg["k"])


def window(run) -> None:
    b, k = run.traffic["batch"], run.cfg["k"]
    search, span = run.system.search, run.tracer.span
    start = _offset(run)
    starts, out, ends = [], [], []
    t0 = time.monotonic()
    t_end = t0 + run.seconds
    while time.monotonic() < t_end:
        q = run.data.queries(start, b)
        with span("search_call"):
            out.append(search(q, k))
        ends.append(time.monotonic())
        starts.append(start)
        start = (start + b) % run.data.pool_n
    wall = time.monotonic() - t0
    run.rec.update(calls=len(out), window_s=wall, starts=starts, out=out,
                   ends=np.asarray(ends) - t0, attempted=len(out) * b,
                   failed=0)


def evaluate(run):
    b, rec = run.traffic["batch"], run.rec
    rows = (np.asarray(rec["starts"], np.int64)[:, None]
            + np.arange(b)[None, :]).reshape(-1)
    ids = np.concatenate([i for _, i in rec["out"]])
    dists = np.concatenate([d for d, _ in rec["out"]])
    rec["out"] = None
    sc = answers.score_pool_answers(run, rows, ids, dists)
    half = rec["window_s"] / 2
    first = int((rec["ends"] <= half).sum())
    run.say(f"window: {rec['calls']} calls of {b} in {rec['window_s']:.4f} s;"
            f" halves {first * b / half:.0f} and "
            f"{(rec['calls'] - first) * b / half:.0f} queries/s")
    e2e = {"qps": stats.window_rate(rec["calls"] * b, rec["window_s"]),
           "recall_at_10": sc["recall"]}
    return e2e, {"dist_err": sc["dist_err"],
                 "recall_miss": check.recall_miss(sc["recall"])}


def checked(run):
    """(the rows searched, the queries checked) as host arrays."""
    return answers.checked_pool(run)
