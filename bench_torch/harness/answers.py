"""Scoring search answers against the plain reference: the exact top-k of
every pool query for recall, and ``check.score_answers`` for the numbers
compared."""

from __future__ import annotations

import numpy as np

from . import check


def score_pool_answers(run, q_rows, ids, dists) -> dict:
    """Answers to pool queries (``q_rows`` index the pool) over the base."""
    ref = run.reference
    base, pool = (ref.to_device(a, run.device) for a in checked_pool(run))
    _, gt = ref.exact_topk(base, pool, run.cfg["k"])
    out = check.score_answers(base, pool, np.asarray(q_rows) % run.data.pool_n,
                              ids, dists, gt_ids=gt)
    run.say(f"answers checked: {out['rows']} rows, {out['malformed']} "
            f"malformed; recall@{run.cfg['k']} "
            f"{out['recall']}; dist_err {out['dist_err']}")
    return out


def checked_pool(run):
    """(the base, the query pool once) as host arrays."""
    return run.data.base, run.data.pool[:run.data.pool_n]
