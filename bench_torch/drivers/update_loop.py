"""A closed loop of insert batches through the client/server update
protocol (the paper's Table 4): each batch of ``batch`` new vectors (from
the seed, in the base's distribution) is one ``/updateIndex`` and then the
client's ``sync_patches`` onto its own copy, which ``/getIndex``
bootstrapped in set-up. Batches run back to back until ``--seconds`` have
passed; the last one runs to its end. No query load.

End to end: ``update_s``, the seconds per batch until the client's copy has
applied it (the whole run of batches over their count).

Checked after the window (``harness/check.py``): the client's copy holds
every acknowledged vector exactly (against the reference store: the base
and every batch in order) and the server's graph (``copy_err``); searches
on the copy return the reference's distances (``dist_err``), find the
reference's top-k of pool queries over the whole store (``recall_miss``),
and find each vector of the last batch as its own nearest neighbour
(``last_batch_miss``): what was acknowledged is linked and reachable."""

from __future__ import annotations

import time

import numpy as np

from harness import check

SYSTEM = "slim_server"


def extra_vectors(traffic: dict, seconds: float) -> int:
    return traffic["batch"] * traffic["max_batches"]


def _batch(run, b: int) -> tuple[range, np.ndarray]:
    size = run.traffic["batch"]
    if (b + 1) * size > len(run.data.extra):
        raise RuntimeError(f"more than {run.traffic['max_batches']} batches "
                           "in one run: raise max_batches")
    lo = run.info["n"] + b * size
    return range(lo, lo + size), run.data.extra[b * size:(b + 1) * size]


def _one(run, b: int) -> tuple[float, float]:
    """Batch b through /updateIndex and sync_patches: (server s, client s)."""
    labels, vecs = _batch(run, b)
    span = run.tracer.span
    t0 = time.monotonic()
    with span("update_index"):
        blob, fin = run.client.update_index(labels, vecs)
    t1 = time.monotonic()
    with span("sync_patches"):
        run.local = run.client.sync_patches(run.local, blob, fin)
        run.sync()
    return t1 - t0, time.monotonic() - t1


def setup(run) -> None:
    from hnsw_slim_tpu_torch.config import SearchConfig

    run.client = run.system.client()
    run.local = run.client.bootstrap(device=run.device)
    run.local.scfg = SearchConfig(**run.cfg["search"])
    run.rec["batches_done"] = 0
    for _ in range(run.traffic["warm_batches"]):
        _one(run, run.rec["batches_done"])
        run.rec["batches_done"] += 1


def window(run) -> None:
    server_s, client_s = [], []
    b = run.rec["batches_done"]
    t0 = time.monotonic()
    t_end = t0 + run.seconds
    while time.monotonic() < t_end:
        s, c = _one(run, b)
        server_s.append(s)
        client_s.append(c)
        b += 1
    wall = time.monotonic() - t0
    run.rec.update(server_s=server_s, client_s=client_s, window_s=wall,
                   batches_done=b, attempted=len(server_s), failed=0)


def collect(run) -> None:
    """The copy's rows and graph, the server's graph, and searches on the
    copy, read before the system is freed."""
    from hnsw_slim_tpu_torch.persist.patch import to_np

    server, local, k = run.system.server, run.local, run.cfg["k"]
    n_local = int(local.graph.n)
    copy = local.vectors[:n_local].float().cpu().numpy()
    equal = check.same_graph(to_np(local.graph), n_local,
                             server.inc.host_chal, int(server.hnsw.graph.n))
    n_pool = run.traffic["check_pool_queries"]
    start = int(np.random.default_rng(run.seed).integers(run.data.pool_n))
    _, last = _batch(run, run.rec["batches_done"] - 1)
    queries = np.concatenate([run.data.queries(start, n_pool), last])
    d, i = local.search(queries, k)
    run.rec.update(copy=copy, graph_equal=equal, queries=queries,
                   out=(d, i))
    run.local = run.client = None


def checked(run):
    """(the reference store: the base and every batch inserted, in order;
    the queries searched on the copy) as host arrays."""
    size = run.traffic["batch"]
    store = np.concatenate([run.data.base,
                            run.data.extra[:run.rec["batches_done"] * size]])
    return store, run.rec["queries"]


def evaluate(run):
    r, ref = run.rec, run.reference
    size = run.traffic["batch"]
    store, _ = checked(run)
    cerr = check.copy_err(r["copy"], store, r["graph_equal"])
    run.say(f"client copy: {len(r['copy'])} rows against {len(store)} in "
            f"the reference store, graph equal to the server's "
            f"{r['graph_equal']}, copy_err {cerr}")
    base = ref.to_device(store, run.device)
    qs = ref.to_device(r["queries"], run.device)
    d, i = r["out"]
    n_pool = len(qs) - size
    _, gt = ref.exact_topk(base, qs[:n_pool], run.cfg["k"])
    pool = check.score_answers(base, qs[:n_pool], np.arange(n_pool),
                               i[:n_pool], d[:n_pool], gt_ids=gt)
    own = check.score_answers(base, qs[n_pool:], np.arange(size),
                              i[n_pool:], d[n_pool:])
    derr = max(pool["dist_err"], own["dist_err"])
    miss = float((i[n_pool:, 0] != np.arange(len(store) - size,
                                             len(store))).mean())
    run.say(f"searches on the copy: {pool['rows']} pool queries, recall "
            f"{pool['recall']}; {own['rows']} vectors of the last batch, "
            f"not found first {miss:.4f}; "
            f"{pool['malformed'] + own['malformed']} malformed, dist_err "
            f"{derr}")
    run.say(f"window: {len(r['server_s'])} batches in {r['window_s']:.4f} s;"
            f" server s {[round(x, 4) for x in r['server_s']]}, client s "
            f"{[round(x, 4) for x in r['client_s']]}")
    e2e = {"update_s": r["window_s"] / len(r["server_s"])}
    return e2e, {"copy_err": cerr, "dist_err": derr,
                 "recall_miss": check.recall_miss(pool["recall"]),
                 "last_batch_miss": miss}
