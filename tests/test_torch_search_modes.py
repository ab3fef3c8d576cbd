"""The rest of the Slim query surface against the JAX engine, on graphs the
JAX package built and saved: greedy descent through CHAL and rank rows
(seed_width 0 and 1), a threshold_level=1 graph, the level-1 seed beam
(chal_search without a seed table), stratified seeds, metric ip, per-query
entry points, and search_async against search.

Tolerances: ids equal on >= 99% of (query, rank) slots and the two engines'
distances within 1e-4 * (1 + |d|) at every slot (so a differing slot is a
near-tie ordered differently), hops equal, recall@10 not below JAX's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_slim_tpu.index.bruteforce import BruteForceIndex
from hnsw_slim_tpu.index.slim import _chal_search_jit
from hnsw_slim_tpu_torch.graph import search as gs
from torch_slice_util import (assert_ids_match, dataset, jax_graph_dir,
                              jax_modes_dir, recall, slim_pair)

torch.set_num_threads(1)

# name: (graph file, serving layout, metric, search knobs, per-query entry)
CASES = {
    "greedy_sw0_chal": ("slim", "chal", "l2", dict(seed_width=0), False),
    "greedy_sw1_dense": ("slim", "dense", "l2", dict(seed_width=1), False),
    "threshold1_sw0_chal": ("slim_t1", "chal", "l2", dict(seed_width=0),
                            False),
    "threshold1_sw0_dense": ("slim_t1", "dense", "l2", dict(seed_width=0),
                             False),
    "strata2": ("slim", "dense0", "l2",
                dict(seed_width=32, seed_strata=2), False),
    "strata4": ("slim", "dense0", "l2",
                dict(seed_width=32, seed_strata=4), False),
    "ip_seeded": ("slim", "dense0", "ip", dict(seed_width=32), False),
    "ip_greedy": ("slim", "chal", "ip", dict(seed_width=0), False),
    "per_query_entry": ("slim", "dense", "l2", dict(seed_width=0), True),
}


def _graph_path(tmp_path_factory, graph):
    root = (jax_graph_dir if graph == "slim" else jax_modes_dir)(
        tmp_path_factory)
    return root / f"{graph}.npz"


@pytest.mark.parametrize("case", sorted(CASES))
def test_search_mode_matches_jax(tmp_path_factory, case):
    graph, layout, metric, knobs, per_query = CASES[case]
    js, ps = slim_pair(_graph_path(tmp_path_factory, graph), layout)
    base, queries = dataset()
    kw = {}
    if per_query:
        ent = np.random.default_rng(5).integers(0, len(base), len(queries))
        kw = dict(entry=ent.astype(np.int32))
    for idx in (js, ps):
        idx.metric = metric
        idx.scfg = dataclasses.replace(idx.scfg, ef=48, pop_width=4, **knobs)
    jd, ji = js.search(queries, k=10,
                       **({"entry": jnp.asarray(kw["entry"])} if kw else {}))
    pd, pi = ps.search(queries, k=10, **kw)
    assert_ids_match(pi, pd, ji, jd)
    assert ps.last_stats["hops"] == js.last_stats["hops"]
    _, gt = BruteForceIndex(base, metric=metric).search(queries, k=10)
    assert recall(pi, gt) >= recall(ji, gt)
    assert (np.diff(pd, axis=1) >= 0).all()


def test_level1_seed_beam_matches_jax(tmp_path_factory):
    """chal_search without a seed table and seed_width=8: level 1 runs as an
    8-wide beam whose buffer seeds level 0, through CHAL rows."""
    js, ps = slim_pair(_graph_path(tmp_path_factory, "slim"), "chal")
    _, queries = dataset()
    g, pg = js.graph, ps.graph
    common = dict(max_level=pg.max_level, threshold_level=0, cap0=pg.cap0,
                  cap=pg.cap, ef=48, k=10, max_iters=40, metric="l2",
                  pop_width=4, seed_width=8)
    jd, ji, jh, jc = jax.device_get(_chal_search_jit(
        g.nbr, g.lvl_off, g.entry, js.vectors, js.vn, jnp.asarray(queries),
        **common))
    pd, pi, ph, pc = gs.chal_search(
        pg.nbr, pg.lvl_off, pg.entry, ps.vectors, ps.vn,
        torch.from_numpy(queries), **common)
    assert_ids_match(pi.numpy(), pd.numpy(), ji, jd)
    np.testing.assert_array_equal(ph.numpy(), jh)
    np.testing.assert_array_equal(pc.numpy(), jc)


@pytest.mark.parametrize("seed_width,filtered", [(32, False), (0, False),
                                                 (32, True)])
def test_search_async_equals_search(tmp_path_factory, seed_width, filtered):
    """search_async enqueues exactly what search runs (seeds, filter and
    all) and returns the device tensors: ids, distances, hops and distance
    counts exactly equal."""
    _, ps = slim_pair(_graph_path(tmp_path_factory, "slim"), "dense0")
    _, queries = dataset()
    ps.scfg = dataclasses.replace(ps.scfg, ef=48, pop_width=4,
                                  seed_width=seed_width)
    mask = None
    if filtered:
        mask = np.random.default_rng(2).random(ps.graph.n) < 0.5
    d, ids = ps.search(queries, k=10, filter_mask=mask)
    ad, ai, ah, ac = ps.search_async(queries, k=10, filter_mask=mask)
    assert all(isinstance(t, torch.Tensor) for t in (ad, ai, ah, ac))
    np.testing.assert_array_equal(ai.numpy(), ids)
    np.testing.assert_array_equal(ad.numpy(), d)
    assert ps.last_stats == {"hops": int(ah.sum()),
                             "distance_computations": int(ac.sum())}
