"""Parity of the port's vanilla HNSW query path (index/hnsw.py search ->
graph/search.py level_search: greedy descent on Kε's plain version, the
level-0 beam on Kβ's) against the JAX package, on the JAX insertion-built
graph read through the port's load_hnsw."""

import dataclasses

import numpy as np
import pytest
import torch

from hnsw_slim_tpu.persist.checkpoint import load_hnsw as jax_load_hnsw
from hnsw_slim_tpu_torch.config import HnswConfig
from hnsw_slim_tpu_torch.index.hnsw import HnswIndex
from hnsw_slim_tpu_torch.persist.checkpoint import load_hnsw
from torch_slice_util import INS_EF, insert_dataset, jax_insert_dir

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(JAX index, port index on the CPU), both loaded from the JAX-built
    insertion graph."""
    path = jax_insert_dir(tmp_path_factory) / "hnsw_insert.npz"
    return jax_load_hnsw(path), load_hnsw(path, device="cpu")


@pytest.mark.parametrize("ef,pop", [(32, 1), (64, 4), (256, 4)])
def test_hnsw_search_matches_jax(engines, ef, pop):
    """Same graph, queries and knobs: ids identical on >= 99% of
    (query, rank) slots, hops and distance computations equal, distances
    within 1e-4 * (1 + |d|) on equal slots. ef=256 runs JAX's bitonic
    merge."""
    js, ps = engines
    _, queries = insert_dataset()
    for idx in (js, ps):
        idx.scfg = dataclasses.replace(idx.scfg, ef=ef, pop_width=pop)
    jd, ji = js.search(queries, k=10)
    pd, pi = ps.search(queries, k=10)
    assert (pi == ji).mean() >= 0.99
    assert ps.last_stats == js.last_stats
    same = pi == ji
    assert np.all(np.abs(pd[same] - jd[same]) <= 1e-4 * (1 + np.abs(jd[same])))


def test_recorded_jax_search_is_reproduced(engines, tmp_path_factory):
    """The port's search at ef=32 on the JAX-built graph returns the JAX
    build's own recorded results (ids on >= 99% of slots, equal hops)."""
    _, ps = engines
    with np.load(jax_insert_dir(tmp_path_factory) / "capture.npz") as z:
        want_i, hops = z["search_i"], int(z["search_hops"])
    _, queries = insert_dataset()
    ps.set_ef(INS_EF)
    assert ps.scfg.ef == INS_EF
    _, pi = ps.search(queries, k=10)
    assert (pi == want_i).mean() >= 0.99
    assert ps.last_stats["hops"] == hops


def test_integrity_and_unported_options(engines):
    """check_integrity reports JAX's in-degree statistics on the same graph;
    the filtered search (K6) returns the JAX engine's ids (>= 99% of slots),
    all allowed; with everything allowed it returns the unfiltered
    result."""
    js, ps = engines
    assert ps.check_integrity() == js.check_integrity()
    n = ps.graph.n
    _, queries = insert_dataset()
    for idx in (js, ps):
        idx.scfg = dataclasses.replace(idx.scfg, ef=32, pop_width=4)
    mask = np.arange(n) % 2 == 1
    _, ji = js.search(queries, 10, filter_mask=mask)
    _, pi = ps.search(queries, 10, filter_mask=mask)
    assert (pi == ji).mean() >= 0.99
    assert (pi >= 0).all() and mask[pi].all()
    np.testing.assert_array_equal(
        ps.search(queries, 10, filter_mask=np.ones(n, bool))[1],
        ps.search(queries, 10)[1])
    assert HnswIndex(HnswConfig(), device="cpu").scfg.ef == \
        HnswConfig().ef_search
