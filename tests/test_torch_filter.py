"""Filtered search (Kβ's filtered mode on its plain version, the allowed-only
result track) against the JAX engine on JAX-built graphs: HnswSlimIndex at
threshold level 0 and 1 and the vanilla HnswIndex, at 50% and 90% filtered.

Tolerances: ids equal on >= 99% of slots with distances within
1e-4 * (1 + |d|) at every slot, hops equal; every returned id allowed, no -1
where JAX returns none, distances ascending."""

import dataclasses

import numpy as np
import pytest
import torch

from hnsw_slim_tpu.persist.checkpoint import load_hnsw as jax_load_hnsw
from hnsw_slim_tpu_torch.persist.checkpoint import load_hnsw
from torch_slice_util import (N, assert_ids_match, dataset, jax_graph_dir,
                              jax_modes_dir, slim_pair)

torch.set_num_threads(1)


def _mask(filtered: float) -> np.ndarray:
    return np.random.default_rng(11).random(N) >= filtered


def _check_filtered(js, ps, mask, k=10):
    _, queries = dataset()
    jd, ji = js.search(queries, k=k, filter_mask=mask)
    pd, pi = ps.search(queries, k=k, filter_mask=mask)
    assert_ids_match(pi, pd, ji, jd)
    assert ps.last_stats["hops"] == js.last_stats["hops"]
    assert ((pi >= 0) == (ji >= 0)).all()
    assert (pi >= 0).mean() >= 0.99  # the track fills at these shares
    assert mask[pi[pi >= 0]].all()
    assert (np.diff(np.minimum(pd, np.float32(3e38)), axis=1) >= 0).all()


@pytest.mark.parametrize("filtered", [0.5, 0.9])
@pytest.mark.parametrize("graph,layout,seed_width", [
    ("slim", "dense0", 32), ("slim", "chal", 0), ("slim_t1", "dense", 0)])
def test_filtered_slim_search_matches_jax(tmp_path_factory, graph, layout,
                                          seed_width, filtered):
    root = (jax_graph_dir if graph == "slim" else jax_modes_dir)(
        tmp_path_factory)
    js, ps = slim_pair(root / f"{graph}.npz", layout)
    for idx in (js, ps):
        idx.scfg = dataclasses.replace(idx.scfg, ef=48, pop_width=4,
                                       seed_width=seed_width, scan_width=96)
    _check_filtered(js, ps, _mask(filtered))


@pytest.mark.parametrize("filtered", [0.5, 0.9])
def test_filtered_hnsw_search_matches_jax(tmp_path_factory, filtered):
    path = jax_graph_dir(tmp_path_factory) / "hnsw.npz"
    js, ps = jax_load_hnsw(path), load_hnsw(path, device="cpu")
    for idx in (js, ps):
        idx.scfg = dataclasses.replace(idx.scfg, ef=48, pop_width=4)
    _check_filtered(js, ps, _mask(filtered))


def test_track_is_seeded_with_the_best_seed_only(tmp_path_factory):
    """The reference's one-seed track, kept: only the best exact seed enters
    the allowed-only track (if allowed); the other seeds sit in the
    traversal buffer and, while they stay there, are never scored again and
    so never returned. Here only upper-level nodes are allowed and the
    query's best seed is not: the second-best seed is then the nearest
    allowed node of all, it never leaves the buffer, and neither engine
    returns it."""
    js, ps = slim_pair(jax_graph_dir(tmp_path_factory) / "slim.npz", "dense0")
    base, queries = dataset()
    for idx in (js, ps):
        idx.scfg = dataclasses.replace(idx.scfg, ef=48, pop_width=4,
                                       seed_width=32)
    level = ps.graph.level.numpy()
    upper = np.nonzero(level >= 1)[0]
    for q in queries[:3]:
        d_up = ((base[upper] - q) ** 2).sum(1)
        seeds = upper[np.argsort(d_up, kind="stable")[:32]]
        mask = level >= 1
        mask[seeds[0]] = False
        jd, ji = js.search(q[None], k=10, filter_mask=mask)
        pd, pi = ps.search(q[None], k=10, filter_mask=mask)
        np.testing.assert_array_equal(pi, ji)
        assert mask[seeds[1]] and seeds[1] not in pi
        assert mask[pi[pi >= 0]].all()
