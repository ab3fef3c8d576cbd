"""SlimZero in the port against the JAX package: the guarded prune (Kγ's
guarded mode on its plain version), the donor in-degrees, the whole
conversion from one LevelGraph, its captured state, the size model, a JAX
SlimZero checkpoint served by the port, and autotune_index.

Tolerances: the prune's rows and counts, the in-degrees, the converted CHAL
arrays and the state are exactly equal; served ids equal on >= 99% of slots
(distances within 1e-4 * (1 + |d|))."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_slim_tpu.config import SlimConfig
from hnsw_slim_tpu.graph import heuristic as jh
from hnsw_slim_tpu.graph import prune as jp
from hnsw_slim_tpu.index.slimzero import HnswSlimZeroIndex as JaxSlimZero
from hnsw_slim_tpu.persist.checkpoint import load_hnsw as jax_load_hnsw
from hnsw_slim_tpu_torch.graph import heuristic as th
from hnsw_slim_tpu_torch.graph import prune as tp
from hnsw_slim_tpu_torch.index.slim import autotune_index
from hnsw_slim_tpu_torch.index.slimzero import HnswSlimZeroIndex
from hnsw_slim_tpu_torch.persist.checkpoint import load_hnsw, save_slim
from torch_slice_util import (assert_ids_match, dataset, jax_graph_dir,
                              jax_modes_dir, slim_pair)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def hnsw_pair(tmp_path_factory):
    """(JAX HnswIndex, port HnswIndex on the CPU) from the JAX-built graph."""
    path = jax_graph_dir(tmp_path_factory) / "hnsw.npz"
    return jax_load_hnsw(path), load_hnsw(path, device="cpu")


def _guarded(jx, px, base_ids, cand, guard, m, w):
    """(JAX rows, JAX counts, port rows, port counts) of one guarded prune."""
    js, jc = jh.prune_batch_guarded(
        jx.vectors, jx.vn, jnp.asarray(base_ids), jnp.asarray(cand),
        jnp.asarray(cand >= 0), jnp.asarray(guard), M=w, out_width=w,
        m_per_row=jnp.asarray(m))
    ps, pc = th.prune_batch_guarded(
        px.vectors, px.vn, torch.from_numpy(base_ids), torch.from_numpy(cand),
        torch.from_numpy(cand >= 0), torch.from_numpy(guard), M=w,
        out_width=w, m_per_row=torch.from_numpy(m))
    return np.asarray(js), np.asarray(jc), ps.numpy(), pc.numpy()


def test_guarded_prune_matches_jax(hnsw_pair):
    """Real level-0 rows with random guards and budgets 1..6: rows and kept
    counts exactly equal; some rows keep more than their budget (guarded
    candidates are kept past it)."""
    jx, px = hnsw_pair
    rng = np.random.default_rng(3)
    base_ids = rng.choice(px.graph.n, 512, replace=False).astype(np.int32)
    cand = px.graph.adjs[0].numpy()[base_ids]
    guard = rng.random(cand.shape) < 0.3
    m = rng.integers(1, 7, len(base_ids)).astype(np.int32)
    js, jc, ps, pc = _guarded(jx, px, base_ids, cand, guard, m,
                              cand.shape[1])
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(pc, jc)
    assert (pc > m).any() and (pc < (cand >= 0).sum(1)).any()


def test_guarded_prune_rules():
    """Hand-made rows in the plane (padded to 8 dims). Base at the origin;
    A = (1, 0), G = (1.2, 0.1), F = (0, 3), H = (-2, 0), K = (0, -2.5).
    Row 0: G is guarded, so it is kept first although it lies farther than
    A, and then rejects A (|A-G| < |A|); F survives. Row 1: no guard: A is
    kept and rejects G. Row 2: four guarded candidates with budget 2: all
    four are kept and the unguarded one is not considered. Equal to JAX."""
    pts = np.zeros((6, 8), np.float32)
    pts[1, :2], pts[2, :2], pts[3, :2] = (1, 0), (1.2, 0.1), (0, 3)
    pts[4, :2], pts[5, :2] = (-2, 0), (0, -2.5)

    class X:
        vectors = torch.from_numpy(pts)
        vn = (vectors * vectors).sum(1)

    class J:
        vectors = jnp.asarray(pts)
        vn = jnp.sum(vectors * vectors, axis=1)

    base_ids = np.zeros(3, np.int32)
    cand = np.array([[1, 2, 3, -1, -1], [1, 2, 3, -1, -1], [1, 2, 3, 4, 5]],
                    np.int32)
    guard = np.array([[0, 1, 0, 0, 0], [0] * 5, [0, 1, 1, 1, 1]], bool)
    m = np.array([3, 3, 2], np.int32)
    js, jc, ps, pc = _guarded(J, X, base_ids, cand, guard, m, 5)
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(pc, jc)
    assert ps[0].tolist() == [2, 3, -1, -1, -1]
    assert ps[1].tolist() == [1, 3, -1, -1, -1]
    assert ps[2].tolist() == [2, 4, 5, 3, -1] and pc[2] == 4 > m[2]


def test_level_indegrees_match_jax(hnsw_pair):
    jx, px = hnsw_pair
    adj = [a.numpy() for a in px.graph.adjs]
    want = jp.level_indegrees(adj, px.levels)
    got = tp.level_indegrees(adj, px.levels)
    assert len(got) == len(want) == px.graph.max_level + 1
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("threshold_level", [0, 1])
def test_convert_to_slimzero_matches_jax(hnsw_pair, threshold_level):
    """Same LevelGraph, same config: nbr, lvl_off and level arrays,
    chal_bytes and the captured state exactly equal; the in-degree floor
    holds wherever the donor graph could supply it."""
    jx, px = hnsw_pair
    cfg = SlimConfig.from_ratios(threshold_level=threshold_level)
    j_state, p_state = {}, {}
    jg = jp.convert_to_slimzero(jx.graph, jx.vectors, jx.vn, cfg,
                                state=j_state)
    pg = tp.convert_to_slimzero(px.graph, px.vectors, px.vn, cfg,
                                state=p_state)
    for name in ("nbr", "lvl_off", "level"):
        np.testing.assert_array_equal(getattr(pg, name).numpy(),
                                      np.asarray(getattr(jg, name)))
    assert pg.chal_bytes() == jg.chal_bytes()
    assert (pg.entry, pg.max_level, pg.threshold_level, pg.cap0, pg.cap) == (
        int(jg.entry), jg.max_level, jg.threshold_level, jg.cap0, jg.cap)
    assert sorted(p_state) == sorted(j_state)
    for key in ("final", "budgets", "caps"):
        assert len(p_state[key]) == len(j_state[key])
        for a, b in zip(p_state[key], j_state[key]):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(p_state["thr"], j_state["thr"])
    np.testing.assert_array_equal(p_state["levels"], j_state["levels"])
    assert (p_state["entry"], p_state["lmax"]) == (j_state["entry"],
                                                   j_state["lmax"])


def test_slimzero_index_and_size_estimate(hnsw_pair):
    """from_hnsw gives an index of the SlimZero class that passes
    check_integrity and reports the JAX index's size; size_estimate equals
    the JAX model at both threshold forms."""
    jx, px = hnsw_pair
    cfg = SlimConfig.from_ratios()
    ps = HnswSlimZeroIndex.from_hnsw(px, cfg)
    js = JaxSlimZero.from_hnsw(jx, cfg)
    assert type(ps) is HnswSlimZeroIndex and ps.device.type == "cpu"
    assert ps.check_integrity() == js.check_integrity()
    assert ps.index_size() == js.index_size()
    for t in (0, 2):
        c = SlimConfig.from_ratios(threshold_level=t)
        assert HnswSlimZeroIndex.size_estimate(10**6, "32", c) == \
            JaxSlimZero.size_estimate(10**6, "32", c)


def test_jax_slimzero_checkpoint_serves_in_the_port(tmp_path_factory,
                                                    tmp_path):
    """A SlimZero checkpoint the JAX package wrote loads into the port as
    HnswSlimZeroIndex and serves the JAX engine's ids; the port's save_slim
    writes the same kind back."""
    from hnsw_slim_tpu.persist.checkpoint import load_slim as jax_load_slim

    js, ps = slim_pair(jax_modes_dir(tmp_path_factory) / "slimzero.npz",
                       "dense0")
    assert type(ps) is HnswSlimZeroIndex and type(js) is JaxSlimZero
    _, queries = dataset()
    for idx in (js, ps):
        idx.scfg = dataclasses.replace(idx.scfg, ef=48, pop_width=4,
                                       seed_width=32)
    jd, ji = js.search(queries, k=10)
    pd, pi = ps.search(queries, k=10)
    assert_ids_match(pi, pd, ji, jd)
    assert ps.last_stats["hops"] == js.last_stats["hops"]
    save_slim(tmp_path / "z.npz", ps)
    back = jax_load_slim(tmp_path / "z.npz")
    assert type(back) is JaxSlimZero
    np.testing.assert_array_equal(np.asarray(back.graph.nbr),
                                  np.asarray(js.graph.nbr))


def test_autotune_picks_from_the_grid(tmp_path_factory):
    """autotune_index on the CPU: the grid is the JAX package's for this ef
    (lossless (8, 0) first), the winner's probe recall is within the slack
    of the best and so never below the lossless config's minus the slack,
    scfg holds the winner, and the report is cached per (ef, k)."""
    _, ps = slim_pair(jax_graph_dir(tmp_path_factory) / "slim.npz", "dense0")
    ps.scfg = dataclasses.replace(ps.scfg, seed_width=32)
    rep = autotune_index(ps, 128, sample=64)
    grid = {(g["pop_width"], g["scan_width"]): g["recall"]
            for g in rep["grid"]}
    assert list(grid) == [(8, 0), (16, 0), (16, 96), (16, 128), (16, 192)]
    knobs = (rep["knobs"]["pop_width"], rep["knobs"]["scan_width"])
    assert knobs in grid
    assert grid[knobs] >= rep["probe_recall"] - 0.002 - 1e-4
    assert grid[knobs] >= grid[(8, 0)] - 0.002 - 1e-4
    assert (ps.scfg.ef, ps.scfg.pop_width, ps.scfg.scan_width) == (128,) + knobs
    assert ps.scfg.seed_width == 32
    assert ps.autotune(128) is rep
