"""The port's neighbor-fetch forms and serving layouts against the JAX
package, on a Slim graph the JAX package built and saved (loaded through the
port's load_slim): ``fetch_rows_plain`` in CHAL and rank form against
``make_chal_fetch`` / ``make_rank_fetch`` (exactly equal, every level), the
Slim search over the three serving layouts (identical ids), and the
in-place layout updates after a changed host mirror (arrays exactly equal
to what the JAX methods produce)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_slim_tpu.graph import search as jgs
from hnsw_slim_tpu_torch.graph import search as gs
from torch_slice_util import (assert_ids_match, dataset, jax_graph_dir,
                              jax_modes_dir, slim_pair)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX index, port index), dense level 0 and dense upper levels."""
    return slim_pair(jax_graph_dir(tmp_path_factory) / "slim.npz", "dense")


def test_chal_and_rank_fetch_match_jax(pair):
    """Every node's row at every level, lane for lane: the CHAL form against
    make_chal_fetch, the rank form against make_rank_fetch, and the port's
    dense upper layout against JAX's arrays. Exact."""
    js, ps = pair
    g = ps.graph
    assert g.max_level >= 1
    v = np.arange(g.n, dtype=np.int32)
    np.testing.assert_array_equal(ps.rank_up.numpy(), np.asarray(js.rank_up))
    for l in range(g.max_level + 1):
        w = g.cap if l else g.cap0
        want = np.asarray(jgs.make_chal_fetch(
            js.graph.nbr, js.graph.lvl_off, l, w)(jnp.asarray(v)))
        got = gs.fetch_rows_plain(gs.chal_fetch(g.nbr, g.lvl_off, l, w),
                                  torch.from_numpy(v))
        np.testing.assert_array_equal(got.numpy(), want)
        assert (want >= 0).any()
        if l == 0:
            continue
        np.testing.assert_array_equal(ps.dense_up[l - 1].numpy(),
                                      np.asarray(js.dense_up[l - 1]))
        want = np.asarray(jgs.make_rank_fetch(
            js.rank_up, js.dense_up[l - 1])(jnp.asarray(v)))
        got = gs.fetch_rows_plain(
            gs.rank_fetch(ps.rank_up, ps.dense_up[l - 1]),
            torch.from_numpy(v))
        np.testing.assert_array_equal(got.numpy(), want)
        # the two forms hold the same ids (the CHAL slice is unsorted)
        chal = gs.fetch_rows_plain(gs.chal_fetch(g.nbr, g.lvl_off, l, w),
                                   torch.from_numpy(v)).numpy()
        np.testing.assert_array_equal(np.sort(chal, axis=1),
                                      np.sort(want, axis=1))


@pytest.mark.parametrize("graph,seed_width", [("slim", 32), ("slim", 0),
                                              ("slim_t1", 0)])
def test_three_serving_layouts_give_identical_ids(tmp_path_factory, graph,
                                                  seed_width):
    """CHAL only, dense level 0, dense level 0 + dense upper: the port's
    search returns identical ids, distances, hops and distance counts
    (exact), and they match the JAX engine's (>= 99% of slots)."""
    root = (jax_graph_dir if graph == "slim" else jax_modes_dir)(
        tmp_path_factory)
    _, queries = dataset()
    scfg = None
    outs = []
    for layout in ("chal", "dense0", "dense"):
        js, ps = slim_pair(root / f"{graph}.npz", layout)
        scfg = dataclasses.replace(ps.scfg, ef=48, pop_width=4,
                                   seed_width=seed_width)
        ps.scfg = scfg
        outs.append(ps.search(queries, k=10) + (ps.last_stats,))
    assert (ps.dense0 is not None) and (ps.dense_up is not None)
    for d, ids, stats in outs[1:]:
        np.testing.assert_array_equal(ids, outs[0][1])
        np.testing.assert_array_equal(d, outs[0][0])
        assert stats == outs[0][2]
    js.scfg = scfg
    jd, ji = js.search(queries, k=10)
    assert_ids_match(outs[0][1], outs[0][0], ji, jd)
    assert outs[0][2]["hops"] == js.last_stats["hops"]


def test_layout_updates_track_a_changed_host_mirror(pair):
    """update_dense0 and update_dense_upper after edits of the host mirror
    (rewired level-0 and upper rows, one node dropped to level 0 — the
    level-drop case of the JAX package's own test, one node raised to level
    1) leave exactly the arrays the JAX methods leave."""
    js, ps = pair
    c = {k: np.array(v) for k, v in ps._host_chal().items()}
    up = np.nonzero(c["level"] >= 1)[0]
    low = np.nonzero(c["level"] == 0)[0]
    victim, riser = int(up[0]), int(low[5])
    nbr = c["nbr"]
    # rewire: reverse the level-0 slice of a few nodes and the level-1 slice
    # of a few upper nodes (the canonical rows are sorted, so also swap in
    # another id to change them)
    touched0 = low[10:14]
    for v in touched0:
        s, e = c["lvl_off"][v, 0], c["lvl_off"][v, 1]
        nbr[s:e] = nbr[s:e][::-1]
        if e > s:
            nbr[s] = (nbr[s] + 1) % len(c["level"])
    touched1 = up[2:6]
    for v in touched1:
        s, e = c["lvl_off"][v, 1], c["lvl_off"][v, 2]
        if e > s:
            nbr[s] = up[(np.searchsorted(up, nbr[s]) + 1) % len(up)]
    c["level"][victim] = 0
    c["level"][riser] = 1
    ids0 = np.concatenate([touched0, [victim]])
    ids_up = np.concatenate([touched1, up[:3], [victim, riser]])
    for idx in (js, ps):
        idx.update_dense0(c, ids0)
        idx.update_dense_upper(c, ids_up)
    assert int(ps._rank_np[victim]) == -1 and int(ps._rank_np[riser]) >= 0
    assert ps._n_up == js._n_up
    np.testing.assert_array_equal(ps._rank_np, js._rank_np)
    np.testing.assert_array_equal(ps.rank_up.numpy(), np.asarray(js.rank_up))
    np.testing.assert_array_equal(ps.dense0.numpy(), np.asarray(js.dense0))
    for a, b in zip(ps.dense_up, js.dense_up):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
