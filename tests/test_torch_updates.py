"""Parity of the port's vanilla-graph update path (index/hnsw.py add_points,
replace_points, _grow_capacity, _row_deg; graph/build.py collect mode,
_insert_batch, _reverse_connect; graph/revconn.py kv_sort: the plain
versions of Kθ and Kι on the CPU) against the JAX package.

The JAX package runs the update path once per test run
(torch_slice_util.jax_update_dir: an insertion build of 2500 x 24 normal
points, M=8, ef_construction=48, max_batch 512, then three add_points
batches of 120 and one replace_points batch of 60) and saves the graph after
every step; each port step starts from the JAX graph of the step before,
loaded through load_hnsw.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from hnsw_slim_tpu.index import hnsw as jhnsw
from hnsw_slim_tpu_torch.graph import build as tb
from hnsw_slim_tpu_torch.graph import revconn
from hnsw_slim_tpu_torch.index import hnsw as thnsw
from hnsw_slim_tpu_torch.ops import sort
from hnsw_slim_tpu_torch.persist.checkpoint import (load_hnsw, load_slim,
                                                    save_hnsw, save_slim)
from torch_slice_util import (UPD_ADD, UPD_BATCH, jax_update_dir,
                              replay_padding_fault, update_dataset)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def upd(tmp_path_factory):
    """(directory of the JAX run, its record as a dict)."""
    d = jax_update_dir(tmp_path_factory)
    with np.load(d / "rec.npz") as z:
        return d, {k: z[k] for k in z.files}


@pytest.fixture
def padding_fault(monkeypatch):
    replay_padding_fault(monkeypatch)


def _load(d, step):
    h = load_hnsw(d / f"hnsw{step}.npz", device="cpu")
    h.max_batch = UPD_BATCH
    return h


def _row_sets(a):
    return [frozenset(r[r >= 0].tolist()) for r in a]


def test_row_deg_plain_matches_jax():
    """row_deg_plain = JAX's _row_deg on rows with holes, empty and full
    rows: exact."""
    rng = np.random.default_rng(0)
    a = rng.integers(-1, 50, (300, 16)).astype(np.int32)
    a[rng.random(a.shape) < 0.3] = -1
    a[0], a[1] = -1, 7
    want = np.asarray(jhnsw._row_deg(jnp.asarray(a)))
    got = thnsw._row_deg(torch.from_numpy(a))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("e,with_payload", [(0, True), (1, True),
                                            (777, True), (4096, False),
                                            (5000, True)])
def test_kv_sort_plain_matches_lax_sort(e, with_payload):
    """kv_sort (plain on the CPU) = lax.sort((u, p), num_keys=1): keys with
    many ties, a share of 2^30 padding keys, payload in input order within
    a tie: exact; with n (ids below n = 40), and through the ids map over
    n.bit_length() bits that the CUDA route sorts by
    (kv_radix_sort_plain's ids map), the same."""
    rng = np.random.default_rng(e)
    u = rng.integers(0, 40, e).astype(np.int32)
    u[rng.random(e) < 0.25] = revconn.BIG
    p = rng.integers(0, 10**6, e).astype(np.int32)
    tu_, tp_ = torch.from_numpy(u), torch.from_numpy(p) if with_payload \
        else None
    if with_payload:
        ju, jp = lax.sort((jnp.asarray(u), jnp.asarray(p)), dimension=0,
                          num_keys=1)
    else:
        ju, jp = lax.sort(jnp.asarray(u), dimension=0), None
    outs = [revconn.kv_sort(tu_, tp_), revconn.kv_sort(tu_, tp_, n=40),
            sort.kv_radix_sort_plain(tu_, tp_, (40).bit_length(),
                                     key_map="ids")]
    for tu, tp in outs:
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
        if with_payload:
            np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        else:
            assert tp is None


def test_grow_capacity_shapes_and_padding(upd):
    """_grow_capacity: arrays grow to the 16384-row bucket, padding rows
    carry level -1, no edges and zero vectors, a new top level appears
    empty, existing content is kept, and a second call inside the bucket
    keeps the device arrays."""
    h = _load(upd[0], 0)
    n, lmax = h.graph.n, h.graph.max_level
    before = [a.numpy().copy() for a in h.graph.adjs]
    adj_np, adj_dev = h._grow_capacity(n + 100, lmax + 1)
    assert len(adj_np) == len(adj_dev) == lmax + 2
    for l, (m, dv) in enumerate(zip(adj_np, adj_dev)):
        cap_l = h.cfg.maxM0 if l == 0 else h.cfg.maxM
        assert m.shape == tuple(dv.shape) == (16384, cap_l)
        np.testing.assert_array_equal(m, dv.numpy())
        assert (m[n:] == -1).all()
        if l <= lmax:
            np.testing.assert_array_equal(m[:n], before[l])
    assert (adj_np[lmax + 1] == -1).all()
    assert h.vectors.shape == (16384, 24) and not h.vectors[n:].any()
    assert len(h.levels) == 16384 and (h.levels[n:] == -1).all()
    assert h.graph.n == n  # the logical count moves only with add_points
    h.graph = thnsw.LevelGraph(tuple(adj_dev), h.graph.level, h.graph.entry,
                               lmax + 1, n)
    vec = h.vectors
    _, again = h._grow_capacity(n + 200, lmax + 1)
    assert all(a is b for a, b in zip(again, adj_dev)) and h.vectors is vec


@pytest.mark.parametrize("step", [1, 2, 3])
def test_add_points_equals_jax_with_the_reference_fault_replayed(
        upd, padding_fault, step):
    """add_points on the JAX graph of the step before, with the JAX insert
    batch's padding fault replayed: levels, entry, n, the touched set and
    every row of every level exactly equal to the JAX result; the host
    mirror equals the device adjacency."""
    d, rec = upd
    h = _load(d, step - 1)
    touched = h.add_points(update_dataset()[1][step - 1])
    lmax = h.graph.max_level
    assert h.graph.n == 2500 + step * UPD_ADD
    assert int(h.graph.entry) == int(rec[f"s{step}_entry"])
    np.testing.assert_array_equal(h.levels, rec[f"s{step}_levels"])
    np.testing.assert_array_equal(h.graph.level.numpy(), h.levels)
    np.testing.assert_array_equal(touched, rec[f"s{step}_touched"])
    for l in range(lmax + 1):
        np.testing.assert_array_equal(h.host_adj()[l], rec[f"s{step}_adj{l}"])
        np.testing.assert_array_equal(h.graph.adjs[l].numpy(),
                                      h.host_adj()[l])
    np.testing.assert_array_equal(h.vectors.numpy(), rec[f"s{step}_vectors"])
    st = h.last_update_stats
    assert st["touched"] == len(touched)
    assert st["overflow"]["truncated_applies"] == 0
    assert set(st["seconds"]) == {"grow", "vectors", "insert_batches",
                                  "mirror_sync"}
    h.check_integrity()


def test_add_points_without_the_fault_is_close_to_jax(upd):
    """Without the fault replayed (the port gives every insert its own
    search) the level-0 edge sets equal JAX's on >= 95% of rows, and the
    touched set holds every new id."""
    d, rec = upd
    h = _load(d, 0)
    touched = h.add_points(update_dataset()[1][0])
    same = [a == b for a, b in zip(_row_sets(h.host_adj()[0]),
                                   _row_sets(rec["s1_adj0"]))]
    assert np.mean(same) >= 0.95
    assert set(range(2500, 2500 + UPD_ADD)) <= set(touched.tolist())
    h.check_integrity()


def test_replace_points_equals_jax(upd):
    """replace_points composes its candidates on the host in both engines
    (no padding fault): rows of every level, touched, level_changed, levels
    and entry exactly equal to the JAX result on the JAX graph of step 3."""
    d, rec = upd
    _, _, slots, rep, _ = update_dataset()
    h = _load(d, 3)
    n = h.graph.n
    touched, level_changed = h.replace_points(slots, rep)
    assert h.graph.n == n
    assert int(h.graph.entry) == int(rec["s4_entry"])
    np.testing.assert_array_equal(level_changed, rec["s4_level_changed"])
    np.testing.assert_array_equal(touched, rec["s4_touched"])
    np.testing.assert_array_equal(h.levels, rec["s4_levels"][:n])
    for l in range(h.graph.max_level + 1):
        np.testing.assert_array_equal(h.host_adj()[l], rec[f"s4_adj{l}"][:n])
        np.testing.assert_array_equal(h.graph.adjs[l].numpy(),
                                      h.host_adj()[l])
    np.testing.assert_array_equal(h.vectors.numpy()[slots], rep)
    h.check_integrity()


def test_replace_points_promotes_a_replaced_entry_point(upd):
    """Replacing the entry point's slot promotes the first node of the top
    remaining level; no row keeps an edge to a severed slot that the
    re-insert did not make."""
    d, _ = upd
    h = _load(d, 0)
    entry = int(h.graph.entry)
    rng = np.random.default_rng(1)
    slots = np.array([entry, 5, 17], np.int64)
    h.replace_points(slots, rng.standard_normal((3, 24)).astype(np.float32))
    new_entry = int(h.graph.entry)
    assert h.levels[new_entry] == h.levels[:h.graph.n].max()
    assert new_entry == int(np.nonzero(h.levels == h.levels.max())[0][0])
    h.check_integrity()


def test_compact_rows_matches_jax():
    rng = np.random.default_rng(2)
    a = rng.integers(-1, 30, (200, 12)).astype(np.int32)
    a[rng.random(a.shape) < 0.4] = -1
    np.testing.assert_array_equal(tb._compact_rows(a), jhnsw._compact_rows(a))


def test_checkpoints_of_a_padded_index_keep_the_logical_count(upd, tmp_path):
    """save_hnsw / save_slim of a capacity-padded index write the logical
    index; load_hnsw / load_slim give back n, the rows and the vectors, and
    the JAX loader reads the same file to the same graph."""
    from hnsw_slim_tpu.persist.checkpoint import load_hnsw as jax_load_hnsw
    from hnsw_slim_tpu_torch.config import SlimConfig
    from hnsw_slim_tpu_torch.graph.types import pad_chal_nodes
    from hnsw_slim_tpu_torch.index.slim import HnswSlimIndex

    d, _ = upd
    h = _load(d, 0)
    h.add_points(update_dataset()[1][0])
    n = h.graph.n
    assert h.graph.level.shape[0] == 16384 and n == 2500 + UPD_ADD
    save_hnsw(tmp_path / "h.npz", h)
    h2 = load_hnsw(tmp_path / "h.npz", device="cpu")
    jh = jax_load_hnsw(tmp_path / "h.npz")
    assert h2.graph.n == n == jh.graph.n and h2.graph.level.shape[0] == n
    for l, a in enumerate(h.graph.adjs):
        np.testing.assert_array_equal(h2.graph.adjs[l].numpy(),
                                      a.numpy()[:n])
        np.testing.assert_array_equal(np.asarray(jh.graph.adjs[l]),
                                      a.numpy()[:n])
        np.testing.assert_array_equal(h2.host_adj()[l], a.numpy()[:n])
    np.testing.assert_array_equal(h2.vectors.numpy(), h.vectors.numpy()[:n])
    s = HnswSlimIndex.from_hnsw(h, SlimConfig(top_M0=10, low_m0=4, top_M=6,
                                              low_m=3))
    assert s.graph.n == n
    s.graph = pad_chal_nodes(s.graph, 4096)
    save_slim(tmp_path / "s.npz", s)
    s2 = load_slim(tmp_path / "s.npz", device="cpu")
    assert s2.graph.n == n and s2.graph.level.shape[0] == n
    np.testing.assert_array_equal(s2.graph.lvl_off.numpy(),
                                  s.graph.lvl_off.numpy()[:n])
    q = update_dataset()[4]
    np.testing.assert_array_equal(s.search(q, 5)[1], s2.search(q, 5)[1])
