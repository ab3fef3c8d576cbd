"""Parity of the port's incremental conversions (graph/incremental.py
IncrementalSlim, IncrementalSlimZero on the plain Kγ) against the JAX
package, on identical inputs carried across as numpy.

The JAX package's run of the update path (torch_slice_util.jax_update_dir)
recorded, for each of its four steps (three add batches, one replace
batch), the vanilla graph its update() was given and its whole state after;
the port's object starts each step from the JAX state of the step before
(persist/checkpoint.incremental_from_state) and must land on the JAX state
of that step exactly: integer arrays throughout, tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_slim_tpu.graph import incremental as jinc
from hnsw_slim_tpu_torch.config import SlimConfig
from hnsw_slim_tpu_torch.graph import build as tb
from hnsw_slim_tpu_torch.graph import incremental as tinc
from hnsw_slim_tpu_torch.graph.prune import convert_to_slim, level_indegrees
from hnsw_slim_tpu_torch.graph.types import LevelGraph
from hnsw_slim_tpu_torch.index import hnsw as thnsw
from hnsw_slim_tpu_torch.ops.distance import sq_norms
from hnsw_slim_tpu_torch.persist.checkpoint import (incremental_from_state,
                                                    load_hnsw)
from hnsw_slim_tpu_torch.persist.patch import _level_rows, to_np
from torch_slice_util import (UPD_SLIM, UPD_STEPS, inc_state, jax_update_dir,
                              state_lists, take)

torch.set_num_threads(1)
SLIM = SlimConfig(**{k: getattr(UPD_SLIM, k) for k in (
    "top_M0", "low_m0", "top_M", "low_m")})


@pytest.fixture(scope="module")
def upd(tmp_path_factory):
    d = jax_update_dir(tmp_path_factory)
    with np.load(d / "rec.npz") as z:
        return d, {k: z[k] for k in z.files}


def step_inputs(d, rec, s):
    """What update() of step s was given: (adj by level, levels, entry,
    vectors, vn), the arrays capacity-padded as the JAX index held them;
    step 0 is the built index."""
    if s == 0:
        h = load_hnsw(d / "hnsw0.npz", device="cpu")
        return (h.host_adj(), h.levels, int(h.graph.entry), h.vectors, h.vn)
    lmax = int(rec[f"i{s}_lmax"])
    x = torch.from_numpy(rec[f"s{s}_vectors"])
    return ([rec[f"s{s}_adj{l}"] for l in range(lmax + 1)],
            rec[f"s{s}_levels"], int(rec[f"s{s}_entry"]), x, sq_norms(x))


def assert_state(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def canon(graph):
    c = to_np(graph)
    n = graph.n
    return [c["level"][:n]] + [
        _level_rows(c, l, n, graph.cap0 if l == 0 else graph.cap)
        for l in range(graph.max_level + 1)]


def fresh_convert(adj, levels, entry, x, vn):
    """The port's full convert_to_slim of the same vanilla graph."""
    n = int((levels >= 0).sum())
    lg = LevelGraph.from_numpy(adj, levels, entry=entry,
                               max_level=len(adj) - 1, device="cpu", n_real=n)
    return convert_to_slim(lg, x, vn, SLIM)


def assert_same_graph(a, b):
    assert (a.n, a.max_level, a.entry) == (b.n, b.max_level, b.entry)
    for l, (ra, rb) in enumerate(zip(canon(a), canon(b))):
        np.testing.assert_array_equal(ra, rb, err_msg=f"level {l - 1}")


def test_full_equals_convert_and_jax(upd):
    """IncrementalSlim.full on the JAX-built graph: every state array and
    the CHAL arrays equal JAX's full(), and the graph equals the port's
    convert_to_slim."""
    d, rec = upd
    args = step_inputs(d, rec, 0)
    inc = tinc.IncrementalSlim(SLIM)
    g = inc.full(*args)
    want = take(rec, "i0_")
    assert_state(inc_state(inc), want)
    np.testing.assert_array_equal(g.nbr.numpy(), want["chal_nbr"])
    assert_same_graph(g, fresh_convert(*args))
    assert len(inc.repair_keys) == 0  # insertion-built: no repair needed


@pytest.mark.parametrize("s", range(1, UPD_STEPS + 1))
def test_update_equals_jax_and_full_reconversion(upd, s):
    """update() of step s from the JAX state of step s-1 on the JAX inputs:
    CHAL arrays, changed ids and every state array equal JAX's (thr aside:
    the JAX object keeps full()'s), and the graph equals a fresh
    convert_to_slim of that vanilla graph. Steps 1-3 add 120 points, step 4
    reuses 60 slots with new levels."""
    d, rec = upd
    args = step_inputs(d, rec, s)
    inc, _ = incremental_from_state(
        state_lists(take(rec, f"i{s - 1}_")), SLIM, device="cpu")
    g, changed = inc.update(*args, touched=rec[f"s{s}_touched"],
                            level_changed=rec[f"s{s}_level_changed"])
    want = take(rec, f"i{s}_")
    np.testing.assert_array_equal(changed, want.pop("changed"))
    got = inc_state(inc)
    got.pop("thr"), want.pop("thr")
    assert_state(got, want)
    assert_same_graph(g, fresh_convert(*args))
    assert len(changed) >= 60
    sizes = inc.last_stats["sizes"]
    assert sizes["L0"]["stage2"] >= sizes["L0"]["stages45"] > 0


def test_update_chain_from_own_full_equals_jax(upd):
    """The port's own full() and then its four updates in a row, host-only
    packing on the way: the final state equals JAX's after its four."""
    d, rec = upd
    inc = tinc.IncrementalSlim(SLIM)
    inc.full(*step_inputs(d, rec, 0))
    for s in range(1, UPD_STEPS + 1):
        g, _ = inc.update(*step_inputs(d, rec, s),
                          touched=rec[f"s{s}_touched"],
                          level_changed=rec[f"s{s}_level_changed"],
                          device_pack=False)
        assert g.nbr.device.type == "cpu"
    got, want = inc_state(inc), take(rec, f"i{UPD_STEPS}_")
    want.pop("changed"), got.pop("thr"), want.pop("thr")
    assert_state(got, want)


def test_update_preserves_repair_bridges():
    """The repair-bridge case of tests/test_incremental.py: two far islands,
    6-NN inside each; full() bridges them and update() keeps the bridges
    when every bridge endpoint is touched. Same repair keys as JAX."""
    rng = np.random.default_rng(11)
    half, dim = 150, 8
    n = 2 * half
    base = np.concatenate([
        rng.standard_normal((half, dim)),
        rng.standard_normal((half, dim)) + 100.0]).astype(np.float32)
    rows = np.full((n, 12), -1, np.int32)
    for s in (slice(0, half), slice(half, n)):
        dd = ((base[s, None] - base[None, s]) ** 2).sum(-1)
        np.fill_diagonal(dd, np.inf)
        rows[s, :6] = np.argsort(dd, axis=1)[:, :6] + s.start
    levels = np.zeros(n, np.int32)
    x = torch.from_numpy(base)
    inc = tinc.IncrementalSlim(SLIM)
    g = inc.full([rows], levels, 0, x, sq_norms(x))
    assert len(inc.repair_keys) > 0

    def n_components(graph):
        r = _level_rows(to_np(graph), 0, graph.n, graph.cap0)
        return len(np.unique(tb._components(r)))

    assert n_components(g) == 1
    ji = jinc.IncrementalSlim(UPD_SLIM)
    jx = jnp.asarray(base)
    ji.full([rows], levels, 0, jx, jnp.sum(jx * jx, axis=1))
    np.testing.assert_array_equal(inc.repair_keys, ji.repair_keys)
    srcs = np.unique(inc.repair_keys >> np.int64(31))
    g2, _ = inc.update([rows], levels, 0, x, sq_norms(x), touched=srcs)
    assert n_components(g2) == 1, "update dropped the repair bridges"


def test_update_with_a_new_top_level(upd, monkeypatch):
    """An add batch whose first point draws a level above the graph's:
    update() grows its per-level state and equals both a fresh
    convert_to_slim and the JAX update on the same inputs."""
    d, rec = upd
    h = load_hnsw(d / "hnsw0.npz", device="cpu")
    lmax = h.graph.max_level
    inc = tinc.IncrementalSlim(SLIM)
    inc.full(h.host_adj(), h.levels, int(h.graph.entry), h.vectors, h.vn)
    real = thnsw.sample_levels

    def raised(n, mult, seed, cap=12):
        lv = real(n, mult, seed, cap)
        lv[0] = lmax + 1
        return lv

    monkeypatch.setattr(thnsw, "sample_levels", raised)
    rng = np.random.default_rng(4)
    touched = h.add_points(rng.standard_normal((40, 24)).astype(np.float32))
    assert h.graph.max_level == lmax + 1 and int(h.graph.entry) == 2500
    args = (h.host_adj(), h.levels, int(h.graph.entry), h.vectors, h.vn)
    g, changed = inc.update(*args, touched=touched)
    assert inc.lmax == lmax + 1 and g.max_level == lmax + 1
    assert_same_graph(g, fresh_convert(*args))
    ji = jinc.IncrementalSlim(UPD_SLIM)
    st = state_lists(take(rec, "i0_"))
    for k, v in st.items():
        setattr(ji, k, [np.array(a) for a in v] if isinstance(v, list)
                else (int(v) if k in ("entry", "lmax") else np.array(v)))
    ji.caps, ji.out_ws = list(st["caps"]), list(st["out_ws"])
    jx = jnp.asarray(h.vectors.numpy())
    _, jchanged = ji.update(args[0], args[1], args[2], jx,
                            jnp.sum(jx * jx, axis=1), touched=touched)
    np.testing.assert_array_equal(changed, jchanged)
    got, want = inc_state(inc), inc_state(ji)
    got.pop("thr"), want.pop("thr")
    assert_state(got, want)


def zero_invariants(inc, adj, levels, cfg):
    """SlimZero's invariants on the state's final rows: degree within the
    cap, the hierarchy rule above the threshold level, ids in range, and
    the in-degree floor min(floor, donor in-degree) on >= 99.5% of the
    active nodes of each level."""
    n = len(levels)
    donor = level_indegrees(adj, levels)
    for l, fin in enumerate(inc.final):
        act = levels >= l
        assert ((fin >= 0).sum(1) <= inc.caps[l]).all()
        assert not (fin[~act] >= 0).any()
        ids = fin[fin >= 0]
        assert ids.max(initial=0) < n and (levels[ids] >= l).all()
        if l != cfg.threshold_level:
            assert (levels[ids] == l).all()
        live = np.bincount(ids, minlength=n)
        m_rev = cfg.min_indegree0 if l == 0 else cfg.min_indegree
        who = act if l == cfg.threshold_level else levels == l
        ok = live[who] >= np.minimum(donor[l][who], m_rev)
        assert not len(ok) or ok.mean() >= 0.995, (l, ok.mean())


def test_slimzero_full_equals_jax(upd):
    """IncrementalSlimZero.full: final rows, budgets, thresholds and CHAL
    arrays equal JAX's; the invariants hold."""
    d, rec = upd
    args = step_inputs(d, rec, 0)
    z = tinc.IncrementalSlimZero(SLIM)
    z.full(*args)
    assert_state(inc_state(z, True), take(rec, "z0_"))
    zero_invariants(z, args[0], np.asarray(args[1]), SLIM)


@pytest.mark.parametrize("s", range(1, UPD_STEPS + 1))
def test_slimzero_update_equals_jax(upd, s):
    """IncrementalSlimZero.update of step s from the JAX state of step s-1
    on the JAX inputs: state, CHAL arrays and changed ids equal JAX's, and
    floor, cap and hierarchy hold on the result."""
    d, rec = upd
    args = step_inputs(d, rec, s)
    z, _ = incremental_from_state(
        state_lists(take(rec, f"z{s - 1}_"), True), SLIM, zero=True,
        device="cpu")
    _, changed = z.update(*args, touched=rec[f"s{s}_touched"],
                          level_changed=rec[f"s{s}_level_changed"])
    want = take(rec, f"z{s}_")
    np.testing.assert_array_equal(changed, want.pop("changed"))
    assert_state(inc_state(z, True), want)
    zero_invariants(z, args[0], np.asarray(args[1]), SLIM)
    assert z.last_stats["changed"] == len(changed)
