"""Serving parity at ef=32: a Slim graph built and saved by the JAX package,
loaded through the port's load_slim, searched by both engines (kernel Kβ's
plain version on the CPU, seeds from Kα's) at the same knobs. Checks and
tolerances: torch_slice_util.check_search_parity. ef=64 and ef=320 are in
test_torch_search_ef64.py and test_torch_search_ef320.py."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_slice_util import check_search_parity, search_engines

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    return search_engines(tmp_path_factory)


@pytest.mark.parametrize("pop", [1, 8, 16])
@pytest.mark.parametrize("scan", [0, 96])
def test_search_matches_jax(engines, pop, scan):
    check_search_parity(engines, 32, pop, scan)


def test_slim_checkpoint_roundtrips_through_jax(engines, tmp_path):
    """The port's save_slim writes the JAX file format: JAX's load_slim reads
    back the same graph and vectors."""
    from hnsw_slim_tpu.persist.checkpoint import load_slim as jax_load_slim
    from hnsw_slim_tpu_torch.persist.checkpoint import save_slim

    js, ps, _, _ = engines
    save_slim(tmp_path / "p.npz", ps)
    back = jax_load_slim(tmp_path / "p.npz")
    for name in ("nbr", "lvl_off", "level"):
        np.testing.assert_array_equal(np.asarray(getattr(back.graph, name)),
                                      np.asarray(getattr(js.graph, name)))
    assert (back.graph.entry, back.graph.max_level, back.graph.cap0) == (
        js.graph.entry, js.graph.max_level, js.graph.cap0)
    np.testing.assert_array_equal(np.asarray(back.vectors),
                                  np.asarray(js.vectors))
    assert ps.index_size() == js.index_size()


def test_search_knobs_outside_the_slice_raise(engines):
    """Knobs beside the exact-seeded configuration: seed_width=0 (greedy
    descent, Kε) returns the JAX engine's ids (>= 99% of slots, hops equal)
    and a filter_mask returns allowed ids only, equal to JAX's. What the
    port does not serve, dynamic_ef, raises and says so."""
    js, ps, queries, _ = engines
    for idx in (js, ps):
        idx.scfg = dataclasses.replace(idx.scfg, ef=32, pop_width=4,
                                       scan_width=0, seed_width=0)
    _, ji = js.search(queries, k=10)
    _, pi = ps.search(queries, k=10)
    assert (pi == ji).mean() >= 0.99
    assert ps.last_stats["hops"] == js.last_stats["hops"]
    for idx in (js, ps):
        idx.scfg = dataclasses.replace(idx.scfg, seed_width=32)
    mask = np.arange(ps.graph.n) % 3 != 0
    _, ji = js.search(queries, k=10, filter_mask=mask)
    _, pi = ps.search(queries, k=10, filter_mask=mask)
    assert (pi == ji).mean() >= 0.99
    assert (pi >= 0).all() and mask[pi].all()
    ps.scfg = dataclasses.replace(ps.scfg, dynamic_ef=True)
    with pytest.raises(NotImplementedError, match="dynamic_ef"):
        ps.search(queries, k=10)
    ps.scfg = dataclasses.replace(ps.scfg, dynamic_ef=False)


def test_seed_table_ids_are_jaxs(engines):
    """The seed table's ids (every level>=1 node, -1 padded to a power of
    two of at least 64) are the JAX package's, and ``up_count`` counts the
    real ones."""
    js, ps, _, _ = engines
    want = np.asarray(js._seed_table()[1])
    ps._up_for = None  # built anew
    np.testing.assert_array_equal(ps._seed_table()[2].numpy(), want)
    assert ps.up_count == int((want >= 0).sum()) and len(want) >= 64


def test_a_seeded_search_never_reads_the_entry(engines, monkeypatch):
    """With a seed table, chal_search seeds from Kα alone: it never takes
    the entry's distance (K1), and its results still match JAX's, strata
    or not; the greedy descent still starts from the entry."""
    from hnsw_slim_tpu_torch.graph import search as gs

    def entry_dist(*args, **kw):
        raise AssertionError("entry_dist on the seed-table path")

    monkeypatch.setattr(gs, "entry_dist", entry_dist)
    check_search_parity(engines, 32, 8, 0)
    _, ps, queries, _ = engines
    ps.scfg = dataclasses.replace(ps.scfg, seed_strata=4)
    ps.search(queries, k=10)
    ps.scfg = dataclasses.replace(ps.scfg, seed_strata=0, seed_width=0)
    with pytest.raises(AssertionError, match="seed-table path"):
        ps.search(queries, k=10)


def test_buffer_width_is_the_jax_engines():
    """The Slim chains' buffer width at every ef up to 512 is the JAX
    engine's: ef, or from 256 up, where ef is not a bitonic width, its
    rounding up."""
    from hnsw_slim_tpu.graph import search as jgs
    from hnsw_slim_tpu_torch.graph import search as gs

    for ef in range(1, 513):
        want = jgs.bitonic_buffer_width(ef) if ef >= 256 and \
            not jgs._is_bitonic_width(ef) else ef
        assert gs.buffer_width(ef) == want, ef
