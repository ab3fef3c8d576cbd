"""Label-filtered Slim search (``HnswSlimIndex.set_tags`` and
``search(need=)``: Kβ's tag mode on its plain version), on the CPU.

The tag mode is held to the allow-list path (``filter_mask``), which
``test_torch_filter.py`` holds to the JAX package: where every query of a
batch has one need word, ids, distances, hops and dcomp are bit-equal to a
``filter_mask`` call with the mask (tags & need) == need; in a batch of
mixed predicates each row is bit-equal to its query searched alone under its
own mask. Besides: the per-query iteration cap is the per-call formula of
the query's own share, the answers against the plain reference
(``tests/plain_filtered.py``, which the benchmark's copy must equal), the
arguments refused, and the counters recorded under a profiler only."""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import plain_filtered as pf
from hnsw_slim_tpu_torch.config import HnswConfig, SearchConfig, SlimConfig
from hnsw_slim_tpu_torch.graph import search as gs
from hnsw_slim_tpu_torch.index.hnsw import (HnswIndex, filter_iters,
                                            share_iters)
from hnsw_slim_tpu_torch.index.slim import HnswSlimIndex
from hnsw_slim_tpu_torch.utils import trace
from hnsw_slim_tpu_torch.utils.data import clustered

torch.set_num_threads(1)

N, LABELS = 3000, 12
SEEDED = SearchConfig(ef=64, pop_width=8, seed_width=32)
DESCENT = SearchConfig(ef=48, pop_width=4)


@pytest.fixture(scope="module")
def world():
    """A Slim index of clustered rows with its dense layouts, one-hot tags
    of 12 uniform labels, and queries with a uniform label each."""
    base, queries = clustered(n=N, dim=16, n_queries=96, seed=21,
                              n_clusters=30)
    h = HnswIndex(HnswConfig(M=16, ef_construction=64), device="cpu")
    h.build(base)
    idx = HnswSlimIndex.from_hnsw(h, SlimConfig.from_ratios())
    rng = np.random.default_rng(22)
    tags = (1 << rng.integers(0, LABELS, N)).astype(np.uint32)
    need = (1 << rng.integers(0, LABELS, len(queries))).astype(np.uint32)
    idx.set_tags(tags)
    return idx, base, queries, tags, need


def run(idx, q, **kw):
    """(d, ids, hops, dcomp) of one search as host arrays."""
    d, i = idx.search(q, 10, **kw)
    hops, dcomp = idx.__dict__["_last_stats"]
    return d, i, hops.numpy(), dcomp.numpy()


def assert_bits(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.array_equal(np.ascontiguousarray(g).view(np.int32),
                              np.ascontiguousarray(w).view(np.int32))


def mask_of(tags, word) -> np.ndarray:
    return (tags & np.uint32(word)) == np.uint32(word)


@pytest.mark.parametrize("scfg,layout", [
    (SEEDED, "dense"), (SEEDED, "chal"), (DESCENT, "dense")])
@pytest.mark.parametrize("word", [1 << 0, 1 << 7, (1 << 3) | (1 << 5), 0])
def test_one_need_word_is_the_mask_path(world, scfg, layout, word):
    idx, _, queries, tags, _ = world
    idx.scfg = scfg
    idx.dense0 = idx.dense_up = idx.rank_up = None
    if layout == "dense":
        idx.densify_level0()
        idx.densify_upper()
    need = np.full(len(queries), word, np.uint32)
    got = run(idx, queries, need=need)
    want = run(idx, queries, filter_mask=mask_of(tags, word))
    assert_bits(got, want)
    ids = got[1]
    assert mask_of(tags, word)[ids[ids >= 0]].all()


@pytest.mark.parametrize("scfg", [SEEDED, DESCENT])
def test_mixed_predicates_are_rows_searched_alone(world, scfg):
    """Ids, hops and dcomp of each row are its query's searched alone under
    its own mask. (On the CPU a product's summation order follows the
    batch's shape, so distances agree to rounding here; the card test holds
    them bit for bit.)"""
    idx, _, queries, tags, need = world
    idx.scfg = scfg
    got = run(idx, queries, need=need)
    for label in np.unique(need):
        rows = np.nonzero(need == label)[0]
        for sel in (rows, rows[:1]):
            want = run(idx, queries[sel], filter_mask=mask_of(tags, label))
            assert_bits([a[sel] for a in got[1:]], want[1:])
            assert np.allclose(got[0][sel], want[0], rtol=1e-5, atol=1e-5)


def test_iteration_cap_is_the_per_call_formula(world):
    idx, _, _, tags, _ = world
    idx.scfg = SEEDED
    rng = np.random.default_rng(5)
    for share in (0.0, 0.01, 0.05, 1 / 12, 0.3, 0.5, 1.0):
        mask = rng.random(N) < share
        assert int(share_iters(26, mask.mean())) == filter_iters(26, mask)
    words = np.array([1, 1 << 11, 6, (1 << 31), 0, 1 << 11], np.uint32)
    caps = idx._need_iters(words)
    assert caps.dtype == np.int32
    assert caps.tolist() == [filter_iters(SEEDED.iters(), mask_of(tags, w))
                             for w in words]
    # no label 31 in the tags: the share floors at 5%
    assert caps[3] == int(SEEDED.iters() / 0.05) + 8


@pytest.mark.parametrize("ef", [128])
def test_answers_against_the_plain_reference(world, ef):
    """At ef 128 the tag mode finds >= 0.95 of the exact filtered top 10 of
    the plain reference, returns only ids its query's predicate allows,
    and the distances of those ids."""
    idx, base, queries, tags, need = world
    idx.scfg = SearchConfig(ef=ef, pop_width=8, seed_width=32)
    idx.densify_level0()
    idx.densify_upper()
    d, ids = idx.search(queries, 10, need=need)
    t, w = pf.words(tags), pf.words(need)
    x, q = torch.as_tensor(base), torch.as_tensor(queries)
    gd, gi = pf.filtered_topk(x, q, t, w, 10, x_block=1024)
    assert (gi >= 0).all()
    hits = sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(ids, gi.numpy()))
    assert hits / gi.numel() >= 0.95
    i = torch.as_tensor(ids)
    assert pf.filter_misses(t, w, i) == 0
    ok = i >= 0
    ref = ((x[i.clamp(min=0).long()] - q[:, None]) ** 2).sum(-1)
    assert torch.allclose(torch.as_tensor(d)[ok], ref[ok], rtol=1e-5,
                          atol=1e-4)


def test_plain_reference_pads_a_short_predicate():
    """Fewer allowed rows than k: those rows, then -1 at inf, in any block
    layout; an unmatched need word allows nothing."""
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal((50, 8)).astype(np.float32))
    q = x[:4] + 0.01
    tags = pf.words(np.where(np.arange(50) % 10 == 0, 3, 1))
    need = pf.words([2, 1, 2, 4])
    d, i = pf.filtered_topk(x, q, tags, need, 10, x_block=16)
    assert (i[0, :5] % 10 == 0).all() and (i[0, 5:] == -1).all()
    assert torch.isinf(d[0, 5:]).all() and torch.isfinite(d[0, :5]).all()
    assert (i[1] >= 0).all() and (i[3] == -1).all()
    d2, i2 = pf.filtered_topk(x, q, tags, need, 10)
    assert torch.equal(i, i2) and torch.equal(d, d2)
    assert pf.filter_misses(tags, need, i) == 0
    assert pf.filter_misses(tags, need, torch.full((4, 1), 1)) == 3


def test_the_benchmarks_copy_is_the_reference(world):
    bench = Path(__file__).resolve().parents[1] / "bench_torch"
    sys.path.insert(0, str(bench))
    try:
        copy = importlib.import_module("reference.filtered_knn")
    finally:
        sys.path.remove(str(bench))
    _, base, queries, tags, need = world
    x, q = torch.as_tensor(base), torch.as_tensor(queries)
    t, w = copy.words(tags), copy.words(need)
    assert torch.equal(t, pf.words(tags)) and torch.equal(w, pf.words(need))
    for tf32 in (False, True):
        a = copy.filtered_topk(x, q, t, w, 10, tf32=tf32, x_block=700)
        b = pf.filtered_topk(x, q, t, w, 10, tf32=tf32, x_block=700)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    ids = torch.as_tensor(np.random.default_rng(1).integers(-1, N, (96, 10)))
    assert copy.filter_misses(t, w, ids) == pf.filter_misses(t, w, ids) > 0


def test_arguments_are_checked(world):
    idx, _, queries, tags, need = world
    for bad in (tags[:-1], np.concatenate([tags, tags[:1]]),
                tags.astype(np.float32), tags.astype(np.int64) - 2,
                tags.astype(np.int64) << 32):
        with pytest.raises(ValueError, match="set_tags"):
            idx.set_tags(bad)
    with pytest.raises(ValueError, match="need words for"):
        idx.search(queries, 10, need=need[:-1])
    with pytest.raises(ValueError, match="not both"):
        idx.search(queries, 10, need=need, filter_mask=mask_of(tags, 1))
    fresh = HnswSlimIndex(device="cpu")
    fresh.graph, fresh.vectors = idx.graph, idx.vectors
    with pytest.raises(ValueError, match="set_tags first"):
        fresh.search(queries, 10, need=need)
    idx.set_tags(tags)  # the refused columns left the installed one
    assert np.array_equal(idx._tags_np, tags)


def test_tag_mode_of_the_plain_beam_is_its_allowed_mode():
    """Kβ's plain version: tags with one need word a row run the allowed
    mode's steps bit for bit, row by row, and count the scored candidates
    that pass."""
    rng = np.random.default_rng(9)
    x = torch.as_tensor(rng.standard_normal((400, 8)).astype(np.float32))
    q = torch.as_tensor(rng.standard_normal((6, 8)).astype(np.float32))
    rows = torch.as_tensor(rng.integers(-1, 400, (400, 12)).astype(np.int32))
    tags = pf.words(1 << rng.integers(0, 3, 400))
    need = pf.words(1 << rng.integers(0, 3, 6))
    sd = ((q - x[:1]) ** 2).sum(1, keepdim=True)
    si = torch.zeros((6, 1), dtype=torch.int32)
    qn = (q * q).sum(1)
    iters = torch.as_tensor([5, 9, 40, 40, 1, 0], dtype=torch.int32)
    kw = dict(P=16, ef_eff=16, pop_width=2, cw=24, k=10)
    trk = gs.filter_track_init(None, si[:, 0], sd[:, 0], 16, tags, need)
    got = gs.beam_search_plain(x, q, qn, rows, sd, si, max_iters=99,
                               track_d=trk[0], track_id=trk[1], iters=iters,
                               tags=tags, need=need, **kw)
    for r in range(6):
        allowed = (tags & need[r]) == need[r]
        t1 = gs.filter_track_init(allowed, si[r:r + 1, 0], sd[r:r + 1, 0],
                                  16)
        one = gs.beam_search_plain(
            x, q[r:r + 1], qn[r:r + 1], rows, sd[r:r + 1], si[r:r + 1],
            max_iters=int(iters[r]), allowed=allowed, track_d=t1[0],
            track_id=t1[1], **kw)
        for a, b in zip(got, one):
            assert torch.equal(a[r:r + 1], b)
    admit, dcomp = got[6], got[3]
    assert (admit <= dcomp).all() and admit.sum() > 0
    assert got[2][5] == 0 and got[2][4] <= 2  # caps of 0 and 1 iteration


def test_counters_and_span_are_recorded_under_a_profiler_only(world):
    idx, _, queries, tags, need = world
    idx.scfg = SEEDED
    trace.drain()
    run(idx, queries, need=need)
    idx.set_tags(tags)
    assert trace.drain() == {"spans": [], "counters": {}}
    with profile(activities=[ProfilerActivity.CPU]):
        idx.set_tags(tags)
        got = run(idx, queries, need=need)
        run(idx, queries, filter_mask=mask_of(tags, 2))
    rec = trace.drain()
    c = rec["counters"]
    assert [s.name for s in rec["spans"]].count("index.tags") == 1
    # the need words and caps are made inside the call's index.search span
    searches = {s.id for s in rec["spans"] if s.name == "index.search"}
    words = [s for s in rec["spans"] if s.name == "index.words"]
    assert len(words) == 1 and words[0].parent in searches
    assert c["index.filter_queries"] == len(queries)
    short = int((got[1][:, -1] < 0).sum())
    assert c["index.filter_short"] == short
    assert 0 < c["index.filter_admit"] <= c["index.beam_dcomp"]
