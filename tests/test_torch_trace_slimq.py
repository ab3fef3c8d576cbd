"""SlimQ's spans and counters (hnsw_slim_tpu_torch/utils/trace.py) on the
CPU, inside a torch.profiler session: the query rotation ``index.rotate``
nests in ``index.search`` between the upload and the seed scan, the
counter ``index.rerank_dcomp`` counts the rerank track's exact distances
(one a popped node: the beams' hops) and stays empty without the rerank,
and the build's steps are spans whose seconds are ``build_stats``'."""

import pytest
from torch.profiler import ProfilerActivity, profile

from hnsw_slim_tpu_torch.config import (HnswConfig, QuantConfig, SearchConfig,
                                        SlimConfig)
from hnsw_slim_tpu_torch.index.slimq import HnswSlimQIndex
from hnsw_slim_tpu_torch.utils import trace
from hnsw_slim_tpu_torch.utils.data import clustered

BUILD_STEPS = (("slimq.hnsw", "hnsw_s"), ("slimq.convert", "convert_s"),
               ("slimq.kmeans", "kmeans_s"), ("slimq.rotate", "rotate_s"),
               ("slimq.quantize", "quantize_s"))


@pytest.fixture
def rec():
    """The process recorder, emptied before and after the test."""
    trace.drain()
    yield trace
    trace.drain()


def recorded():
    """A CPU profiler session: the program records while it is open."""
    return profile(activities=[ProfilerActivity.CPU])


def _build(base):
    idx = HnswSlimQIndex.build(
        base, hnsw_cfg=HnswConfig(M=12, ef_construction=64),
        slim_cfg=SlimConfig.from_ratios(), quant_cfg=QuantConfig(),
        device="cpu")
    idx.densify_level0()
    idx.densify_upper()
    idx.scfg = SearchConfig(ef=32, pop_width=4, seed_width=16)
    return idx


@pytest.fixture(scope="module")
def slimq():
    base, queries = clustered(n=2000, dim=16, n_queries=48, seed=63)
    return _build(base), queries


def test_rotate_nests_in_search_and_the_rerank_is_counted(rec, slimq):
    idx, queries = slimq
    with recorded():
        idx.search(queries, 10)
    got = rec.drain()
    spans = {s.name: s for s in got["spans"]}
    search = spans["index.search"]
    for name in ("index.upload", "index.rotate", "index.seed", "index.beam",
                 "index.readback"):
        assert spans[name].parent == search.id, name
    assert (spans["index.upload"].end <= spans["index.rotate"].start
            <= spans["index.rotate"].end <= spans["index.seed"].start)
    c = got["counters"]
    assert c["index.queries"] == len(queries)
    assert c["index.rerank_dcomp"] > 0
    assert c["index.rerank_dcomp"] == idx.last_stats["hops"]


def test_no_rerank_counts_no_rerank_distance(rec, slimq):
    idx, queries = slimq
    with recorded():
        idx.search(queries, 10, rerank=False)
    got = rec.drain()
    assert "index.rotate" in {s.name for s in got["spans"]}
    assert got["counters"].get("index.rerank_dcomp", 0) == 0
    assert got["counters"]["index.beam_dcomp"] > 0


def test_off_the_search_records_nothing(rec, slimq):
    idx, queries = slimq
    idx.search(queries, 10)
    assert rec.drain() == {"spans": [], "counters": {}}


def test_build_steps_are_spans_with_build_stats_seconds(rec):
    base, _ = clustered(n=1500, dim=16, n_queries=0, seed=64)
    with recorded():
        idx = _build(base)
    spans = [s for s in rec.drain()["spans"]
             if s.name.startswith("slimq.")]
    assert [s.name for s in spans] == [name for name, _ in BUILD_STEPS]
    assert set(idx.build_stats) == {key for _, key in BUILD_STEPS}
    for s, (_, key) in zip(spans, BUILD_STEPS):
        assert idx.build_stats[key] == pytest.approx((s.end - s.start) / 1e9)
    for a, b in zip(spans, spans[1:]):
        assert a.end <= b.start
    # off, the same keys are timed and nothing is recorded
    assert set(_build(base).build_stats) == set(idx.build_stats)
    assert rec.drain() == {"spans": [], "counters": {}}
