"""SlimQ's spans and counters (hnsw_slim_tpu_torch/utils/trace.py) on the
CPU, inside a torch.profiler session: the query rotation ``index.rotate``
nests in ``index.search`` between the upload and the seed scan, the
counter ``index.rerank_dcomp`` counts the rerank track's exact distances
(one a popped node: the beams' hops) and stays empty without the rerank,
and the build's steps are spans whose seconds are ``build_stats``'. The
counter ``index.quant_one_round`` counts the kernel launches whose code
rows arrive in one gather round (``quant/estimator.py gather_rounds``, the
host's count of the rounds): the CPU path launches none, so it is absent."""

import pytest
from torch.profiler import ProfilerActivity, profile

from hnsw_slim_tpu_torch.config import (HnswConfig, QuantConfig, SearchConfig,
                                        SlimConfig)
from hnsw_slim_tpu_torch.index.slimq import HnswSlimQIndex
from hnsw_slim_tpu_torch.quant import estimator as est
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


@pytest.mark.parametrize("nb,ex_bits,use_ex,rounds", [
    (4, 3, True, 1),    # P = 128, 1 + 3 bits: the whole 21-word row
    (4, 3, False, 1),   # its 1-bit estimate: the bin plane and the tail
    (4, 0, False, 1),   # a 1-bit code's row, 9 words
    (6, 3, True, 1),    # P = 192: 29 words
    (7, 3, True, 2),    # P = 224: 33 words, one past a round
    (8, 3, True, 2),    # P = 256: 37 words
    (30, 3, True, 4),   # P = 960: 125 words
    (32, 0, False, 2),  # P = 1024, a 1-bit code: 37 words
])
def test_gather_rounds_follow_the_words_an_estimate_reads(nb, ex_bits,
                                                          use_ex, rounds):
    assert est.gather_rounds(nb, ex_bits, use_ex) == rounds
    words = nb * (1 + ex_bits if use_ex else 1) + 5
    assert (rounds - 1) * est.ROUND_WORDS < words <= rounds * est.ROUND_WORDS
    sc = est.QuantScorer(None, nb, ex_bits, use_ex, None, None, None)
    assert sc.counters() == (
        ("index.quant_one_round",) if rounds == 1 else ())


def test_the_whole_code_rounds_follow_the_packed_stride(slimq):
    idx, _ = slimq
    nb, ex_bits = int(idx.codes.bin_code.shape[1]), int(idx.codes.ex_bits)
    stride = idx._packed_rows().shape[1]
    assert stride == nb * (1 + ex_bits) + 5
    assert est.gather_rounds(nb, ex_bits, True) == -(-stride
                                                    // est.ROUND_WORDS)


@pytest.mark.parametrize("seed_width,use_ex", [(16, True), (0, False)])
def test_the_cpu_path_counts_no_gather_round(rec, slimq, seed_width,
                                             use_ex):
    """The CPU path runs the plain versions: no launch, so no
    ``index.quant_one_round``, beside the search's own counters."""
    idx, queries = slimq
    idx.scfg = SearchConfig(ef=32, pop_width=4, seed_width=seed_width,
                            use_ex=use_ex)
    try:
        with recorded():
            idx.search(queries, 10)
    finally:
        idx.scfg = SearchConfig(ef=32, pop_width=4, seed_width=16)
    c = rec.drain()["counters"]
    assert c["index.queries"] == len(queries) and c["index.beam_dcomp"] > 0
    assert "index.quant_one_round" not in c
