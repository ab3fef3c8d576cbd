"""The index host path's CUDA graph replay (hnsw_slim_tpu_torch/index/replay.py).

On the CPU: the rules that decide when a search replays (the padded rows
of a batch, the key follows every tensor and scalar the chain reads, a key
is captured on its second sighting, at most ``SLOTS`` graphs, a CPU device,
an allow-list or per-query entries stay eager, a busy replay sends the
caller eager), the counters' and launch counts' diversion under a capture
and their count after a replay, and the wiring of both indexes' ``search``
through a stand-in graph that runs the padded chain eagerly.

Marked ``cuda``, each skipping without a card: a replayed ``search`` of a
Slim and a SlimQ index gives the eager chain's bits (d, ids, hops, dcomp)
over calls of one shape with other queries, over calls of sizes padded to
one graph, and after ``set_ef``, new dense layouts and a client's patch
that grows the index; its results and ``last_stats`` outlive the next
call; a traced replay counts what the eager chain counts, and a replay
adds the kernel launch counts an eager call of its size adds; and the
kernels of a replay appear in the device trace under their own names,
captured inside a profiled window or before it.
The machine with the card has no JAX, so run these without the suite's
conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_replay.py
"""

import json
import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hnsw_slim_tpu_torch.config import (HnswConfig, QuantConfig, SearchConfig,
                                        SlimConfig)
from hnsw_slim_tpu_torch.index import replay
from hnsw_slim_tpu_torch.index.slim import HnswSlimIndex
from hnsw_slim_tpu_torch.index.slimq import HnswSlimQIndex
from hnsw_slim_tpu_torch.ops import cuda
from hnsw_slim_tpu_torch.utils import trace
from hnsw_slim_tpu_torch.utils.data import clustered


@pytest.fixture
def rec():
    """The process recorder, emptied before and after the test."""
    trace.drain()
    yield trace
    trace.drain()


def recorded(*acts):
    """A profiler session (CPU activity unless given): the program records
    its spans and counters while it is open."""
    return profile(activities=list(acts) or [ProfilerActivity.CPU])


def host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def eager(idx, q, k, **kw):
    """The eager chain's (d, ids, hops, dcomp) as host arrays:
    ``search_async`` never replays."""
    d, i, h, c = idx.search_async(q, k, **kw)
    return host(d[:, :k]), host(i[:, :k]), host(h), host(c)


def searched(idx, q, k, **kw):
    """``search``'s (d, ids, hops, dcomp) as host arrays, the stats as it
    stored them."""
    d, i = idx.search(q, k, **kw)
    hops, dcomp = idx.__dict__["_last_stats"]
    return d, i, host(hops), host(dcomp)


def assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g.view(np.int32), w.view(np.int32))


# ---- the rules, on the CPU

A, B = torch.zeros(8, 4), torch.zeros(8, 4)
READS = dict(nbr=A, dense_up=(A, A), dense0=None, entry=3, max_level=2,
             k=10, ef=64, metric="l2")
CHANGED = {
    "another tensor": dict(READS, nbr=B),
    "a shorter view": dict(READS, nbr=A[:4]),
    "other strides": dict(READS, nbr=A.t()),
    "another dtype": dict(READS, nbr=A.double()),
    "a layout in a tuple": dict(READS, dense_up=(A, B)),
    "a layout added": dict(READS, dense0=A),
    "entry": dict(READS, entry=4),
    "max_level": dict(READS, max_level=3),
    "k": dict(READS, k=5),
    "ef": dict(READS, ef=32),
}


@pytest.mark.parametrize("b,want", [
    (1, 1), (2, 2), (3, 4), (5, 8), (33, 64), (64, 64), (65, 128),
    (1000, 1024), (1024, 1024), (1025, 1152), (1152, 1152), (1153, 1280),
    (2049, 2304), (4096, 4096), (4097, 4608), (30000, 30720),
])
def test_rows_a_batch_is_padded_to(b, want):
    assert replay.rows(b) == want


def test_padding_is_bounded_and_few_sizes_share_a_graph():
    sizes = [replay.rows(b) for b in range(1, 40000)]
    assert all(b <= r < 2 * b for b, r in enumerate(sizes, 1))
    assert all(r < 1.125 * b for b, r in enumerate(sizes, 1)
               if b > replay.FINE)
    assert sizes == sorted(sizes)
    assert all(replay.rows(r) == r for r in set(sizes))
    # a batcher's 1 to 64 rows: seven graphs; every padded size up to FINE
    # rows fits the graphs kept
    assert len(set(sizes[:64])) == 7
    assert len(set(sizes[:replay.FINE])) <= replay.SLOTS


def test_key_is_stable_and_hashable():
    k0 = replay.key((16, 4), READS)
    assert replay.key((16, 4), dict(READS)) == k0
    assert hash(k0) == hash(replay.key((16, 4), dict(READS)))
    assert replay.key((8, 4), READS) != k0


@pytest.mark.parametrize("what", sorted(CHANGED))
def test_key_follows_every_read(what):
    assert replay.key((16, 4), CHANGED[what]) != replay.key((16, 4), READS)


def test_a_key_is_captured_on_its_second_sighting():
    r = replay.Replay()
    assert [r.sight("a"), r.sight("b"), r.sight("a")] == [
        "eager", "eager", "capture"]
    r.keep("a", object())
    assert [r.sight("a"), r.sight("a"), r.sight("b")] == [
        "replay", "replay", "capture"]


def test_graphs_are_bounded_least_recently_used_first():
    r = replay.Replay()
    for i in range(replay.SLOTS):
        r.keep(i, i)
    assert r.sight(0) == "replay"  # 0 is now the most recently used
    r.keep(replay.SLOTS, replay.SLOTS)
    assert list(r._graphs) == [*range(2, replay.SLOTS), 0, replay.SLOTS]
    assert r.sight(1) == "eager"


def test_sightings_are_bounded():
    r = replay.Replay()
    for i in range(replay.SLOTS + 1):
        assert r.sight(i) == "eager"
    assert r.sight(0) == "eager"  # forgotten: the oldest of SLOTS + 1
    assert r.sight(replay.SLOTS) == "capture"


@pytest.mark.parametrize("device,batch,per_call,want", [
    ("cpu", 4, (None, None), False),
    ("cuda", 4, (None, None), True),
    ("cuda", 4, (np.ones(9, bool), None), False),
    ("cuda", 4, (None, np.zeros(4, np.int32)), False),
    ("cuda", 0, (None, None), False),
])
def test_what_engages(device, batch, per_call, want):
    assert replay.engages(torch.device(device), batch, *per_call) is want


def test_a_busy_replay_sends_the_caller_eager():
    r = replay.Replay()
    r._lock.acquire()
    try:
        assert r.search(("k",), np.zeros((2, 4), np.float32), 1, None,
                        "cpu") is None
    finally:
        r._lock.release()
    # the busy call left no sighting
    assert r.sight(replay.key((2, 4), "k")) == "eager"


def test_counts_are_diverted_while_captured(rec):
    dev = torch.ones(3, dtype=torch.int32)
    other = threading.Thread(target=trace.count, args=("other", 5))
    with recorded():
        with trace.diverted() as sink:
            trace.count("index.queries", 3)
            trace.count("index.beam_dcomp", dev)
            other.start()
            other.join(timeout=30)
        trace.count("after", 1)
    assert not other.is_alive()
    assert [n for n, _ in sink] == ["index.queries", "index.beam_dcomp"]
    assert sink[1][1] is dev
    assert rec.drain()["counters"] == {"other": 5, "after": 1}
    with trace.diverted() as sink:  # collected when not recording too
        trace.count("index.queries", 2)
    assert sink == [("index.queries", 2)]


@pytest.fixture
def fake_launch(monkeypatch):
    """``cuda.launch`` without the library or a card: a stand-in entry
    point that returns no error, on a stream of 0."""
    monkeypatch.setitem(cuda._FN, "fake", lambda *args: 0)
    monkeypatch.setattr(cuda, "_raw_stream", lambda dev: 0)
    monkeypatch.setattr(cuda, "_device", lambda: None)
    before = (dict(cuda.launches), dict(cuda.launch_shapes))
    yield
    cuda.launches.clear()
    cuda.launches.update(before[0])
    cuda.launch_shapes.clear()
    cuda.launch_shapes.update(before[1])


def test_launches_are_held_while_captured_and_counted_after(fake_launch):
    cuda.reset_launches()
    other = threading.Thread(target=cuda.launch, args=("beam_search",),
                             kwargs=dict(entry="fake"))
    with cuda.held() as calls:
        cuda.launch("topk_dist", entry="fake", modes=("k128",), shape="L k10")
        cuda.launch("beam_search", entry="fake", shape="E8 ef64 S32")
        other.start()
        other.join(timeout=30)
    assert calls == [("topk_dist", ("k128",), "L k10"),
                     ("beam_search", (), "E8 ef64 S32")]
    assert cuda.launches["topk_dist"] == 0 and not cuda.launch_shapes
    assert cuda.launches["beam_search"] == 1  # the other thread's
    with cuda.tagged("serve"):
        cuda.counted(calls)
        cuda.counted(calls)
    assert (cuda.launches["topk_dist"], cuda.launches["topk_dist.k128"],
            cuda.launches["beam_search"]) == (2, 2, 3)
    assert cuda.launch_shapes == {"topk_dist[serve] L k10": 2,
                                  "beam_search[serve] E8 ef64 S32": 2}


def test_counts_of_a_replay_are_of_its_rows(rec, fake_launch):
    dc = torch.arange(8, dtype=torch.int32)
    counts = replay.per_row([("index.queries", 8), ("index.beam_dcomp", dc)],
                            8)
    assert counts == [("index.queries", 1), ("index.beam_dcomp", dc)]
    with pytest.raises(ValueError, match="index.total"):
        replay.per_row([("index.total", 12)], 8)
    with pytest.raises(ValueError, match="index.beam_dcomp"):
        replay.per_row([("index.beam_dcomp", dc[:4])], 8)
    cuda.reset_launches()
    with recorded():
        replay.recount(counts, [("beam_search", (), "")], 5)
    assert rec.drain()["counters"] == {
        "index.queries": 5, "index.beam_dcomp": 10, "index.replays": 1}
    assert cuda.launches["beam_search"] == 1


# ---- the wiring of search, on the CPU, through a stand-in graph


class EagerGraph:
    """Stands in for a captured graph on the CPU: its input padded as
    ``_Graph``'s, each replay runs the chain on it, its counts and
    launches held back and then counted as ``_Graph.run`` counts them."""

    def __init__(self, queries, shape, width, chain, device):
        self.chain, self.width = chain, width
        self.inp = torch.from_numpy(queries[np.arange(shape[0])
                                            % len(queries)])

    def run(self, queries):
        b, w = len(queries), self.width
        self.inp[:b] = torch.from_numpy(queries)
        with trace.diverted() as counts, cuda.held() as launched:
            d, i, h, c = self.chain(self.inp.clone())
        replay.recount(replay.per_row(counts, len(self.inp)), launched, b)
        return (d[:b, :w].numpy().copy(), i[:b, :w].numpy().copy(),
                h[:b].numpy().copy(), c[:b].numpy().copy())


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(replay, "_Graph", EagerGraph)
    monkeypatch.setattr(replay, "engages",
                        lambda device, batch, *per_call: all(
                            a is None for a in per_call))


CFG = HnswConfig(M=12, ef_construction=64)


@pytest.fixture(scope="module")
def cpu_indexes():
    base, queries = clustered(n=1500, dim=16, n_queries=96, seed=71)
    slim = HnswSlimIndex.build(base, hnsw_cfg=CFG, device="cpu")
    slim.scfg = SearchConfig(ef=32, pop_width=4, seed_width=16)
    slimq = HnswSlimQIndex.build(
        base, hnsw_cfg=CFG, slim_cfg=SlimConfig.from_ratios(),
        quant_cfg=QuantConfig(), device="cpu")
    slimq.scfg = SearchConfig(ef=32, pop_width=4, seed_width=16, use_ex=True)
    return {"slim": slim, "slimq": slimq}, queries


@pytest.mark.parametrize("kind", ["slim", "slimq"])
def test_search_wires_the_chain_through_the_replay(rec, stand_in,
                                                   cpu_indexes, kind):
    idxs, queries = cpu_indexes
    idx = idxs[kind]
    idx._replay = replay.Replay()
    # 20 to 32 rows: one padded size
    batches = [queries[:20], queries[20:52], queries[52:79]]
    with recorded():
        for q in batches:
            assert_same(searched(idx, q, 10), eager(idx, q, 10))
        idx.set_ef(24)  # a new key: eager, then captured
        for q in batches[:2]:
            assert_same(searched(idx, q, 10), eager(idx, q, 10))
    c = rec.drain()["counters"]
    assert (c["index.captures"], c["index.replays"]) == (2, 3)
    idx.set_ef(32)
    with recorded():
        searched(idx, batches[0], 10)
    got = rec.drain()
    with recorded():
        eager(idx, batches[0], 10)
    want = rec.drain()
    names = ["index.queries", "index.beam_dcomp"] + (
        ["index.rerank_dcomp"] if kind == "slimq" else [])
    assert got["counters"]["index.replays"] == 1
    assert all(got["counters"][n] == want["counters"][n] for n in names)


def test_filtered_and_entry_searches_stay_eager(rec, stand_in, cpu_indexes):
    idxs, queries = cpu_indexes
    idx = idxs["slim"]
    idx._replay = replay.Replay()
    mask = np.ones(idx.graph.n, bool)
    entry = np.full(32, idx.graph.entry, np.int32)
    with recorded():
        for _ in range(3):
            idx.search(queries[:32], 10, filter_mask=mask)
            idx.search(queries[:32], 10, entry=entry)
    assert "index.replays" not in rec.drain()["counters"]
    assert not idx._replay._seen and not idx._replay._graphs


def test_a_cpu_index_never_replays(cpu_indexes):
    idxs, queries = cpu_indexes
    for idx in idxs.values():
        idx._replay = replay.Replay()
        for _ in range(3):
            idx.search(queries[:32], 10)
        assert not idx._replay._seen and not idx._replay._graphs


# ---- on the card


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    base, q = clustered(20000, 128, n_queries=1024, n_clusters=40, seed=7,
                        scale=0.3)
    return base, q


SLIM_CFGS = {
    "seeded": SearchConfig(ef=64, pop_width=8, seed_width=32),
    "descent": SearchConfig(ef=64, pop_width=4),
    "strata": SearchConfig(ef=320, pop_width=16, scan_width=96,
                           seed_width=32, seed_strata=4),
}
SLIMQ_CFGS = {
    "whole code": (SearchConfig(ef=128, pop_width=8, seed_width=32,
                                use_ex=True), True),
    "1-bit descent": (SearchConfig(ef=64, pop_width=4), True),
    "no rerank": (SearchConfig(ef=64, pop_width=8, seed_width=32), False),
}


def _slim(base):
    from hnsw_slim_tpu_torch.index.hnsw import HnswIndex

    h = HnswIndex(HnswConfig(M=16, ef_construction=64), strategy="nnd",
                  device="cuda")
    h.build(base)
    return HnswSlimIndex.from_hnsw(h, SlimConfig.from_ratios())


@pytest.fixture(scope="module")
def slim_card(card):
    idx = _slim(card[0])
    idx.densify_level0()
    idx.densify_upper()
    return idx


@pytest.fixture(scope="module")
def slimq_card(card):
    idx = HnswSlimQIndex.build(
        card[0], hnsw_cfg=HnswConfig(M=16, ef_construction=64),
        quant_cfg=QuantConfig(total_bits=4), device="cuda")
    idx.densify_level0()
    idx.densify_upper()
    return idx


def batches(q, n, rows=256):
    return [q[j * rows:(j + 1) * rows] for j in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SLIM_CFGS))
def test_slim_replay_is_bit_equal_on_card(rec, card, slim_card, name):
    idx = slim_card
    idx.scfg = SLIM_CFGS[name]
    with recorded():
        for q in batches(card[1], 4):
            assert_same(searched(idx, q, 10), eager(idx, q, 10))
    c = rec.drain()["counters"]
    assert (c["index.captures"], c["index.replays"]) == (1, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SLIMQ_CFGS))
def test_slimq_replay_is_bit_equal_on_card(rec, card, slimq_card, name):
    idx = slimq_card
    idx.scfg, rerank = SLIMQ_CFGS[name]
    with recorded():
        for q in batches(card[1], 4):
            assert_same(searched(idx, q, 10, rerank=rerank),
                        eager(idx, q, 10, rerank=rerank))
    c = rec.drain()["counters"]
    assert (c["index.captures"], c["index.replays"]) == (1, 3)


PADDED = [(3, 4, 3), (37, 64, 50), (65, 100, 128), (513, 1000, 777),
          (1100, 1152, 1025)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["slim", "slimq"])
def test_padded_replay_is_bit_equal_on_card(rec, card, slim_card, slimq_card,
                                            kind):
    idx = slim_card if kind == "slim" else slimq_card
    idx.scfg = SLIM_CFGS["seeded"] if kind == "slim" \
        else SLIMQ_CFGS["whole code"][0]
    idx._replay = replay.Replay()
    pool = np.concatenate([card[1], card[1][::-1]])
    with recorded():
        for sizes in PADDED:  # each one padded size: eager, capture, replay
            for j, b in enumerate(sizes):
                q = pool[7 * j:7 * j + b]
                assert_same(searched(idx, q, 10), eager(idx, q, 10))
    c = rec.drain()["counters"]
    assert (c["index.captures"], c["index.replays"]) == (5, 10)


def launch_counts(fn) -> tuple:
    """(launches, launch_shapes) that ``fn()`` adds."""
    cuda.reset_launches()
    fn()
    torch.cuda.synchronize()
    return dict(cuda.launches), dict(cuda.launch_shapes)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["slim", "slimq"])
def test_replay_counts_the_launches_of_its_size_on_card(card, slim_card,
                                                        slimq_card, kind):
    idx = slim_card if kind == "slim" else slimq_card
    idx.scfg = SLIM_CFGS["seeded"] if kind == "slim" \
        else SLIMQ_CFGS["whole code"][0]
    idx._replay = replay.Replay()
    q = card[1]
    first = launch_counts(lambda: idx.search(q[:100], 10))  # eager
    captured = launch_counts(lambda: idx.search(q[100:228], 10))
    replayed = launch_counts(lambda: idx.search(q[300:400], 10))
    want = launch_counts(lambda: eager(idx, q[500:628], 10))
    assert captured == replayed == want == first
    assert want[0]["beam_search"] >= 1 and want[0]["topk_dist"] >= 1


@pytest.mark.cuda
def test_replay_follows_the_index_as_it_changes_on_card(rec, card):
    from hnsw_slim_tpu_torch.serve.client import SlimClient
    from patch_cases import random_chunk

    idx = _slim(card[0])
    idx.scfg = SLIM_CFGS["seeded"]
    qs = batches(card[1], 2)

    def twice():
        for q in qs:
            assert_same(searched(idx, q, 10), eager(idx, q, 10))

    g = idx.graph
    view = types.SimpleNamespace(n=g.n, level=g.level.cpu(), cap0=g.cap0,
                                 cap=g.cap, max_level=g.max_level)
    chunk = random_chunk(view, 5, n_old=40, n_new=300, n_reused=0, dim=128)
    with recorded():
        twice()  # the CHAL arrays alone
        idx.set_ef(96)
        twice()
        idx.densify_level0()
        twice()
        idx.densify_upper()
        twice()
        # the whole patch in its first chunk: nothing is fetched
        SlimClient().sync_patches(idx, chunk, True)  # grows the copy
        assert idx.graph.n == g.n + 300
        twice()
    c = rec.drain()["counters"]
    assert (c["index.captures"], c["index.replays"]) == (5, 5)
    assert len(idx._replay._graphs) == min(5, replay.SLOTS)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["slim", "slimq"])
def test_results_and_stats_outlive_the_next_call_on_card(card, slim_card,
                                                         slimq_card, kind):
    idx = slim_card if kind == "slim" else slimq_card
    idx.scfg = SLIM_CFGS["seeded"]
    q0, q1, q2 = batches(card[1], 3)
    idx.search(q0, 10)
    idx.search(q0, 10)  # captured
    first = searched(idx, q1, 10)
    kept = [a.copy() for a in first]
    stats = idx.__dict__["_last_stats"]
    second = searched(idx, q2, 10)
    assert_same(first, kept)
    assert_same(first, eager(idx, q1, 10))
    assert_same([host(s) for s in stats], kept[2:])
    for a in first:
        assert not any(np.shares_memory(a, b) for b in second)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["slim", "slimq"])
def test_traced_replay_counts_what_eager_counts_on_card(rec, card, slim_card,
                                                        slimq_card, kind):
    idx = slim_card if kind == "slim" else slimq_card
    idx.scfg = SLIM_CFGS["seeded"] if kind == "slim" \
        else SLIMQ_CFGS["whole code"][0]
    q0, q1 = batches(card[1], 2, rows=128)
    idx.search(q0, 10)
    idx.search(q0, 10)  # captured
    with recorded():
        idx.search(q1, 10)
    got = rec.drain()
    with recorded():
        eager(idx, q1, 10)
    want = rec.drain()["counters"]
    names = ["index.queries", "index.beam_dcomp"] + (
        ["index.rerank_dcomp"] if kind == "slimq" else [])
    assert {n: got["counters"][n] for n in names} == {
        n: want[n] for n in names}
    assert got["counters"]["index.replays"] == 1
    assert sorted(s.name for s in got["spans"]) == [
        "index.readback", "index.replay", "index.search", "index.upload"]


def traced_window():
    """A device-activity profile opened as the benchmark's harness opens its
    window, the card idle, then marker kernels before the work: a session
    opened in this process after others can miss its first few device
    operations."""
    prof = recorded(ProfilerActivity.CUDA)
    prof.__enter__()
    torch.cuda.synchronize()
    for _ in range(8):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()
    return prof


def device_ops(prof, tmp_path) -> list:
    """Closes ``prof``; the device operations' names in its Chrome trace,
    as the benchmark's harness reads them."""
    torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ops = [ev["name"] for ev in events if ev.get("ph") == "X"
           and ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    print(ops)
    return ops


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["slim", "slimq"])
def test_replayed_kernels_are_in_the_device_trace_on_card(card, slim_card,
                                                          slimq_card, kind,
                                                          tmp_path):
    idx = slim_card if kind == "slim" else slimq_card
    idx.scfg = SLIM_CFGS["seeded"] if kind == "slim" \
        else SLIMQ_CFGS["whole code"][0]
    q0, q1 = batches(card[1], 2, rows=192)
    idx.search(q0, 10)
    idx.search(q0, 10)  # captured before the window
    prof = traced_window()
    idx.search(q1, 10)
    ops = device_ops(prof, tmp_path)

    def n(part):
        return sum(part in o for o in ops)

    assert (n("beam_kernel"), n("Memcpy HtoD")) == (1, 1)
    assert n("scan_kernel") >= 1 and n("Memcpy DtoH") >= 1
    q3, q4, q5 = batches(card[1], 3, rows=96)
    prof = traced_window()  # captured inside it
    for q in (q3, q4, q5):
        idx.search(q, 10)
    ops = device_ops(prof, tmp_path)
    assert (n("beam_kernel"), n("Memcpy HtoD")) == (3, 3)
