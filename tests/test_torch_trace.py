"""The port's span and counter facility (hnsw_slim_tpu_torch/utils/trace.py)
on the CPU: off it records nothing and costs one shared null context; on
(while any torch.profiler session records) spans nest per thread, counters
add host ints and device tensors, the search and update paths record their
phases in order, ``last_stats`` is summed on demand, and nothing waits on
the device."""

import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hnsw_slim_tpu_torch import strategy
from hnsw_slim_tpu_torch.config import HnswConfig, SearchConfig, SlimConfig
from hnsw_slim_tpu_torch.index.slim import HnswSlimIndex
from hnsw_slim_tpu_torch.serve.client import SlimClient
from hnsw_slim_tpu_torch.serve.server import SlimServer
from hnsw_slim_tpu_torch.utils import trace
from hnsw_slim_tpu_torch.utils.data import clustered
from hnsw_slim_tpu_torch.utils.io import write_fvecs

CFG = HnswConfig(M=12, ef_construction=64)


@pytest.fixture
def rec():
    """The process recorder, emptied before and after the test."""
    trace.drain()
    yield trace
    trace.drain()


def recorded():
    """A CPU profiler session: the program records while it is open."""
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def slim():
    base, queries = clustered(n=2000, dim=16, n_queries=64, seed=61)
    idx = HnswSlimIndex.build(base, hnsw_cfg=CFG, device="cpu")
    idx.densify_level0()
    idx.densify_upper()
    idx.scfg = SearchConfig(ef=32, pop_width=4, seed_width=16)
    return idx, queries


@pytest.fixture(scope="module")
def served():
    base, _ = clustered(n=2200, dim=16, n_queries=0, seed=62)
    server = SlimServer(base[:2000], hnsw_cfg=CFG,
                        slim_cfg=SlimConfig.from_ratios(), host="127.0.0.1",
                        port=0, device="cpu")
    server.start_background()
    client = SlimClient(port=server._httpd.server_address[1])
    yield server, client, base
    server.shutdown()


def _drain_after(rec, *names, timeout=10.0):
    """drain(), waiting until spans of ``names`` have ended: the server's
    handler thread closes its span after the reply has reached the
    client."""
    got = {"spans": [], "counters": {}}
    deadline = time.monotonic() + timeout
    while True:
        more = rec.drain()
        got["spans"] += more["spans"]
        for k, v in more["counters"].items():
            got["counters"][k] = got["counters"].get(k, 0) + v
        if set(names) <= {s.name for s in got["spans"]} \
                or time.monotonic() > deadline:
            return got
        time.sleep(0.01)


def _children(spans, parent):
    return [s.name for s in sorted(spans, key=lambda s: s.start)
            if s.parent == parent.id]


def _one(spans, name):
    got = [s for s in spans if s.name == name]
    assert len(got) == 1, (name, [s.name for s in spans])
    return got[0]


def test_off_records_nothing_through_one_null_context(rec):
    assert not rec.recording()
    a, b = rec.span("x.a"), rec.span("x.b", level=3)
    assert a is b
    with a:
        rec.count("x.n", 5)
        rec.count("x.t", torch.ones(4, dtype=torch.int32))
    marks: dict = {}
    with rec.phase("x.p", marks, "p"):
        pass
    assert marks["p"] >= 0.0  # a phase times into its dict even when off
    assert rec.drain() == {"spans": [], "counters": {}}


def test_spans_nest_per_thread_and_counters_add(rec):
    box = {}

    def work(tag):
        with rec.span(f"{tag}.outer"):
            with rec.span(f"{tag}.inner", level=2):
                box[tag] = threading.get_ident()
                rec.count("n.host", 2)
                rec.count("n.dev", torch.arange(5, dtype=torch.int32))

    with recorded():
        t = threading.Thread(target=work, args=("b",))
        with rec.span("a.top"):
            t.start()
            work("a")
            t.join(timeout=30)
        assert not t.is_alive()
        got = rec.drain()
    spans = {s.name: s for s in got["spans"]}
    assert set(spans) == {"a.top", "a.outer", "a.inner", "b.outer",
                          "b.inner"}
    assert spans["a.top"].parent == 0
    assert spans["a.outer"].parent == spans["a.top"].id
    assert spans["a.inner"].parent == spans["a.outer"].id
    # the other thread's spans start their own stack
    assert spans["b.outer"].parent == 0
    assert spans["b.inner"].parent == spans["b.outer"].id
    assert spans["b.inner"].thread == box["b"] != spans["a.inner"].thread
    assert spans["b.inner"].attrs == {"level": 2}
    for s in spans.values():
        assert s.start <= s.end
    assert spans["a.top"].start <= spans["a.outer"].start
    assert spans["a.outer"].end <= spans["a.top"].end
    assert got["counters"] == {"n.host": 4, "n.dev": 20}
    assert rec.drain() == {"spans": [], "counters": {}}


def test_a_profiler_session_turns_recording_on_and_off(rec):
    assert not rec.recording()
    with profile(activities=[ProfilerActivity.CPU]):
        assert rec.recording()
        with rec.span("p.inside"):
            pass
    assert not rec.recording()
    with rec.span("p.after"):
        pass
    assert [s.name for s in rec.drain()["spans"]] == ["p.inside"]


def test_search_records_its_phases_in_order(rec, slim):
    idx, queries = slim
    with recorded():
        idx.search(queries, 10)
    got = rec.drain()
    top = _one(got["spans"], "index.search")
    assert top.parent == 0
    assert _children(got["spans"], top) == [
        "index.upload", "index.seed", "index.beam", "index.readback"]
    assert got["counters"]["index.queries"] == len(queries)
    # the beams' distance computations: the call's total less the seed scan
    n_up = int((idx.up_ids >= 0).sum())
    st = idx.last_stats
    assert got["counters"]["index.beam_dcomp"] == (
        st["distance_computations"] - n_up * len(queries))


def test_last_stats_equal_the_eager_sums(rec, slim):
    idx, queries = slim
    _, _, hops, dcomp = idx.search_async(queries, 10)
    idx.search(queries, 10)
    assert isinstance(idx.__dict__["_last_stats"], tuple)  # not summed yet
    assert idx.last_stats == {"hops": int(hops.sum()),
                              "distance_computations": int(dcomp.sum())}
    assert idx.last_stats is idx.last_stats  # summed once
    idx.search(queries[:5], 10)
    assert idx.last_stats["hops"] < int(hops.sum())


def test_update_records_server_and_client_phases(rec, served):
    server, client, base = served
    local = client.bootstrap(device="cpu")
    n0 = server.hnsw.graph.n
    with recorded():
        blob, finished = client.update_index(ids=range(n0, n0 + 100),
                                             vectors=base[2000:2100])
        local = client.sync_patches(local, blob, finished)
    got = _drain_after(rec, "server.update")
    spans = got["spans"]
    up = _one(spans, "server.update")
    assert _children(spans, up) == [
        "server.decode", "server.insert", "server.reprune",
        "server.dense_refresh", "server.patch_encode",
        "server.patch_encode", "server.send"]
    # the handler's thread records the request's spans under its own stack
    assert up.parent == 0 and up.thread != _one(spans, "client.update").thread
    ins = _one(spans, "server.insert")
    assert _children(spans, ins) == [
        "insert.grow", "insert.vectors", "insert.insert_batches",
        "insert.mirror_sync"]
    rp = _one(spans, "server.reprune")
    levels = [s.attrs["level"] for s in spans
              if s.parent == rp.id and s.name == "reprune.stage2"]
    assert levels == list(range(len(levels))) and levels
    cu = _one(spans, "client.update")
    # the request is handled inside the client's call; the reply can reach
    # the client before the handler's thread closes its span
    send = [s for s in spans if s.parent == up.id][-1]
    assert cu.start <= up.start <= send.start <= cu.end
    sync = _one(spans, "client.sync")
    assert _children(spans, sync) == [
        "client.apply", "client.norms", "client.densify"]
    c = got["counters"]
    assert c == {"server.patch_bytes": len(blob)}
    assert local.graph.n == n0 + 100


def test_nothing_waits_on_the_device_while_recording(rec, slim, served,
                                                      monkeypatch):
    def no_sync(*a, **kw):
        raise AssertionError("torch.cuda.synchronize called")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    idx, queries = slim
    server, client, base = served
    local = client.bootstrap(device="cpu")
    n0 = server.hnsw.graph.n
    with recorded():
        d, i = idx.search(queries, 10)
        assert i.shape == (len(queries), 10)
        blob, finished = client.update_index(
            ids=range(n0, n0 + 50), vectors=base[2100:2150])
        local = client.sync_patches(local, blob, finished)
    assert local.graph.n == n0 + 50
    names = {s.name for s in _drain_after(rec, "server.update")["spans"]}
    assert {"index.search", "server.update", "client.sync"} <= names


def test_a_copy_patched_on_the_card_is_never_pulled(rec, served):
    """sync_patches patches a copy where it lives, here a CPU copy (the
    card's path with Kπ's plain version in place of Kπ): no
    ``client.pull``, each apply split into decode, stage, pack and the
    store's growth, no ``client.apply_device`` (no card), and the copy
    equal to the server's graph and rows."""
    from hnsw_slim_tpu_torch.persist import patch as patchlib

    server, client, base = served
    local = client.bootstrap(device="cpu")
    n0 = server.hnsw.graph.n
    with recorded():
        blob, finished = client.update_index(ids=range(n0, n0 + 50),
                                             vectors=base[2150:2200])
        local = client.sync_patches(local, blob, finished)
    got = _drain_after(rec, "server.update")
    spans = got["spans"]
    sync = _one(spans, "client.sync")
    assert _children(spans, sync) == ["client.apply", "client.norms",
                                      "client.densify"]
    apply = _one(spans, "client.apply")
    assert _children(spans, apply) == ["apply.decode", "apply.stage",
                                       "apply.pack", "apply.grow"]
    assert "client.apply_device" not in got["counters"]
    n = n0 + 50
    assert local.graph.n == n
    c = patchlib.to_np(local.graph)
    for l in range(local.graph.max_level + 1):
        w = max(local.graph.cap0, local.graph.cap)
        np.testing.assert_array_equal(
            patchlib._level_rows(c, l, n, w),
            patchlib._level_rows(server.inc.host_chal, l, n, w))
    np.testing.assert_array_equal(local.vectors.numpy(),
                                  server.vectors_np[:n])


def test_the_cli_profile_holds_the_program_spans(rec, tmp_path):
    base, queries = clustered(n=1500, dim=16, n_queries=20, seed=63)
    d = tmp_path / "toy"
    d.mkdir()
    write_fvecs(d / "toy_base.fvecs", base)
    write_fvecs(d / "toy_query.fvecs", queries)
    argv = ["--dataset", "toy", "--data_dir", str(tmp_path), "--device",
            "cpu", "--m", "12", "--ef_construction", "64", "--ef_search",
            "32"]
    strategy.main(argv + ["--solve_strategy", "bruteforce"])
    prof = tmp_path / "prof"
    strategy.main(argv + ["--solve_strategy", "hnsw_slim", "--profile_dir",
                          str(prof)])
    with open(prof / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    mine = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    assert {"cli.build", "cli.convert", "cli.search", "index.search",
            "index.beam"} <= set(mine)
    b, c, s = mine["cli.build"], mine["cli.convert"], mine["cli.search"]
    assert b["ts"] + b["dur"] <= c["ts"] and c["ts"] + c["dur"] <= s["ts"]
    # on the trace's clock: the profiler's operators of the beam lie inside
    # the program's beam span
    beam = mine["index.beam"]
    lo, hi = beam["ts"], beam["ts"] + beam["dur"]
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e.get("ph") == "X"]
    inside = [e for e in ops if lo <= e["ts"] and e["ts"] + e["dur"] <= hi]
    assert inside
