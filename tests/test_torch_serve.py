"""The port's HTTP server and client (hnsw_slim_tpu_torch/serve) on the CPU:
the ten cases of tests/test_serve.py against the port (device="cpu", each
server on an ephemeral port), queries racing updates through the reader /
writer lock, and each engine's client against the other engine's server on
one graph, with the same ids up to near-ties and the same patch bytes."""

import copy
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from hnsw_slim_tpu_torch.config import HnswConfig, SlimConfig
from hnsw_slim_tpu_torch.index.bruteforce import BruteForceIndex
from hnsw_slim_tpu_torch.serve.client import SlimClient
from hnsw_slim_tpu_torch.serve.server import SlimServer
from hnsw_slim_tpu_torch.utils.data import clustered
from torch_slice_util import dataset, jax_graph_dir

torch.set_num_threads(1)
CFG = HnswConfig(M=12, ef_construction=64)


def _serve(server):
    """Start ``server`` in the background; a client on its bound port."""
    server.start_background()
    return SlimClient(port=server._httpd.server_address[1])


def _gt(base, queries, k=5):
    return BruteForceIndex(base, device="cpu").search(queries, k=k)[1]


@pytest.fixture(scope="module")
def served():
    base, queries = clustered(n=2200, dim=16, n_queries=20, seed=51)
    server = SlimServer(base[:2000], hnsw_cfg=CFG,
                        slim_cfg=SlimConfig.from_ratios(), host="127.0.0.1",
                        port=0, device="cpu")
    client = _serve(server)
    yield server, client, base, queries
    server.shutdown()


def test_port_query_and_set_ef(served):
    server, client, base, queries = served
    assert client.set_ef(80)
    gt = _gt(base[:2000], queries)
    hits = 0
    for q, g in zip(queries, gt):
        d, labels = client.query(q, k=5)
        assert len(labels) == 5
        assert np.all(np.diff(d) >= -1e-6)
        hits += len(set(labels.tolist()) & set(g.tolist()))
    assert hits / gt.size >= 0.85


def test_port_update_index_and_patch_sync(served):
    server, client, base, queries = served
    local = copy.copy(server.slim)  # the client's mirror of the index
    blob, finished = client.update_index(ids=range(2000, 2200),
                                         vectors=base[2000:2200])
    assert len(blob) > 0
    local = client.sync_patches(local, blob, finished)
    assert local.graph.n == 2200
    gt = _gt(base, queries)
    local.set_ef(80)
    _, ids = local.search(queries, k=5)
    hits = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(ids, gt))
    assert hits / gt.size >= 0.8
    _, labels = client.query(base[2100], k=3)
    assert 2100 in labels


def test_port_mark_delete(served):
    server, client, base, queries = served
    _, labels = client.query(base[100], k=3)
    assert 100 in labels
    assert client.mark_delete([100]) == 1
    _, labels = client.query(base[100], k=3)
    assert 100 not in labels


def test_port_hnsw_serve_mode():
    base, queries = clustered(n=1200, dim=16, n_queries=10, seed=52)
    server = SlimServer(base, hnsw_cfg=CFG, host="127.0.0.1", port=0,
                        serve_index="hnsw", device="cpu")
    try:
        client = _serve(server)
        client.set_ef(64)
        gt = _gt(base, queries)
        hits = 0
        for q, g in zip(queries, gt):
            _, labels = client.query(q, k=5)
            hits += len(set(labels.tolist()) & set(g.tolist()))
        assert hits / gt.size >= 0.9
    finally:
        server.shutdown()


def test_port_replace_deleted_slot_reuse():
    base, _ = clustered(n=1500, dim=16, n_queries=0, seed=53)
    server = SlimServer(base[:1400], hnsw_cfg=CFG, port=0, device="cpu")
    n0 = server.hnsw.graph.n
    # delete 50 labels, then insert 60 vectors: 50 reuse slots, 10 append
    server.mark_delete(range(100, 150))
    writer = server.update_index(base[1400:1460])
    assert server.hnsw.graph.n == n0 + 10
    assert not server.deleted[100:150].any()
    assert (server.labels[100:150] >= 1400).all()
    _, labels = server.query(base[1405], k=3)
    assert 1405 in labels.tolist()
    blob, fin = writer.next_chunk()
    assert fin and len(blob) > 0


def test_port_incremental_dense0_matches_full_rebuild(served):
    """update_index refreshes the dense level-0 rows in place; they equal a
    from-scratch densify of the updated graph."""
    server, client, base, queries = served
    assert server.slim.dense0 is not None
    server.update_index(base[:50] + 5.0)
    inc_rows = server.slim.dense0.clone()
    assert server.slim.densify_level0() == inc_rows.numel() * 4
    assert torch.equal(inc_rows, server.slim.dense0)


def test_port_bootstrap_and_vector_fetch(served):
    server, client, base, queries = served
    local = client.bootstrap(device="cpu")
    assert local.graph.n == server.slim.graph.n
    local.set_ef(64)
    server.set_ef(64)
    _, i1 = local.search(queries[:5], k=5)
    _, i2 = server.slim.search(queries[:5], k=5)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(
        client.get_vectors(10, 7),
        server.slim.vectors[10:17].numpy(), rtol=1e-6)


def test_port_concurrent_queries_batched(served):
    server, client, base, queries = served
    gt = _gt(base[:2000], queries)

    def one(i):
        _, labels = client.query(queries[i], k=5)
        return len(set(labels.tolist()) & set(gt[i].tolist()))

    with ThreadPoolExecutor(max_workers=10) as ex:
        hits = sum(ex.map(one, range(len(queries))))
    assert hits / gt.size >= 0.8
    assert sum(server.batcher.batch_sizes) >= len(queries)


def test_port_update_index_respects_client_labels():
    base, _ = clustered(n=1300, dim=16, n_queries=0, seed=54)
    server = SlimServer(base[:1200], hnsw_cfg=CFG, host="127.0.0.1", port=0,
                        device="cpu")
    try:
        client = _serve(server)
        client.mark_delete([3, 4])
        client.update_index(range(9000, 9100), base[1200:1300])
        _, labels = client.query(base[1250], k=3)
        assert 9050 in labels.tolist()
        assert (server.labels[[3, 4]] >= 9000).all()
    finally:
        server.shutdown()


def test_port_wire_compat_with_query_pb2(served):
    """The port's server speaks query.proto as protobuf writes it: bodies
    built by query_pb2 are answered, and the answers parse under query_pb2
    with no unknown fields and serialize back to the same bytes."""
    pb = pytest.importorskip("hnsw_slim_tpu.serve.query_pb2")
    server, client, base, queries = served
    req = pb.QueryRequest(vector=[float(x) for x in queries[0]], k=4)
    data, _ = client._request("POST", "/query", req.SerializeToString())
    resp = pb.QueryResponse()
    resp.ParseFromString(data)
    assert len(resp.labels) == 4 and resp.SerializeToString() == data
    data, _ = client._request(
        "POST", "/setEf", pb.SetEfRequest(ef_search=72).SerializeToString())
    ef = pb.SetEfResponse()
    ef.ParseFromString(data)
    assert (ef.status, ef.new_ef_search) == ("ok", 72)
    assert ef.SerializeToString() == data


def test_port_queries_never_see_part_of_an_update():
    """Queries from 8 threads race three update batches (appends and slot
    reuse, each slowed inside its insert): no search runs while an update
    holds the writer lock, every answer is sorted, in range and free of
    deleted labels."""
    base, queries = clustered(n=1700, dim=16, n_queries=40, seed=55)
    server = SlimServer(base[:1500], hnsw_cfg=CFG, host="127.0.0.1", port=0,
                        device="cpu")
    state = {"updating": 0, "overlap": 0, "searches": 0}
    add, replace = server.hnsw.add_points, server.hnsw.replace_points
    search = server.slim.search

    def slow(fn):
        def run(*a, **k):
            state["updating"] += 1
            time.sleep(0.1)
            try:
                return fn(*a, **k)
            finally:
                state["updating"] -= 1
        return run

    def watched(*a, **k):
        state["searches"] += 1
        state["overlap"] += state["updating"] > 0
        return search(*a, **k)

    server.hnsw.add_points = slow(add)
    server.hnsw.replace_points = slow(replace)
    server.slim.search = watched
    stop = threading.Event()
    bad = []

    def hammer(t):
        client = SlimClient(port=server._httpd.server_address[1])
        i = t
        while not stop.is_set():
            d, labels = client.query(queries[i % len(queries)], k=5)
            dead = set(np.nonzero(server.deleted)[0].tolist())
            if (np.any(np.diff(d) < -1e-6) or (labels < 0).any()
                    or set(labels.tolist()) & dead
                    & set(range(100, 130))):
                bad.append((d, labels))
            i += 8

    try:
        _serve(server)
        threads = [threading.Thread(target=hammer, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        server.update_index(base[1500:1560])
        server.mark_delete(range(100, 130))
        time.sleep(0.2)
        server.update_index(base[1560:1620])  # 30 reused slots, 30 appended
        server.update_index(base[1620:1700])
        stop.set()
        for t in threads:
            t.join(60)
    finally:
        stop.set()
        server.shutdown()
    assert state["searches"] > 0 and state["overlap"] == 0
    assert not bad


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """The JAX server and the port's server over one JAX-built graph, each
    with a client of the other engine."""
    from hnsw_slim_tpu.config import SlimConfig as JaxSlimConfig
    from hnsw_slim_tpu.persist.checkpoint import load_hnsw as jax_load_hnsw
    from hnsw_slim_tpu.serve.client import SlimClient as JaxClient
    from hnsw_slim_tpu.serve.server import SlimServer as JaxServer
    from hnsw_slim_tpu_torch.persist.checkpoint import load_hnsw

    path = jax_graph_dir(tmp_path_factory) / "hnsw.npz"
    js = JaxServer(jax_load_hnsw(path), slim_cfg=JaxSlimConfig.from_ratios(),
                   host="127.0.0.1", port=0)
    ps = SlimServer(load_hnsw(path, device="cpu"),
                    slim_cfg=SlimConfig.from_ratios(), host="127.0.0.1",
                    port=0, device="cpu")
    js.start_background()
    ps.start_background()
    port_client = SlimClient(port=js._httpd.server_address[1])  # -> JAX
    jax_client = JaxClient(port=ps._httpd.server_address[1])  # -> port
    yield js, ps, port_client, jax_client
    js.shutdown()
    ps.shutdown()


def test_clients_cross_engines_same_ids(engines):
    """The port's client asks the JAX server and the JAX client the port's
    server the same 40 queries at ef 64: the same labels on every row whose
    returned distances do not tie (sorted distances equal within 1e-5 * (1
    + |d|) where the label sets differ)."""
    js, ps, port_client, jax_client = engines
    _, queries = dataset()
    assert port_client.set_ef(64) and jax_client.set_ef(64)
    same = 0
    for q in queries[:40]:
        dj, lj = port_client.query(q, k=10)
        dp, lp = jax_client.query(q, k=10)
        assert len(lj) == len(lp) == 10
        if set(lj.tolist()) == set(lp.tolist()):
            same += 1
        assert np.all(np.abs(np.sort(dp) - np.sort(dj))
                      <= 1e-5 * (1 + np.abs(dj)))
    assert same >= 39


def test_clients_cross_engines_same_patch(engines):
    """One update batch through each client (40 labels deleted, then 40
    vectors with client ids into the reused slots): the port's server sends
    the JAX server's patch bytes, and a client index bootstrapped from the
    JAX server and patched by the port's client equals the port server's
    graph."""
    from hnsw_slim_tpu_torch.persist import patch as tpatch

    js, ps, port_client, jax_client = engines
    base, _ = dataset()
    local = port_client.bootstrap(device="cpu")
    assert port_client.mark_delete(range(200, 240)) == 40
    assert jax_client.mark_delete(range(200, 240)) == 40
    new = base[:40] + 0.05
    blob_j, fin_j = port_client.update_index(range(5000, 5040), new)
    blob_p, fin_p = jax_client.update_index(range(5000, 5040), new)
    assert fin_j == fin_p and blob_p == blob_j
    local = port_client.sync_patches(local, blob_j, fin_j)
    mine = tpatch.to_np(local.graph)
    theirs = ps.inc.host_chal
    n = local.graph.n
    assert n == ps.chal_unpadded.n
    e = int(mine["lvl_off"][n - 1, -1])
    assert np.array_equal(mine["lvl_off"][:n], theirs["lvl_off"][:n])
    assert np.array_equal(mine["nbr"][:e], theirs["nbr"][:e])
    _, labels = jax_client.query(new[7], k=3)
    assert 5007 in labels.tolist()


def test_serve_imports_neither_jax_nor_protobuf():
    """The port's serving modules load neither JAX, the JAX package nor
    google.protobuf; the package exports SlimServer and SlimClient lazily,
    so importing it loads no serving module."""
    import subprocess
    import sys
    from pathlib import Path

    code = ("import sys, hnsw_slim_tpu_torch as p\n"
            "assert not [m for m in sys.modules if '.serve' in m]\n"
            "assert p.SlimServer.__name__ == 'SlimServer'\n"
            "assert p.SlimClient.__name__ == 'SlimClient'\n"
            "assert {'SlimServer', 'SlimClient'} <= set(p.__all__)\n"
            "import hnsw_slim_tpu_torch.serve.wire\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'hnsw_slim_tpu') "
            "or m.startswith('google.protobuf')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code],
                       cwd=Path(__file__).resolve().parents[1],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_port_short_filter_mask_is_padded(served):
    """A filter mask over the logical nodes only (the server's live flags,
    as the JAX package takes them) is padded with False to one flag per row
    of the capacity-bucketed store, which the CUDA kernels require, and
    serves as the padded mask does."""
    from hnsw_slim_tpu_torch.index.hnsw import allowed_rows

    server, client, base, queries = served
    n = server.hnsw.graph.n
    rows = int(server.slim.vectors.shape[0])
    assert rows > n  # add_points grew the store in capacity buckets
    live = np.ones(n, bool)
    live[::7] = False
    flags = allowed_rows(live, rows, "cpu")
    assert flags.shape == (rows,) and not flags[n:].any()
    assert torch.equal(flags[:n], torch.from_numpy(live))
    full = np.zeros(rows, bool)
    full[:n] = live
    server.slim.set_ef(64)
    d1, i1 = server.slim.search(queries, k=5, filter_mask=live)
    d2, i2 = server.slim.search(queries, k=5, filter_mask=full)
    assert live[i1].all() and np.array_equal(i1, i2)
