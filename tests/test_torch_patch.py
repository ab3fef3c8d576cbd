"""Parity of the port's diff-patch protocol (persist/patch.py compute_diff,
PatchWriter, apply_patch) against the JAX package, byte for byte, and of the
whole update slice against the JAX package's recorded run.

Inputs come from torch_slice_util.jax_update_dir: the JAX run's CHAL arrays
before and after step 1 (an add batch of 120) and step 4 (60 reused slots,
classed as new so that they ship their vectors), and the chunks its
PatchWriter wrote with and without vectors, at a 3000-byte limit (several
chunks) and in one chunk. Bytes and integer arrays compare exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hnsw_slim_tpu.graph.types import ChalGraph as JaxChalGraph
from hnsw_slim_tpu.persist import patch as jpatch
from hnsw_slim_tpu_torch.config import SearchConfig, SlimConfig
from hnsw_slim_tpu_torch.graph import build as tb
from hnsw_slim_tpu_torch.graph import incremental as tinc
from hnsw_slim_tpu_torch.graph.types import ChalGraph, pad_chal_nodes
from hnsw_slim_tpu_torch.index.hnsw import HnswIndex
from hnsw_slim_tpu_torch.index.slim import HnswSlimIndex
from hnsw_slim_tpu_torch.persist import patch as tpatch
from hnsw_slim_tpu_torch.utils import native, trace
from patch_cases import (apply_all, assert_same, encode_chunk, random_chunk,
                         random_graph, rule_chunks, shuffled_rows, store_of)
from torch_slice_util import (UPD_ADD, UPD_BATCH, UPD_CFG, UPD_EF, UPD_SLIM,
                              jax_update_dir, patch_chunks, recall,
                              replay_padding_fault, server_patch_sets, take,
                              update_dataset)

torch.set_num_threads(1)
SLIM = SlimConfig(**{k: getattr(UPD_SLIM, k) for k in (
    "top_M0", "low_m0", "top_M", "low_m")})


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    with np.load(jax_update_dir(tmp_path_factory) / "rec.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(params=["native", "numpy"])
def codec(request, monkeypatch):
    """Both codecs: the native encoder / decoder (where the library builds)
    and the numpy fallback."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "patch_encode", lambda *a, **k: None)
        monkeypatch.setattr(native, "patch_decode", lambda *a, **k: None)
    elif not native.available():
        pytest.skip("the native data-plane library is not built")
    return request.param


def graph_of(rec, s, cls=ChalGraph):
    """The ChalGraph the JAX run held after step s (0: after full), in
    either engine's container, and its host mirror."""
    st = take(rec, f"i{s}_")
    host = {k: st[f"chal_{k}"] for k in ("nbr", "lvl_off", "level")}
    meta = dict(max_level=int(st["lmax"]), threshold_level=0,
                cap0=int(st["caps"][0]), cap=int(st["caps"][1]),
                n_real=int((host["level"] >= 0).sum()))
    if cls is ChalGraph:
        return ChalGraph.from_numpy(host["nbr"], host["lvl_off"],
                                    host["level"], entry=int(st["entry"]),
                                    device="cpu", **meta), host
    return JaxChalGraph(nbr=jnp.asarray(host["nbr"]),
                        lvl_off=jnp.asarray(host["lvl_off"]),
                        level=jnp.asarray(host["level"]),
                        entry=jnp.asarray(np.int32(st["entry"])),
                        **meta), host


def chunks_of(rec, key):
    blob = rec[key].tobytes()
    out, pos = [], 0
    for n in rec[key + "_len"]:
        out.append(blob[pos:pos + int(n)])
        pos += int(n)
    return out


def sets_of(rec, s):
    """(changed_old, changed_new, n before) of step s as the server classes
    them."""
    prev = int((rec[f"i{s - 1}_chal_level"] >= 0).sum())
    now = int((rec[f"i{s}_chal_level"] >= 0).sum())
    reused = update_dataset()[2] if s == 4 else []
    return server_patch_sets(rec[f"i{s}_changed"], prev, now, reused) + (prev,)


def canon(graph, to_np, level_rows):
    c = to_np(graph)
    return [c["level"][:graph.n]] + [
        level_rows(c, l, graph.n, graph.cap0 if l == 0 else graph.cap)
        for l in range(graph.max_level + 1)]


def assert_same_graph(a, b):
    assert (a.n, a.max_level, int(a.entry)) == (b.n, b.max_level,
                                                int(b.entry))
    ca = canon(a, tpatch.to_np, tpatch._level_rows)
    cb = canon(b, tpatch.to_np, tpatch._level_rows)
    for ra, rb in zip(ca, cb):
        np.testing.assert_array_equal(ra, rb)


def test_compute_diff_equals_jax(rec):
    """compute_diff between the graphs before and after step 1 (the old one
    unpadded, the new one capacity-padded): both id lists equal JAX's."""
    old, new = tpatch.compute_diff(graph_of(rec, 0)[0], graph_of(rec, 1)[0])
    np.testing.assert_array_equal(old, rec["diff_old"])
    np.testing.assert_array_equal(new, rec["diff_new"])
    assert new == list(range(2500, 2500 + UPD_ADD))
    # every id the incremental pass reported changed is in the diff
    assert set(rec["i1_changed"].tolist()) <= set(old) | set(new)


@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("tag", ["v", "n"])
@pytest.mark.parametrize("limit", [3000, 1 << 30])
def test_patch_writer_bytes_equal_jax(rec, codec, s, tag, limit):
    """PatchWriter's chunks for step s equal the JAX writer's byte for
    byte: with (v) and without (n) vectors, at a limit that forces several
    chunks and in one chunk, through either codec."""
    g, host = graph_of(rec, s)
    old, new, _ = sets_of(rec, s)
    w = tpatch.PatchWriter(g, old, new,
                           vectors=rec[f"p{s}_vectors"] if tag == "v"
                           else None, host_chal=host)
    got = patch_chunks(w, limit)
    want = chunks_of(rec, f"p{s}{tag}{limit}")
    assert len(got) == len(want) and (limit > 3000 or len(got) > 3)
    assert got == want


@pytest.mark.parametrize("s", [1, 4])
def test_apply_patch_of_jax_bytes(rec, codec, s):
    """apply_patch of the JAX-written chunks onto the graph of before the
    step gives the graph of after it, grows the vectors by the shipped
    ones, and is idempotent."""
    g, _ = graph_of(rec, s - 1)
    want, _ = graph_of(rec, s)
    _, new, prev = sets_of(rec, s)
    vec_after = rec[f"p{s}_vectors"]
    vecs = vec_after[:prev].copy()
    if s == 4:
        vecs[update_dataset()[2]] = 0  # the client's stale slots
    chunks = chunks_of(rec, f"p{s}v3000")
    for blob in chunks:
        g, vecs = tpatch.apply_patch(g, blob, vecs)
    assert_same_graph(g, want)
    np.testing.assert_array_equal(vecs[new], vec_after[new])
    np.testing.assert_array_equal(vecs, vec_after)
    g2, vecs2 = tpatch.apply_patch(g, chunks[-1], vecs)
    assert_same_graph(g2, g)
    np.testing.assert_array_equal(vecs2, vecs)
    with pytest.raises(ValueError):
        tpatch.apply_patch(g, b"\0" * 32)


def test_jax_applies_port_written_bytes(rec):
    """The JAX package's apply_patch reads the port's chunks: the JAX graph
    of before step 1 becomes the JAX graph of after it."""
    g, host = graph_of(rec, 1)
    old, new, _ = sets_of(rec, 1)
    w = tpatch.PatchWriter(g, old, new, vectors=rec["p1_vectors"],
                           host_chal=host)
    jg, _ = graph_of(rec, 0, JaxChalGraph)
    vecs = rec["p1_vectors"][:2500].copy()
    for blob in patch_chunks(w, 3000):
        jg, vecs = jpatch.apply_patch(jg, blob, vecs)
    want, _ = graph_of(rec, 1, JaxChalGraph)
    for ra, rb in zip(canon(jg, jpatch.to_np, jpatch._level_rows),
                      canon(want, jpatch.to_np, jpatch._level_rows)):
        np.testing.assert_array_equal(ra, rb)
    np.testing.assert_array_equal(vecs, rec["p1_vectors"])


def test_node_slices(rec):
    _, host = graph_of(rec, 1)
    v = int(np.argmax(host["level"]))
    got = tpatch.node_slices(host, v)
    want = jpatch.node_slices(host, v)
    assert len(got) == int(host["level"][v]) + 1
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_padded_and_host_mode_graphs_serve_identically(rec):
    """A graph padded by pad_chal_nodes, and the host-mode serving graph
    (placeholder nbr / lvl_off on the device, both dense layouts, n_real),
    return the ids of the unpadded graph; the exact-seed table follows the
    graph object."""
    import dataclasses

    g, host = graph_of(rec, 4)
    n = g.n
    x = torch.from_numpy(rec["s4_vectors"])
    q = update_dataset()[4]

    def index(graph, scfg, dense=False, host_chal=None):
        idx = HnswSlimIndex(search_cfg=scfg, device="cpu")
        idx.graph, idx.vectors = graph, x
        idx.vn = (x * x).sum(1)
        idx.host_chal = host_chal
        if dense:
            idx.densify_level0()
            idx.densify_upper()
        return idx

    plain = ChalGraph.from_numpy(
        host["nbr"], host["lvl_off"][:n], host["level"][:n], entry=g.entry,
        max_level=g.max_level, threshold_level=0, cap0=g.cap0, cap=g.cap,
        device="cpu")
    for scfg in (SearchConfig(ef=UPD_EF, pop_width=4),
                 SearchConfig(ef=UPD_EF, pop_width=4, seed_width=8)):
        want = index(plain, scfg).search(q, 10)[1]
        padded = pad_chal_nodes(plain, 1024)
        assert padded.level.shape[0] == 3072 and padded.n == n
        np.testing.assert_array_equal(index(padded, scfg).search(q, 10)[1],
                                      want)
        ph = dataclasses.replace(
            g, nbr=torch.zeros(8, dtype=torch.int32),
            lvl_off=torch.zeros((8, 8), dtype=torch.int32))
        hm = index(ph, scfg, dense=True, host_chal=host)
        np.testing.assert_array_equal(hm.search(q, 10)[1], want)
        if scfg.seed_width:
            ids0 = hm.up_ids
            hm.graph = dataclasses.replace(hm.graph)
            hm.search(q, 10)
            assert hm.up_ids is not ids0  # rebuilt for the new graph object


def test_update_slice_matches_jax(rec, monkeypatch):
    """The whole slice in the port, with the JAX insert batch's padding
    fault replayed: insertion build, three add batches, a delete + replace
    batch, IncrementalSlim.full / update after each, PatchWriter ->
    apply_patch onto a client copy, the dense layouts refreshed in place,
    then search. The vanilla graph equals JAX's after every step, the Slim
    state equals JAX's, the client equals the server, the refreshed dense
    layouts equal a fresh densify, no deleted id is served, search ids
    equal JAX's on >= 99% of slots and recall@10 is not below JAX's."""
    real = replay_padding_fault(monkeypatch)
    base, adds, slots, rep, queries = update_dataset()
    h = HnswIndex(UPD_CFG, strategy="insert", max_batch=UPD_BATCH,
                  device="cpu")
    h.build(base)
    inc = tinc.IncrementalSlim(SLIM)

    def args():
        return (h.host_adj(), h.levels, int(h.graph.entry), h.vectors, h.vn)

    server = HnswSlimIndex(search_cfg=SearchConfig(ef=UPD_EF), device="cpu")
    server.graph = inc.full(*args())
    server.vectors, server.vn = h.vectors, h.vn
    server.host_chal = inc.host_chal
    server.densify_level0()
    server.densify_upper()
    client, client_vecs = server.graph, base.copy()
    vec_np = base.copy()
    deleted = np.zeros(2500 + 3 * UPD_ADD, bool)
    for s in range(1, 5):
        prev = h.graph.n
        lc, reused = None, np.zeros(0, np.int64)
        if s <= 3:
            touched = h.add_points(adds[s - 1])
            vec_np = np.concatenate([vec_np, adds[s - 1]])
        else:
            deleted[slots] = True
            live = np.zeros(server.graph.level.shape[0], bool)
            live[:len(deleted)] = ~deleted
            _, ids = server.search(queries, 10, filter_mask=live)
            assert not deleted[ids[ids >= 0]].any()
            # the JAX replace path composes its candidates on the host
            # and has no padding fault
            monkeypatch.setattr(tb, "_build_search", real)
            touched, lc = h.replace_points(slots, rep)
            vec_np[slots] = rep
            reused = slots
            deleted[slots] = False
        for l, a in enumerate(h.host_adj()):
            np.testing.assert_array_equal(a, rec[f"s{s}_adj{l}"],
                                          err_msg=f"step {s} level {l}")
        graph, changed = inc.update(*args(), touched=touched,
                                    level_changed=lc)
        np.testing.assert_array_equal(changed, rec[f"i{s}_changed"])
        np.testing.assert_array_equal(inc.host_chal["nbr"],
                                      rec[f"i{s}_chal_nbr"])
        old, new = server_patch_sets(changed, prev, h.graph.n, reused)
        w = tpatch.PatchWriter(graph, old, new, vectors=vec_np,
                               host_chal=inc.host_chal)
        for blob in patch_chunks(w, 3000):
            client, client_vecs = tpatch.apply_patch(client, blob,
                                                     client_vecs)
        assert_same_graph(client, graph)
        np.testing.assert_array_equal(client_vecs, vec_np)
        # the server's serving index: new graph, dense rows refreshed
        server.graph = graph
        server.vectors, server.vn = h.vectors, h.vn
        server.host_chal = inc.host_chal
        upd_ids = np.concatenate([changed, np.arange(prev, h.graph.n),
                                  reused])
        server.update_dense0(inc.host_chal, upd_ids)
        server.update_dense_upper(inc.host_chal, upd_ids)
        fresh = HnswSlimIndex(device="cpu")
        fresh.graph, fresh.host_chal = graph, inc.host_chal
        fresh.densify_level0()
        fresh.densify_upper()
        assert torch.equal(server.dense0, fresh.dense0)
        lv = inc.host_chal["level"]
        for l in range(1, graph.max_level + 1):
            at = np.nonzero(lv >= l)[0]
            np.testing.assert_array_equal(
                server.dense_up[l - 1][server.rank_up[at].long()].numpy(),
                fresh.dense_up[l - 1][fresh.rank_up[at].long()].numpy())
        h.check_integrity()
        server.check_integrity()
    d, ids = server.search(queries, 10)
    assert (ids == rec["search_i"]).mean() >= 0.99
    gt = np.argsort(((queries[:, None] - vec_np[None]) ** 2).sum(-1),
                    axis=1)[:, :10]
    assert recall(ids, gt) >= recall(rec["search_i"], gt)


# ---- apply_patch (Kπ's plain version on the CPU) against the JAX package's
# host apply


def jax_graph(g):
    """A port ChalGraph on the CPU in the JAX package's container."""
    return JaxChalGraph(nbr=jnp.asarray(g.nbr.numpy()),
                        lvl_off=jnp.asarray(g.lvl_off.numpy()),
                        level=jnp.asarray(g.level.numpy()),
                        entry=jnp.asarray(np.int32(g.entry)),
                        max_level=g.max_level,
                        threshold_level=g.threshold_level, cap0=g.cap0,
                        cap=g.cap, n_real=g.n_real)


def assert_same_as_jax(got, want):
    """A port (graph, store) equal to a JAX one: nbr with its padding,
    lvl_off, level and the scalars bit for bit, the store's rows."""
    (g, v), (jg, jv) = got, want
    for name in ("nbr", "lvl_off", "level"):
        t = getattr(g, name)
        assert t.dtype == torch.int32, name
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jg,
                                                                    name)))
    assert int(g.entry) == int(jg.entry)
    for name in ("n_real", "max_level", "threshold_level", "cap0", "cap"):
        assert getattr(g, name) == getattr(jg, name), name
    v = v.numpy() if isinstance(v, torch.Tensor) else v
    assert v.dtype == np.float32
    np.testing.assert_array_equal(v, jv)


def both_paths(graph, chunks, vectors):
    """apply_patch over the same chunks with a host store and with a CPU
    tensor store, and the JAX package's host apply: after each chunk the
    three results equal, the arrays bit for bit; the store stays where it
    lives. The port's last (graph, host store)."""
    host = apply_all(tpatch.apply_patch, graph, chunks,
                     store_of(vectors, None))
    dev = apply_all(tpatch.apply_patch, graph, chunks,
                    store_of(vectors, "cpu"))
    ref = apply_all(jpatch.apply_patch, jax_graph(graph), chunks,
                    store_of(vectors, None))
    for h, d, r in zip(host, dev, ref):
        assert isinstance(h[1], np.ndarray)
        assert isinstance(d[1], torch.Tensor)
        assert_same(d, h)
        assert_same_as_jax(h, r)
    return host[-1]


@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("limit", [3000, 1 << 30])
def test_plain_repack_equals_host_apply_on_jax_steps(rec, codec, s, limit):
    """Steps 1 (an add batch) and 4 (reused slots that ship their
    vectors), in several chunks and in one, then the last chunk again
    (idempotent): apply_patch equals the JAX package's host apply after
    every chunk, and the result is the JAX graph of after the step."""
    g, _ = graph_of(rec, s - 1)
    _, new, prev = sets_of(rec, s)
    vecs = rec[f"p{s}_vectors"][:prev].copy()
    if s == 4:
        vecs[update_dataset()[2]] = 0  # the client's stale slots
    chunks = chunks_of(rec, f"p{s}v{limit}")
    assert (len(chunks) > 3) == (limit == 3000)
    got, got_vecs = both_paths(g, chunks + chunks[-1:], vecs)
    assert_same_graph(got, graph_of(rec, s)[0])
    np.testing.assert_array_equal(got_vecs, rec[f"p{s}_vectors"])


@pytest.mark.parametrize("rule", ["one id twice", "above the top level",
                                  "empty chunk"])
def test_plain_repack_equals_host_apply_on_rules(rec, rule):
    """The chunks that test one rule of the apply, on the JAX graph after
    step 1: the last record of an id wins (its vector from the last record
    that ships one), a record above the top level widens lvl_off, a chunk
    of no records still repacks (rows ascending, the node count grown)."""
    g, _ = graph_of(rec, 1)
    chunks = rule_chunks(g, 11, 24)[rule]
    got, _ = both_paths(g, chunks, rec["p1_vectors"][:g.n])
    if rule == "above the top level":
        assert got.max_level == g.max_level + 2
    if rule == "empty chunk":
        assert got.n == g.n + 3


@pytest.mark.parametrize("layout", ["rows out of order", "node-padded"])
def test_plain_repack_equals_host_apply_on_graph_layouts(rec, layout):
    """Input graphs the host apply canonicalises: rows in no order (every
    untouched row comes out ascending) and a node-padded serving graph."""
    g, _ = graph_of(rec, 0)
    g = shuffled_rows(g, 5) if layout == "rows out of order" else \
        pad_chal_nodes(g, 1024)
    got, _ = both_paths(g, chunks_of(rec, "p1v3000"),
                        rec["p1_vectors"][:2500])
    assert_same_graph(got, graph_of(rec, 1)[0])


@pytest.mark.parametrize("n,cap0,cap,top", [(600, 10, 6, 3), (900, 32, 16, 2),
                                            (700, 33, 8, 1),
                                            (500, 100, 40, 4),
                                            (80, 1030, 8, 1)])
def test_plain_repack_equals_host_apply_on_random_graphs(n, cap0, cap, top):
    """Random graphs at the widths where Kπ's sort changes form (up to 32
    ids in registers, more in shared memory) and past the widest it sorts
    (the plain version has no limit): changed records, reused slots and
    new ids, in two chunks, and the rule chunks."""
    g = random_graph(n, cap0, cap, top, seed=n + cap0)
    vecs = np.random.default_rng(n).standard_normal((n, 8)).astype(
        np.float32)
    both_paths(g, [random_chunk(g, 1, n // 10, 12, 6, 8),
                   random_chunk(g, 2, n // 20, 0, 4, 8)], vecs)
    for chunks in rule_chunks(g, 3, 8).values():
        both_paths(g, chunks, vecs)


def test_device_path_refuses_what_the_host_path_cannot_apply(rec):
    """A record id past the node count, a row wider than the graph's, a
    store of another width: ValueError, where the JAX package's host apply
    fails too."""
    g, _ = graph_of(rec, 1)
    n = g.n
    vecs = torch.zeros((n, 24))
    for bad, store in [([(n + 5, [[1, 2]], None)], vecs),
                       ([(3, [list(range(g.cap0 + 1))], None)], vecs),
                       ([(n, [[1]], np.zeros(24))], torch.zeros((n, 23)))]:
        blob = encode_chunk(bad, n + 1, 24)
        for s in (store, store.numpy()):
            with pytest.raises(ValueError):
                tpatch.apply_patch(g, blob, s)
        with pytest.raises((ValueError, IndexError)):
            jpatch.apply_patch(jax_graph(g), blob, store.numpy())
    with pytest.raises(ValueError):
        tpatch.apply_patch(g, b"\0" * 32)


def test_the_path_is_picked_from_the_input(rec, monkeypatch):
    """The graph's device picks the repack: a CPU graph is repacked by
    Kπ's plain version and counts no card apply; the store, a host array
    or a tensor, grows where it lives."""
    g, _ = graph_of(rec, 0)
    plain, calls = tpatch.repack_plain, []

    def counted(*a):
        calls.append(1)
        return plain(*a)

    monkeypatch.setattr(tpatch, "repack_plain", counted)
    blob = chunks_of(rec, "p1v1073741824")[0]
    x = rec["p1_vectors"][:2500]
    trace.drain()
    with profile(activities=[ProfilerActivity.CPU]):
        for store in (None, store_of(x, None), store_of(x, "cpu")):
            got, grown = tpatch.apply_patch(g, blob, store)
            assert type(grown) is type(store)
            assert got.nbr.device == g.nbr.device
            if store is not None:
                assert len(grown) == got.n > len(store)
    assert len(calls) == 3
    assert "client.apply_device" not in trace.drain()["counters"]
