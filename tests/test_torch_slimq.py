"""Parity of the port's SlimQ index (index/slimq.py: seeds from estimates,
greedy descent and beams on estimates, the per-pop rerank track,
save_slimq / load_slimq) against the JAX package on the CPU, where every
kernel wrapper runs its plain PyTorch version.

One JAX-built index (3000 x 64, M=16, ef_construction=100, 4 bits; and a
threshold_level=1 conversion of the same HNSW graph over the same codes) is
saved with the JAX ``save_slimq`` and loaded with the port's ``load_slimq``;
the same queries go through both engines. Tolerances: ids equal on >= 0.99
of (query, rank) slots — the engines sum <q_rot, bits> in different orders,
so near-tied estimates may reorder pops —, rerank distances rtol 1e-4,
recall@10 within 0.01, hop and distance-computation sums within 1%."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_slim_tpu.config import HnswConfig, QuantConfig, SearchConfig, SlimConfig
from hnsw_slim_tpu.graph.prune import convert_to_slim as jax_convert
from hnsw_slim_tpu.index.bruteforce import BruteForceIndex as JaxBruteForce
from hnsw_slim_tpu.index.hnsw import HnswIndex as JaxHnsw
from hnsw_slim_tpu.index.slimq import HnswSlimQIndex as JaxSlimQ
from hnsw_slim_tpu.persist import checkpoint as jck
from hnsw_slim_tpu.quant.kmeans import kmeans as jax_kmeans
from hnsw_slim_tpu.quant.rabitq import quantize_batch as jax_quantize
from hnsw_slim_tpu.quant.rotator import FhtKacRotator as JaxRotator
from hnsw_slim_tpu.utils.data import clustered
from hnsw_slim_tpu_torch.index.bruteforce import BruteForceIndex, topk_estimate
from hnsw_slim_tpu_torch.index.slimq import HnswSlimQIndex
from hnsw_slim_tpu_torch.persist import checkpoint as tck
from hnsw_slim_tpu_torch.quant.estimator import QuantScorer
from hnsw_slim_tpu_torch.quant.rotator import g_tables

torch.set_num_threads(1)
HCFG = HnswConfig(M=16, ef_construction=100)
QCFG = QuantConfig(total_bits=4)
NQ = 64


def _recall(ids, gt):
    return np.mean([len(set(a.tolist()) & set(b.tolist())) / gt.shape[1]
                    for a, b in zip(ids, gt)])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX-built SlimQ indexes (threshold level 0 and 1 over one HNSW graph
    and one set of codes), their files, the port's loads of those files, the
    data and the exact top-10."""
    base, queries = clustered(3000, 64, n_queries=NQ, seed=22)
    d = tmp_path_factory.mktemp("slimq")
    h = JaxHnsw(HCFG)
    h.build(base)
    cent, asn = jax_kmeans(base, k=QCFG.num_clusters, iters=QCFG.kmeans_iters)
    rot = JaxRotator(base.shape[1], seed=HCFG.seed)
    cent_rot = np.asarray(rot.rotate(cent))
    codes = jax_quantize(np.asarray(rot.rotate(base)), cent_rot, asn,
                         QCFG.ex_bits)
    jax_idx, port_idx = {}, {}
    for t in (0, 1):
        j = JaxSlimQ()
        j.graph = jax_convert(h.graph, h.vectors, h.vn,
                              SlimConfig.from_ratios(threshold_level=t))
        j.rotator, j.codes = rot, codes
        j.cluster_ids = jnp.asarray(asn.astype(np.int32))
        j.centroids_rot = jnp.asarray(cent_rot)
        j.dataset = base
        jck.save_slimq(d / f"t{t}.npz", j)
        p = tck.load_slimq(d / f"t{t}.npz", device="cpu")
        p.set_dataset(base)
        jax_idx[t], port_idx[t] = j, p
    _, gt = JaxBruteForce(base, chunk=1024).search(queries, k=10)
    return dict(jax=jax_idx, port=port_idx, base=base, queries=queries,
                gt=np.asarray(gt), dir=d)


def test_load_slimq_reads_the_jax_file(world):
    """The state carried across: graph, codes (as u32), cluster ids, rotated
    centroids and flip bits of the loaded index equal the JAX index's."""
    j, p = world["jax"][0], world["port"][0]
    assert (p.graph.max_level, p.graph.threshold_level, p.graph.cap0,
            p.graph.cap, p.graph.entry) == (
        j.graph.max_level, j.graph.threshold_level, j.graph.cap0,
        j.graph.cap, int(j.graph.entry))
    np.testing.assert_array_equal(p.graph.nbr.numpy(), np.asarray(j.graph.nbr))
    for f, arr in p.codes.to_numpy().items():
        np.testing.assert_array_equal(arr, np.asarray(getattr(j.codes, f)))
    np.testing.assert_array_equal(p.cluster_ids.numpy(),
                                  np.asarray(j.cluster_ids))
    np.testing.assert_array_equal(p.centroids_rot.numpy(),
                                  np.asarray(j.centroids_rot))
    np.testing.assert_array_equal(p.rotator.state(), j.rotator.state())
    assert p.rotator.dim == j.rotator.dim == 64
    assert p.index_size() == j.index_size()
    assert p.runtime_memory() == j.runtime_memory()


CASES = [  # threshold, seed_width, use_ex, rerank, pop, ef, dense layouts
    (0, 32, False, True, 8, 64, True),
    (0, 32, False, True, 8, 64, False),
    (0, 32, True, True, 8, 64, True),
    (0, 32, False, False, 8, 64, True),
    (0, 0, False, True, 8, 64, True),
    (0, 0, True, True, 1, 64, False),
    (0, 32, False, True, 8, 320, True),
    (1, 0, False, True, 8, 64, True),
    (1, 32, False, True, 1, 64, False),
]


@pytest.mark.parametrize("t,seed_width,use_ex,rerank,pop,ef,dense", CASES)
def test_search_matches_jax(world, t, seed_width, use_ex, rerank, pop, ef,
                            dense):
    """Same index file, queries and knobs through both engines."""
    queries, gt, base = world["queries"], world["gt"], world["base"]
    scfg = SearchConfig(ef=ef, pop_width=pop, seed_width=seed_width,
                        use_ex=use_ex, straggler_stages=())
    out = {}
    for name in ("jax", "port"):
        src = world[name][t]
        idx = JaxSlimQ(search_cfg=scfg) if name == "jax" else \
            HnswSlimQIndex(search_cfg=scfg, device="cpu")
        for f in ("graph", "codes", "rotator", "cluster_ids", "centroids_rot",
                  "dataset"):
            setattr(idx, f, getattr(src, f))
        if dense:
            idx.densify_level0()
            idx.densify_upper()
        d, ids = idx.search(queries, k=10, rerank=rerank)
        out[name] = (np.asarray(d), np.asarray(ids), idx.last_stats)
    (jd, ji, js), (pd, pi, ps) = out["jax"], out["port"]
    assert pi.shape == ji.shape == (NQ, 10) and pi.dtype == np.int32
    same = pi == ji
    assert same.mean() >= 0.99, same.mean()
    assert abs(_recall(pi, gt) - _recall(ji, gt)) <= 0.01
    for key in ("hops", "distance_computations"):
        assert abs(ps[key] - js[key]) <= 0.01 * js[key], (key, ps[key],
                                                           js[key])
    ok = same & np.isfinite(jd)
    if rerank:
        np.testing.assert_allclose(pd[ok], jd[ok], rtol=1e-4, atol=1e-5)
        true_d = ((queries[:, None, :] - base[np.maximum(pi, 0)]) ** 2).sum(-1)
        np.testing.assert_allclose(pd[pi >= 0], true_d[pi >= 0], rtol=1e-3,
                                   atol=1e-3)
    else:  # estimates: fp32 summation order, see test_torch_quant
        assert np.all(np.abs(pd[ok] - jd[ok]) <= 1e-4 * (1 + np.abs(jd[ok])))


def test_seed_block_matches_jax(world):
    """The seed block alone (1-bit estimates to every level>=1 node, top
    32): ids equal on >= 0.99 of slots against JAX's matmul + lax.top_k
    form."""
    import jax

    j, p = world["jax"][0], world["port"][0]
    q = world["queries"]
    up_bits, up_fac, up_onehot, up_ids = j._seed_table()
    q_rot = j.rotator.rotate(q)
    g_tab = jnp.sum((q_rot[:, None, :] - j.centroids_rot[None]) ** 2, -1)
    est = up_fac[:, 0][None] + g_tab @ up_onehot.T + up_fac[:, 1][None] * (
        q_rot @ up_bits.T - 0.5 * jnp.sum(q_rot, 1)[:, None])
    est = jnp.where((up_ids >= 0)[None], est, jnp.inf)
    _, pos = jax.lax.top_k(-est, 32)
    want = np.asarray(up_ids)[np.asarray(pos)]
    rows, ids = p._seed_table()
    np.testing.assert_array_equal(ids.numpy(), np.asarray(up_ids))
    tq = p.rotator.rotate(q)
    sumq, g_add = g_tables(tq, p.centroids_rot)
    sc = QuantScorer(rows, 2, 3, False, tq, sumq, g_add)
    _, tpos = topk_estimate(sc, ids, 32)
    got = ids.numpy()[tpos.numpy()]
    assert (got == want).mean() >= 0.99


@pytest.mark.parametrize("which", [0, 1])
def test_seed_table_ids_are_jaxs(world, which):
    """The seed table's ids (every level>=1 node, -1 padded to a power of
    two of at least 64) are the JAX package's, at threshold level 0 and 1,
    and ``up_count`` counts the real ones."""
    j, p = world["jax"][which], world["port"][which]
    want = np.asarray(j._seed_table()[3])
    p._up_for = None  # built anew
    rows, ids = p._seed_table()
    np.testing.assert_array_equal(ids.numpy(), want)
    assert p.up_count == int((want >= 0).sum()) and len(rows) == len(want)


def test_port_build_recall_and_size():
    """A port-side build on the JAX end-to-end test's data (4000 x 128,
    M=16, ef_construction=100, 4 bits; at 64 dims the graph alone passes
    0.35 of the raw vectors) under that test's own rules:
    recall@10 >= 0.85 with the rerank at ef=100, exact returned distances,
    index_size < 0.35 x the raw vectors; estimate-only search on the full
    code reaches that package's 0.6; autotune accepts the index."""
    base, queries = clustered(4000, 128, n_queries=50, seed=21)
    _, gt = BruteForceIndex(base, device="cpu").search(queries, k=10)
    idx = HnswSlimQIndex.build(base, hnsw_cfg=HCFG,
                               slim_cfg=SlimConfig.from_ratios(),
                               quant_cfg=QCFG, device="cpu")
    assert set(idx.build_stats) == {"hnsw_s", "convert_s", "kmeans_s",
                                    "rotate_s", "quantize_s"}
    idx.set_ef(100)
    d, ids = idx.search(queries, k=10)
    assert _recall(ids, gt) >= 0.85
    true_d = ((queries[:, None, :] - base[np.maximum(ids, 0)]) ** 2).sum(-1)
    np.testing.assert_allclose(d[ids >= 0], true_d[ids >= 0], rtol=1e-3,
                               atol=1e-3)
    assert idx.index_size() < 0.35 * base.nbytes
    assert idx.runtime_memory() == idx.index_size() + base.nbytes
    idx.use_ex = True
    _, ids_e = idx.search(queries, k=10, rerank=False)
    assert _recall(ids_e, gt) >= 0.6
    idx.use_ex = False
    rep = idx.autotune(64, sample=32, configs=[(8, 0), (4, 0)])
    assert rep["probe_recall"] >= 0.8 and idx.scfg.ef == 64


def test_save_slimq_loads_into_jax(world):
    """save_slimq -> the JAX load_slimq -> equal search: the port's file is
    the JAX package's layout."""
    p = world["port"][0]
    path = world["dir"] / "port.npz"
    tck.save_slimq(path, p)
    with np.load(world["dir"] / "t0.npz") as a, np.load(path) as b:
        assert set(a.files) == set(b.files)
        for f in a.files:
            assert a[f].dtype == b[f].dtype, f
            np.testing.assert_array_equal(a[f], b[f])
    scfg = SearchConfig(ef=64, pop_width=8, seed_width=32,
                        straggler_stages=())
    j2 = jck.load_slimq(path, search_cfg=scfg)
    j2.set_dataset(world["base"])
    j1 = world["jax"][0]
    j1.scfg = scfg
    d1, i1 = j1.search(world["queries"], k=10)
    d2, i2 = j2.search(world["queries"], k=10)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))
    p2 = tck.load_slimq(path, search_cfg=dataclasses.replace(scfg),
                        device="cpu")
    p2.set_dataset(world["base"])
    p.scfg = scfg
    assert (p2.search(world["queries"], 10)[1]
            == p.search(world["queries"], 10)[1]).all()
