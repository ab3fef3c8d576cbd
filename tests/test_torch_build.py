"""Parity of the port's NN-descent build pieces (kernel Kδ's plain version
on the CPU) against the JAX package, and of the whole slice when each
engine builds its own graph."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_slim_tpu.config import HnswConfig, SearchConfig, SlimConfig
from hnsw_slim_tpu.graph import build as jb
from hnsw_slim_tpu.graph import nnd as jn
from hnsw_slim_tpu.index.bruteforce import BruteForceIndex
from hnsw_slim_tpu.ops.distance import sq_norms as jax_sq_norms
from hnsw_slim_tpu.persist.checkpoint import load_slim as jax_load_slim
from hnsw_slim_tpu.utils.data import clustered
from hnsw_slim_tpu_torch.graph import build as tb
from hnsw_slim_tpu_torch.graph import nnd as tn
from hnsw_slim_tpu_torch.index.hnsw import HnswIndex, resolve_build_strategy
from hnsw_slim_tpu_torch.index.slim import HnswSlimIndex
from torch_slice_util import HNSW_CFG, dataset, jax_graph_dir, recall

torch.set_num_threads(1)


def test_sample_levels_and_run_rank_match_jax():
    """Level sampling draws with numpy exactly as JAX's does; sorted_run_rank
    equals JAX's on a sorted key array with runs."""
    cfg = HnswConfig()
    np.testing.assert_array_equal(tb.sample_levels(5000, cfg.mult, 100),
                                  jb.sample_levels(5000, cfg.mult, 100))
    keys = np.sort(np.random.default_rng(0).integers(0, 50, 400)).astype(
        np.int32)
    np.testing.assert_array_equal(
        tn.sorted_run_rank(torch.from_numpy(keys)).numpy(),
        np.asarray(jn.sorted_run_rank(jnp.asarray(keys))))


def test_mutual_union_matches_jax():
    """Exactly equal rows and counts on the same inputs (holes, repeated
    and mutual edges, tied distances)."""
    rng = np.random.default_rng(1)
    n, m = 500, 12
    sel = rng.integers(0, n, (n, m)).astype(np.int32)
    sel[rng.random((n, m)) < 0.15] = -1
    d_sel = rng.integers(0, 40, (n, m)).astype(np.float32) / 8
    for w in (8, 30):
        jr, jc = jb.mutual_union(jnp.asarray(sel), jnp.asarray(d_sel),
                                 w_union=w)
        pr, pc = tb.mutual_union(torch.from_numpy(sel),
                                 torch.from_numpy(d_sel), w_union=w)
        np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))


def _knn_state(n=1024, k=16, seed=2):
    """A partly converged NND state: true neighbors with some slots empty,
    random new-flags."""
    base, _ = clustered(n, 16, n_clusters=8, seed=seed, scale=0.5)
    rng = np.random.default_rng(seed)
    d = ((base[:, None] - base[None]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    ids = np.argsort(d, axis=1)[:, 3:k + 3].astype(np.int32)
    dist = np.take_along_axis(d, ids, axis=1).astype(np.float32)
    empty = np.arange(k)[None, :] >= rng.integers(k // 2, k + 1, n)[:, None]
    ids[empty], dist[empty] = -1, np.inf
    newf = rng.integers(0, 2, (n, k)).astype(np.int32)
    return base, ids, dist, newf


def test_nnd_candidates_matches_jax():
    """Exactly equal candidates and cleared flags when the port gets the
    draws JAX makes from the same key (rows past n_valid are padding)."""
    _, ids, _, newf = _knn_state()
    n, k = ids.shape
    s_fwd, r_rev, n_valid = 10, 8, n - 40
    key = jax.random.PRNGKey(5)
    jc, jf = jn._nnd_candidates(key, jnp.asarray(ids), jnp.asarray(newf),
                                jnp.int32(n_valid), s_fwd=s_fwd, r_rev=r_rev)
    k1, k2, k3 = jax.random.split(key, 3)
    k4, k5 = jax.random.split(k3)
    draws = tuple(torch.from_numpy(np.array(a)) for a in (
        jax.random.uniform(k1, (n, k)),
        jax.random.randint(k2, (n, s_fwd), 0, k),
        jax.random.randint(k4, (n, s_fwd), 0, r_rev),
        jax.random.randint(k5, (n, s_fwd), 0, k)))
    pc, pf = tn._nnd_candidates(torch.from_numpy(ids),
                                torch.from_numpy(newf), n_valid,
                                s_fwd=s_fwd, r_rev=r_rev, draws=draws)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))


def test_chunked_cand_merge_matches_jax():
    """Merged rows (ids, flags) equal on >= 99% of nodes, distances within
    1e-4 * (1 + |d|) on equal rows, insertion count within 1%."""
    base, ids, dist, newf = _knn_state(seed=3)
    n = len(base)
    rng = np.random.default_rng(3)
    cand = rng.integers(-1, n, (n, 40)).astype(np.int32)
    cand[:, :4] = ids[:, :4]                        # already known
    cand[:, 4] = np.arange(n)                       # self
    cand[:, 5:8] = cand[:, 8:11]                    # in-row duplicates
    ji, jd, jf, jins = jn._chunked_cand_merge(
        jnp.asarray(base), jax_sq_norms(jnp.asarray(base)), jnp.asarray(ids),
        jnp.asarray(dist), jnp.asarray(newf), jnp.asarray(cand), 256, "l2",
        jax.lax.Precision.DEFAULT)
    x = torch.from_numpy(base)
    pi, pd, pf, pins = tn._chunked_cand_merge(
        x, x.pow(2).sum(1), torch.from_numpy(ids), torch.from_numpy(dist),
        torch.from_numpy(newf), torch.from_numpy(cand), chunk=256)
    same = (pi.numpy() == np.asarray(ji)).all(axis=1)
    assert same.mean() >= 0.99
    assert (pf.numpy()[same] == np.asarray(jf)[same]).all()
    a, b = pd.numpy()[same], np.asarray(jd)[same]
    fin = np.isfinite(b)
    assert (np.isfinite(a) == fin).all()
    assert np.all(np.abs(a[fin] - b[fin]) <= 1e-4 * (1 + np.abs(b[fin])))
    assert abs(int(pins) - int(jins)) <= 0.01 * int(jins)


def test_slice_recall_matches_jax(tmp_path_factory):
    """The whole slice with each engine building its own graph (NND build,
    Slim conversion, seeded search at ef=64, pop 8): port recall@10 >=
    JAX recall@10 - 0.02."""
    base, queries = dataset()
    _, gt = BruteForceIndex(base).search(queries, k=10)
    scfg = SearchConfig(ef=64, pop_width=8, seed_width=32)
    js = jax_load_slim(jax_graph_dir(tmp_path_factory) / "slim.npz",
                       search_cfg=scfg)
    ps = HnswSlimIndex.build(base, HNSW_CFG, SlimConfig.from_ratios(),
                             device="cpu")  # "auto" -> NND at this size
    ps.scfg = scfg
    ps.check_integrity()
    ps.densify_level0()
    r_port = recall(ps.search(queries, k=10)[1], gt)
    r_jax = recall(js.search(queries, k=10)[1], gt)
    assert r_port >= r_jax - 0.02, (r_port, r_jax)


def test_build_strategy_resolution():
    """'auto' resolves as in the JAX package (NN-descent below 200k points,
    insertion at scale); strategy="insert" builds by insertion rounds, and
    an unknown strategy raises."""
    assert resolve_build_strategy("auto", 1000) == "nnd"
    assert resolve_build_strategy("auto", 199_999) == "nnd"
    assert resolve_build_strategy("auto", 200_000) == "insert"
    assert resolve_build_strategy("insert", 100) == "insert"
    base, _ = clustered(300, 8, seed=4)
    h = HnswIndex(HnswConfig(M=4, ef_construction=16), strategy="insert",
                  max_batch=64, device="cpu")
    h.build(base)
    assert set(h.build_stats) == {"phase_s", "overflow"}
    assert h.check_integrity()["connections"] > 0
    with pytest.raises(ValueError, match="strategy"):
        HnswIndex(HnswConfig(M=4), strategy="bogus", device="cpu").build(base)


def test_resolve_device_raises_without_cuda(monkeypatch):
    """Without a CUDA card the port's entry points raise unless the caller
    asks for the CPU: resolve_device() and every index's default device."""
    from hnsw_slim_tpu_torch.index.bruteforce import BruteForceIndex as PortBF
    from hnsw_slim_tpu_torch.ops import cuda

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cuda.resolve_device()
    assert cuda.resolve_device("cpu") == torch.device("cpu")
    for make in (lambda: HnswIndex(HnswConfig()), lambda: HnswSlimIndex(),
                 lambda: PortBF(np.zeros((4, 2), np.float32))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
