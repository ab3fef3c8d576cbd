"""Shared setup of the port's parity tests (tests/test_torch_*.py).

``jax_graph_dir`` builds one small HNSW + Slim index with the JAX package
and saves both (save_hnsw, save_slim) once per test session: under xdist the
workers share pytest's base temp directory and take a file lock, so the
JAX build and its compiles run once. ``jax_insert_dir`` does the same for a
JAX insertion build and records one of its batches.
"""

import dataclasses
import fcntl
import os

import numpy as np
import pytest

from hnsw_slim_tpu.config import HnswConfig, SlimConfig
from hnsw_slim_tpu.utils.data import clustered

N, DIM, NQ = 3000, 32, 128
HNSW_CFG = HnswConfig(M=8, ef_construction=64)


def dataset():
    """(base f32[3000, 32], queries f32[128, 32]), clustered, seed 7."""
    return clustered(N, DIM, n_queries=NQ, n_clusters=30, seed=7, scale=0.8)


def jax_graph_dir(tmp_path_factory):
    """Directory holding hnsw.npz and slim.npz, built by the JAX package
    with HNSW_CFG (NN-descent) and SlimConfig.from_ratios() on dataset()."""
    from hnsw_slim_tpu.index.hnsw import HnswIndex
    from hnsw_slim_tpu.index.slim import HnswSlimIndex
    from hnsw_slim_tpu.persist.checkpoint import save_hnsw, save_slim

    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    d = root / "torch_parity_graph"
    d.mkdir(exist_ok=True)
    with open(d / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (d / "slim.npz").exists():
            base, _ = dataset()
            h = HnswIndex(HNSW_CFG, strategy="nnd")
            h.build(base)
            save_hnsw(d / "hnsw.npz", h)
            save_slim(d / "slim.tmp.npz",
                      HnswSlimIndex.from_hnsw(h, SlimConfig.from_ratios()))
            os.replace(d / "slim.tmp.npz", d / "slim.npz")
    return d


def jax_modes_dir(tmp_path_factory):
    """Directory holding two more conversions of jax_graph_dir's hnsw.npz,
    made and saved by the JAX package: slim_t1.npz (SlimConfig.from_ratios(
    threshold_level=1)) and slimzero.npz (HnswSlimZeroIndex, default
    ratios). Built once per session under a file lock, as jax_graph_dir."""
    from hnsw_slim_tpu.index.slim import HnswSlimIndex
    from hnsw_slim_tpu.index.slimzero import HnswSlimZeroIndex
    from hnsw_slim_tpu.persist.checkpoint import load_hnsw, save_slim

    src = jax_graph_dir(tmp_path_factory)
    d = src.parent / "torch_parity_modes"
    d.mkdir(exist_ok=True)
    with open(d / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (d / "slimzero.npz").exists():
            h = load_hnsw(src / "hnsw.npz")
            save_slim(d / "slim_t1.npz", HnswSlimIndex.from_hnsw(
                h, SlimConfig.from_ratios(threshold_level=1)))
            save_slim(d / "slimzero.tmp.npz", HnswSlimZeroIndex.from_hnsw(
                h, SlimConfig.from_ratios()))
            os.replace(d / "slimzero.tmp.npz", d / "slimzero.npz")
    return d


def slim_pair(path, layout: str = "chal"):
    """(JAX index, port index on the CPU) loaded from one Slim checkpoint,
    both in serving layout ``layout``: "chal" (flat CHAL arrays only),
    "dense0" (+ densify_level0) or "dense" (+ densify_upper too)."""
    from hnsw_slim_tpu.persist.checkpoint import load_slim as jax_load_slim
    from hnsw_slim_tpu_torch.persist.checkpoint import load_slim

    pair = jax_load_slim(path), load_slim(path, device="cpu")
    for idx in pair:
        if layout in ("dense0", "dense"):
            idx.densify_level0()
        if layout == "dense":
            idx.densify_upper()
    return pair


def assert_ids_match(pi, pd, ji, jd, share: float = 0.99):
    """ids equal on >= ``share`` of (query, rank) slots; where they differ
    the two engines' distances at that slot lie within 1e-4 * (1 + |d|) (a
    near-tie ordered differently); on equal slots the distances agree to
    the same tolerance."""
    same = pi == ji
    assert same.mean() >= share, same.mean()
    fin = np.isfinite(jd) & np.isfinite(pd)
    assert (np.isfinite(jd) == np.isfinite(pd)).all()
    assert np.all(np.abs(pd[fin] - jd[fin]) <= 1e-4 * (1 + np.abs(jd[fin])))


def recall(ids, gt):
    return np.mean([len(set(a) & set(b)) / gt.shape[1]
                    for a, b in zip(ids, gt)])


def search_engines(tmp_path_factory):
    """(JAX index, port index — both loaded from the JAX-built slim.npz —,
    queries, exact top-10)."""
    from hnsw_slim_tpu.index.bruteforce import BruteForceIndex
    from hnsw_slim_tpu.persist.checkpoint import load_slim as jax_load_slim
    from hnsw_slim_tpu_torch.persist.checkpoint import load_slim

    path = jax_graph_dir(tmp_path_factory) / "slim.npz"
    base, queries = dataset()
    ps = load_slim(path, device="cpu")
    ps.densify_level0()
    _, gt = BruteForceIndex(base).search(queries, k=10)
    return jax_load_slim(path), ps, queries, gt


def check_search_parity(engines, ef, pop, scan):
    """Same graph, queries and knobs (seed_width 32): ids identical on >= 99%
    of (query, rank) slots, recall@10 within 0.002, hops and distance
    computation sums within 1%, distances within 1e-4 * (1 + |d|) on equal
    slots."""
    js, ps, queries, gt = engines
    for idx in (js, ps):
        idx.scfg = dataclasses.replace(idx.scfg, ef=ef, pop_width=pop,
                                       scan_width=scan, seed_width=32)
    jd, ji = js.search(queries, k=10)
    pd, pi = ps.search(queries, k=10)
    assert (pi == ji).mean() >= 0.99
    assert abs(recall(pi, gt) - recall(ji, gt)) <= 0.002
    for key in ("hops", "distance_computations"):
        a, b = ps.last_stats[key], js.last_stats[key]
        assert abs(a - b) <= 0.01 * b, (key, a, b)
    same = pi == ji
    assert np.all(np.abs(pd[same] - jd[same]) <= 1e-4 * (1 + np.abs(jd[same])))


# ---- the insertion build (test_torch_insert.py, test_torch_hnsw_search.py)

INS_CFG = HnswConfig(M=8, ef_construction=48)
INS_BATCH = 256
INS_EF = 32  # search ef of the recorded JAX results
CAPTURE_ID0 = 2560  # first id of the recorded batch (ids 2560..2815)


def insert_dataset():
    """(base f32[3000, 16], queries f32[128, 16]): tests/test_build.py's
    insertion-build data (clustered, seed 3) with queries drawn after it."""
    return clustered(3000, 16, n_queries=128, seed=3)


def _np(a):
    return np.array(a)  # a host copy (JAX may donate the device buffer)


def jax_insert_dir(tmp_path_factory):
    """Directory holding the JAX insertion build of insert_dataset() with
    INS_CFG and max_batch INS_BATCH (hnsw_insert.npz, save_hnsw) and
    capture.npz: for the batch starting at CAPTURE_ID0, the pre-batch
    adjacency and degrees of every level, the inputs and outputs of that
    batch's _build_search0, _build_search and apply_insert calls, and the
    JAX search of the built graph (ef INS_EF, k 10). Built once per session
    under a file lock, as jax_graph_dir."""
    from hnsw_slim_tpu.graph import build as jb
    from hnsw_slim_tpu.graph import revconn as jr
    from hnsw_slim_tpu.index.hnsw import HnswIndex
    from hnsw_slim_tpu.persist.checkpoint import save_hnsw

    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    d = root / "torch_parity_insert"
    d.mkdir(exist_ok=True)
    with open(d / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (d / "capture.npz").exists():
            return d
        rec: dict = {}
        applies: list = []  # the recorded batch's applies, top level first
        on = [False]
        batch, s0, s1, ap = (jb.HnswBuilder._insert_batch_bulk,
                             jb._build_search0, jb._build_search,
                             jr.apply_insert)

        def batch_w(self, ids, levels, entry, cur_maxlevel, vecs, vn,
                    adj_dev, deg_dev, lmax, collect=None):
            on[0] = int(ids[0]) == CAPTURE_ID0
            if on[0]:
                rec.update(ids=_np(ids), entry=entry, lmax=lmax,
                           cur_maxlevel=cur_maxlevel, vn=_np(vn))
                for l, (a, g) in enumerate(zip(adj_dev, deg_dev)):
                    rec[f"adj{l}"], rec[f"deg{l}"] = _np(a), _np(g)
            try:
                return batch(self, ids, levels, entry, cur_maxlevel, vecs, vn,
                             adj_dev, deg_dev, lmax, collect)
            finally:
                on[0] = False
                for i, got in enumerate(applies):  # levels top .. 0
                    l = len(applies) - 1 - i
                    rec.update({f"ap{l}_{k}": v for k, v in got.items()})
                applies.clear()

        def s0_w(adjs, entry, vectors, vn, q, active, **kw):
            out = s0(adjs, entry, vectors, vn, q, active, **kw)
            if on[0]:
                rec.update(s0_q=_np(q), s0_active=_np(active),
                           s0_d=_np(out[0]), s0_i=_np(out[1]))
            return out

        def s1_w(adjs, entry, vectors, vn, q, lp_eff, **kw):
            out = s1(adjs, entry, vectors, vn, q, lp_eff, **kw)
            if on[0]:
                rec.update(s1_q=_np(q), s1_lp=_np(lp_eff), s1_d=_np(out[0]),
                           s1_i=_np(out[1]))
            return out

        def ap_w(adj, deg, vecs, vn, a_pad, cand, n_valid, **kw):
            got = {}
            if on[0]:
                got.update(adj=_np(adj), deg=_np(deg), a=_np(a_pad),
                           cand=_np(cand), nv=int(n_valid), of_t=kw["of_t"],
                           new_w=kw["new_w"])
            out = ap(adj, deg, vecs, vn, a_pad, cand, n_valid, **kw)
            if on[0]:
                got.update(out_adj=_np(out[0]), out_deg=_np(out[1]),
                           of_e=int(out[2]), of_tc=int(out[3]))
                applies.append(got)
            return out

        base, queries = insert_dataset()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jb.HnswBuilder, "_insert_batch_bulk", batch_w)
            mp.setattr(jb, "_build_search0", s0_w)
            mp.setattr(jb, "_build_search", s1_w)
            mp.setattr(jr, "apply_insert", ap_w)
            h = HnswIndex(INS_CFG, max_batch=INS_BATCH, strategy="insert")
            h.build(base)
        h.set_ef(INS_EF)
        rec["search_d"], rec["search_i"] = h.search(queries, 10)
        rec["search_hops"] = h.last_stats["hops"]
        rec["search_dcomp"] = h.last_stats["distance_computations"]
        save_hnsw(d / "hnsw_insert.npz", h)
        np.savez(d / "capture.tmp.npz", **rec)
        os.replace(d / "capture.tmp.npz", d / "capture.npz")
    return d
