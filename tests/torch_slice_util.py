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
import struct

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


# ---- the update path (test_torch_updates.py, test_torch_incremental.py,
# ---- test_torch_patch.py)

UPD_CFG = HnswConfig(M=8, ef_construction=48, branching_factor="8", seed=5)
UPD_SLIM = SlimConfig(top_M0=10, low_m0=4, top_M=6, low_m=3)
UPD_BATCH = 512  # max_batch of the JAX build
UPD_ADD, UPD_REP = 120, 60  # points per add batch, reused slots
UPD_STEPS = 4  # three add batches, then one replace batch
UPD_EF = 48
INC_KEYS = ("budgets", "stage2", "keys", "final")  # per-level state lists


def replay_padding_fault(monkeypatch):
    """Replays the JAX insert batch's padding fault in the port (ROADMAP
    queue 3): the first upper-level insert of a batch gets only the entry
    point as its level-0 candidates. It lives in the bulk insert batch
    (builds, add_points), not in the host-planned one (replace_points).
    Returns the port's unpatched _build_search."""
    from hnsw_slim_tpu_torch.graph import build as tb

    real = tb._build_search

    def faulty(adjs, entry, vectors, vn, q, lp_eff, **kw):
        d, ids = real(adjs, entry, vectors, vn, q, lp_eff, **kw)
        d, ids = d.clone(), ids.clone()
        ids[0, 0] = -1
        ids[0, 0, 0] = entry
        d[0, 0] = float("inf")
        return d, ids

    monkeypatch.setattr(tb, "_build_search", faulty)
    return real


def update_dataset():
    """(base f32[2500, 24], three add batches f32[3, 120, 24], reused slots
    int64[60], their vectors f32[60, 24], queries f32[64, 24]): normal
    draws, seed 3, as tests/test_incremental.py draws its data."""
    rng = np.random.default_rng(3)
    base = rng.standard_normal((2500, 24)).astype(np.float32)
    adds = rng.standard_normal((3, UPD_ADD, 24)).astype(np.float32)
    slots = np.sort(rng.choice(2500, size=UPD_REP, replace=False))
    rep = rng.standard_normal((UPD_REP, 24)).astype(np.float32)
    queries = rng.standard_normal((64, 24)).astype(np.float32)
    return base, adds, slots.astype(np.int64), rep, queries


def inc_state(inc, zero=False) -> dict:
    """The state arrays of an IncrementalSlim / IncrementalSlimZero of
    either engine, as a flat dict of numpy arrays (copies: the objects
    update their arrays in place)."""
    out = dict(thr=np.array(inc.thr), levels=np.array(inc.levels),
               entry=np.int64(inc.entry), lmax=np.int64(inc.lmax),
               caps=np.array(inc.caps))
    if not zero:
        out.update(out_ws=np.array(inc.out_ws),
                   repair_keys=np.array(inc.repair_keys))
    for key in ("budgets", "final") if zero else INC_KEYS:
        for l, a in enumerate(getattr(inc, key)):
            out[f"{key}_{l}"] = np.array(a)
    out.update({f"chal_{k}": np.array(v)
                for k, v in inc.host_chal.items()})
    return out


def state_lists(flat: dict, zero=False) -> dict:
    """inc_state's flat dict back into per-level lists (the argument of
    the port's incremental_from_state)."""
    out = {k: flat[k] for k in ("thr", "levels", "entry", "lmax", "caps")}
    if not zero:
        out.update(out_ws=flat["out_ws"], repair_keys=flat["repair_keys"])
    for key in ("budgets", "final") if zero else INC_KEYS:
        out[key] = [flat[f"{key}_{l}"] for l in range(int(flat["lmax"]) + 1)]
    return out


def take(z: dict, prefix: str) -> dict:
    """The entries of a flat record under ``prefix``, prefix removed."""
    return {k[len(prefix):]: v for k, v in z.items() if k.startswith(prefix)}


def patch_chunks(writer, limit: int) -> list:
    chunks, finished = [], False
    while not finished:
        blob, finished = writer.next_chunk(limit)
        chunks.append(blob)
    return chunks


def server_patch_sets(changed, prev_count: int, n_now: int, reused):
    """(changed_old, changed_new) as the JAX server classes them: reused
    slots ship their new vectors, so they count as new."""
    reused_set = set(int(v) for v in reused)
    old = sorted(int(v) for v in changed
                 if v < prev_count and int(v) not in reused_set)
    new = sorted(set(range(prev_count, n_now)) | reused_set)
    return old, new


def jax_update_dir(tmp_path_factory):
    """Directory holding the JAX package's run of the update path on
    update_dataset(): an insertion build with UPD_CFG (hnsw0.npz), three
    add_points batches and one replace_points batch (hnsw{1..4}.npz through
    save_hnsw), and rec.npz with, for step s = 1..4, the inputs the JAX
    IncrementalSlim / IncrementalSlimZero update saw (s{s}_adj{l},
    s{s}_levels, s{s}_entry, s{s}_touched, s{s}_level_changed), the states
    after full (i0_*, z0_*) and after each update (i{s}_*, z{s}_*) with the
    changed ids, the patch chunks of steps 1 and 4 (with and without
    vectors, limit 3000 B and one chunk), compute_diff of step 1, and the
    final Slim search (ef UPD_EF, k 10). Built once per test run under a
    file lock, as jax_graph_dir."""
    import jax.numpy as jnp

    from hnsw_slim_tpu.graph.incremental import (IncrementalSlim,
                                                  IncrementalSlimZero)
    from hnsw_slim_tpu.index.hnsw import HnswIndex
    from hnsw_slim_tpu.index.slim import HnswSlimIndex
    from hnsw_slim_tpu.persist import patch as jpatch
    from hnsw_slim_tpu.persist.checkpoint import save_hnsw

    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    d = root / "torch_parity_update"
    d.mkdir(exist_ok=True)
    with open(d / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (d / "rec.npz").exists():
            return d
        base, adds, slots, rep, queries = update_dataset()
        rec: dict = {}
        h = HnswIndex(UPD_CFG, strategy="insert", max_batch=UPD_BATCH)
        h.build(base)
        save_hnsw(d / "hnsw0.npz", h)
        inc = IncrementalSlim(UPD_SLIM, metric="l2")
        zinc = IncrementalSlimZero(UPD_SLIM, metric="l2")

        def args():
            return (h.host_adj(), np.asarray(h.levels),
                    int(np.asarray(h.graph.entry)), h.vectors, h.vn)

        g_prev = inc.full(*args())
        zinc.full(*args())
        rec.update({f"i0_{k}": v for k, v in inc_state(inc).items()})
        rec.update({f"z0_{k}": v for k, v in inc_state(zinc, True).items()})
        vec_np = base.copy()
        for s in range(1, UPD_STEPS + 1):
            prev_count = h.graph.n
            lc = np.zeros(0, np.int64)
            reused = np.zeros(0, np.int64)
            if s <= 3:
                touched = h.add_points(adds[s - 1])
                vec_np = np.concatenate([vec_np, adds[s - 1]])
            else:
                touched, lc = h.replace_points(slots, rep)
                vec_np[slots] = rep
                reused = slots
            save_hnsw(d / f"hnsw{s}.npz", h)
            adj, lv, entry, _, _ = args()
            for l, a in enumerate(adj):
                rec[f"s{s}_adj{l}"] = np.array(a)
            rec.update({f"s{s}_levels": np.array(lv), f"s{s}_entry": entry,
                        f"s{s}_touched": touched, f"s{s}_level_changed": lc,
                        f"s{s}_vectors": np.array(h.vectors)})
            g_new, changed = inc.update(*args(), touched=touched,
                                        level_changed=lc)
            _, zchanged = zinc.update(*args(), touched=touched,
                                      level_changed=lc)
            rec.update({f"i{s}_{k}": v for k, v in inc_state(inc).items()})
            rec.update({f"z{s}_{k}": v
                        for k, v in inc_state(zinc, True).items()})
            rec[f"i{s}_changed"], rec[f"z{s}_changed"] = changed, zchanged
            if s in (1, 4):
                old, new = server_patch_sets(changed, prev_count, h.graph.n,
                                             reused)
                for tag, vecs in (("v", vec_np), ("n", None)):
                    for lim in (3000, 1 << 30):
                        w = jpatch.PatchWriter(g_new, old, new, vectors=vecs,
                                               host_chal=inc.host_chal)
                        chunks = patch_chunks(w, lim)
                        rec[f"p{s}{tag}{lim}_len"] = np.array(
                            [len(c) for c in chunks])
                        rec[f"p{s}{tag}{lim}"] = np.frombuffer(
                            b"".join(chunks), np.uint8)
                rec[f"p{s}_vectors"] = vec_np.copy()
            if s == 1:
                d_old, d_new = jpatch.compute_diff(g_prev, g_new)
                rec["diff_old"], rec["diff_new"] = (np.asarray(d_old),
                                                    np.asarray(d_new))
            g_prev = g_new
        slim = HnswSlimIndex(metric="l2")
        slim.graph, slim.vectors, slim.vn = g_prev, h.vectors, h.vn
        slim.set_ef(UPD_EF)
        rec["search_d"], rec["search_i"] = slim.search(queries, 10)
        np.savez(d / "rec.tmp.npz", **rec)
        os.replace(d / "rec.tmp.npz", d / "rec.npz")
    return d


# ---- union and sharded serving, the bfloat16 store (test_torch_union.py,
# ---- test_torch_sharded.py, test_torch_bf16.py)

SHARD_S = 4
SHARD_CFG = HnswConfig(M=8, ef_construction=32)  # tests/test_sharded.py's
SHARD_EF, SHARD_K = 32, 5
UNION_CFG = HnswConfig(M=8, ef_construction=48)  # tests/test_flat_union.py's
UNION_SLIM = SlimConfig(top_M0=10, low_m0=4, top_M=6, low_m=3)
UNION_EF, UNION_K, UNION_SW = 48, 5, 16
BF16_CFG = HnswConfig(M=16, ef_construction=100, ef_search=64,
                      store_dtype="bfloat16")  # tests/test_build.py's
BF16_ADD = 120  # points of the add_points batch on the bfloat16 index


def shard_dataset():
    """(base f32[1600, 16], queries f32[64, 16]): tests/test_sharded.py's
    prebuilt-shards data (clustered, seed 44) with 64 queries."""
    return clustered(1600, 16, n_queries=64, seed=44)


def short_dataset():
    """(base f32[997, 16], queries f32[32, 16]): the first 997 points of
    tests/test_sharded.py's save/load data (clustered, seed 43), so the last
    of 4 shards is padded."""
    base, q = clustered(1000, 16, n_queries=32, seed=43)
    return base[:997], q


def union_dataset():
    """(base f32[2400, 24], queries f32[64, 24]): tests/test_flat_union.py's
    normal draws (seed 4)."""
    rng = np.random.default_rng(4)
    base = rng.standard_normal((2400, 24)).astype(np.float32)
    queries = rng.standard_normal((64, 24)).astype(np.float32)
    return base, queries


def bf16_dataset():
    """(base f32[3000, 32], queries f32[50, 32], an add batch f32[120, 32]):
    tests/test_build.py's bfloat16-store data (clustered, seed 13) and a
    batch drawn around the same centres (seed 14)."""
    base, queries = clustered(3000, 32, n_queries=50, seed=13)
    add, _ = clustered(BF16_ADD, 32, seed=14)
    return base, queries, add


def round_robin(n: int, s: int, si: int) -> np.ndarray:
    return np.arange(si, n, s, dtype=np.int32)


def _session_dir(tmp_path_factory, name):
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    d = root / name
    d.mkdir(exist_ok=True)
    return d


def _search_rec(rec, tag, idx, queries, k):
    d, i = idx.search(queries, k)
    rec[f"{tag}_d"], rec[f"{tag}_i"] = np.asarray(d), np.asarray(i)
    rec[f"{tag}_hops"] = idx.last_stats["hops"]
    rec[f"{tag}_dcomp"] = idx.last_stats["distance_computations"]


def jax_shard_dir(tmp_path_factory):
    """Directory of the JAX package's sharded serving on its 8-device CPU
    mesh (make_mesh(8, dp=2): 4 shards): shard{i}.npz (save_slim of the 4
    round-robin shard indexes of shard_dataset(), SHARD_CFG and
    SlimConfig.from_ratios()), sharded.npz (ShardedSlimIndex.save of their
    from_indexes assembly), sharded997.npz (ShardedSlimIndex.build on
    short_dataset()), port_loaded.npz (what the JAX engine returns for a
    file the port saved: ported.npz) and rec.npz: the searches (SHARD_EF,
    k SHARD_K: d, ids, hops, dcomp) of the assembly without and with both
    dense layouts, of the 997-point index and of the port's file, and
    index_size. Built once per test run under a file lock."""
    from hnsw_slim_tpu.config import SearchConfig as JSearchConfig
    from hnsw_slim_tpu.index.slim import HnswSlimIndex as JSlim
    from hnsw_slim_tpu.parallel import sharded as jsh
    from hnsw_slim_tpu.persist.checkpoint import save_slim as jsave
    from hnsw_slim_tpu_torch.parallel import sharded as psh
    from hnsw_slim_tpu_torch.persist.checkpoint import load_slim as pload

    d = _session_dir(tmp_path_factory, "torch_parity_sharded")
    with open(d / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (d / "rec.npz").exists():
            return d
        rec: dict = {}
        mesh = jsh.make_mesh(8, dp=2)
        scfg = JSearchConfig(ef=SHARD_EF)
        base, queries = shard_dataset()
        shards = []
        for si in range(SHARD_S):
            gids = round_robin(len(base), SHARD_S, si)
            idx = JSlim.build(base[gids], SHARD_CFG, SlimConfig.from_ratios())
            jsave(d / f"shard{si}.npz", idx)
            shards.append((idx, gids))
        sh = jsh.ShardedSlimIndex.from_indexes(mesh, shards, search_cfg=scfg)
        rec["index_size"] = sh.index_size()
        _search_rec(rec, "chal", sh, queries, SHARD_K)
        sh.save(d / "sharded.npz")
        sh.densify_level0()
        sh.densify_upper()
        _search_rec(rec, "dense", sh, queries, SHARD_K)
        # the port's assembly of the same shards, saved by the port and
        # served by the JAX engine
        pm = psh.make_mesh(SHARD_S)
        ps = psh.ShardedSlimIndex.from_indexes(
            pm, [(pload(d / f"shard{si}.npz", device="cpu"), g)
                 for si, (_, g) in enumerate(shards)],
            search_cfg=scfg, device="cpu")
        ps.densify_level0()
        ps.densify_upper()
        ps.save(d / "ported.npz")
        _search_rec(rec, "port_file",
                    jsh.ShardedSlimIndex.load(d / "ported.npz", mesh,
                                              search_cfg=scfg),
                    queries, SHARD_K)
        base2, q2 = short_dataset()
        s2 = jsh.ShardedSlimIndex(mesh, search_cfg=scfg)
        s2.build(base2, hnsw_cfg=SHARD_CFG)
        s2.save(d / "sharded997.npz")
        _search_rec(rec, "short", s2, q2, SHARD_K)
        np.savez(d / "rec.tmp.npz", **rec)
        os.replace(d / "rec.tmp.npz", d / "rec.npz")
    return d


def jax_union_dir(tmp_path_factory):
    """Directory of the JAX package's FlatUnionIndex over the 4 round-robin
    shards of union_dataset() (UNION_CFG, UNION_SLIM; shard{i}.npz by
    save_slim) and rec.npz: its searches (ef UNION_EF, k UNION_K) with
    seed_width 0 and UNION_SW, on the flat CHAL arrays and with both dense
    layouts, hbm_bytes before and after them and index_size, and the same
    searches and sizes of the bfloat16 union (its store's bits as uint16).
    Built once per test run under a file lock."""
    from hnsw_slim_tpu.config import SearchConfig as JSearchConfig
    from hnsw_slim_tpu.index.slim import HnswSlimIndex as JSlim
    from hnsw_slim_tpu.parallel.flat_union import FlatUnionIndex as JUnion
    from hnsw_slim_tpu.persist.checkpoint import save_slim as jsave

    d = _session_dir(tmp_path_factory, "torch_parity_union")
    with open(d / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (d / "rec.npz").exists():
            return d
        rec: dict = {}
        base, queries = union_dataset()
        shards = []
        for si in range(SHARD_S):
            gids = round_robin(len(base), SHARD_S, si)
            idx = JSlim.build(base[gids], UNION_CFG, UNION_SLIM)
            jsave(d / f"shard{si}.npz", idx)
            shards.append((idx, gids))
        for dt in ("float32", "bfloat16"):
            u = JUnion.from_indexes(shards, search_cfg=JSearchConfig(
                ef=UNION_EF), store_dtype=dt)
            rec[f"{dt}_bits"] = np.asarray(u.vectors).view(
                np.uint16 if dt == "bfloat16" else np.uint32)
            rec[f"{dt}_index_size"] = u.index_size()
            rec[f"{dt}_hbm_chal"] = u.hbm_bytes()
            for lay in ("chal", "dense"):
                if lay == "dense":
                    u.densify_level0()
                    u.densify_upper()
                    rec[f"{dt}_hbm_dense"] = u.hbm_bytes()
                for sw in (0, UNION_SW):
                    u.scfg = dataclasses.replace(u.scfg, seed_width=sw)
                    _search_rec(rec, f"{dt}_{lay}_sw{sw}", u, queries,
                                UNION_K)
        np.savez(d / "rec.tmp.npz", **rec)
        os.replace(d / "rec.tmp.npz", d / "rec.npz")
    return d


def jax_bf16_dir(tmp_path_factory):
    """Directory of the JAX package's bfloat16-store HnswIndex on
    bf16_dataset() (BF16_CFG, max_batch 512, NN-descent): hnsw.npz
    (save_hnsw: the store as raw bf16 words), slim.npz (save_slim of its
    SlimConfig.from_ratios() conversion), hnsw_add.npz (save_hnsw after
    one add_points batch of BF16_ADD points) and rec.npz: the store's bits
    (uint16), the vanilla search (ef 64, k 10), the seeded Slim search
    (SearchConfig(ef=64, pop_width=8, seed_width=32), k 10), and the
    add_points result (touched ids). Built once per test run under a file
    lock."""
    from hnsw_slim_tpu.config import SearchConfig as JSearchConfig
    from hnsw_slim_tpu.index.hnsw import HnswIndex as JHnsw
    from hnsw_slim_tpu.index.slim import HnswSlimIndex as JSlim
    from hnsw_slim_tpu.persist.checkpoint import save_hnsw, save_slim

    d = _session_dir(tmp_path_factory, "torch_parity_bf16")
    with open(d / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (d / "rec.npz").exists():
            return d
        rec: dict = {}
        base, queries, add = bf16_dataset()
        h = JHnsw(BF16_CFG, max_batch=512)
        h.build(base)
        rec["bits"] = np.asarray(h.vectors).view(np.uint16)
        save_hnsw(d / "hnsw.npz", h)
        _search_rec(rec, "vanilla", h, queries, 10)
        s = JSlim.from_hnsw(h, SlimConfig.from_ratios(), search_cfg=JSearchConfig(
            ef=64, pop_width=8, seed_width=32))
        save_slim(d / "slim.npz", s)
        _search_rec(rec, "slim", s, queries, 10)
        rec["touched"] = h.add_points(add)
        save_hnsw(d / "hnsw_add.npz", h)
        np.savez(d / "rec.tmp.npz", **rec)
        os.replace(d / "rec.tmp.npz", d / "rec.npz")
    return d


# ---- reference graph dumps (test_torch_import_ref.py)

def _runs(counts: np.ndarray):
    """(owner, position) of every element of runs of the given lengths."""
    owner = np.repeat(np.arange(len(counts)), counts)
    starts = np.cumsum(counts) - counts
    return owner, np.arange(len(owner)) - starts[owner]


def write_ref_slim_dump(path, nbr, lvl_off, level, *, entry, max_level,
                        threshold_level, cap, cap0):
    """A CHAL graph in parity/ref_harness.cc's dump_slim_graph format:
    header, then per node its level, its total neighbour count, the end
    offset of each of its levels 0..level, and its ids."""
    nbr, level = np.asarray(nbr), np.asarray(level, np.int64)
    off = np.asarray(lvl_off, np.int64)
    n = len(level)
    start = off[:, 0]
    ends = off[:, 1:] - start[:, None]
    total = ends[np.arange(n), level]
    words = 3 + level + total
    at = np.cumsum(words) - words
    out = np.empty(int(words.sum()), np.int32)
    out[at], out[at + 1] = level, total
    v, l = _runs(level + 1)
    out[at[v] + 2 + l] = ends[v, l]
    v, j = _runs(total)
    out[at[v] + 3 + level[v] + j] = nbr[start[v] + j]
    with open(path, "wb") as f:
        f.write(struct.pack("<IIiIiII", 0x48534C47, n, max_level, entry,
                            threshold_level, cap, cap0))
        f.write(out.tobytes())


def write_ref_hnsw_dump(path, adjs, level, *, entry, max_level, maxm,
                        maxm0):
    """A per-level adjacency (rows -1 padded) in dump_hnsw_graph's format:
    header, then per node its level and, for each level 0..level, the count
    of its ids and the ids."""
    level = np.asarray(level, np.int64)
    n = len(level)
    cnt = np.zeros((n, max_level + 1), np.int64)
    for l, a in enumerate(adjs):
        cnt[level >= l, l] = (np.asarray(a)[level >= l] >= 0).sum(1)
    per_level = np.where(np.arange(max_level + 1)[None] <= level[:, None],
                         1 + cnt, 0)
    words = 1 + per_level.sum(1)
    at = np.cumsum(words) - words
    out = np.empty(int(words.sum()), np.int32)
    out[at] = level
    before = 1 + np.cumsum(per_level, axis=1) - per_level  # level l's block
    for l, a in enumerate(adjs):
        rows = np.nonzero(level >= l)[0]
        pos = at[rows] + before[rows, l]
        out[pos] = cnt[rows, l]
        a = np.asarray(a)[rows]
        keep = a >= 0
        col = np.cumsum(keep, axis=1) - 1  # rows packed left in the dump
        r, c = np.nonzero(keep)
        out[pos[r] + 1 + col[r, c]] = a[r, c]
    with open(path, "wb") as f:
        f.write(struct.pack("<IIiIII", 0x484E5347, n, max_level, entry, maxm,
                            maxm0))
        f.write(out.tobytes())
