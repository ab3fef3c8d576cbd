"""HNSW construction (port of hnsw_slim_tpu/graph/build.py): the insertion
build and the NN-descent build.

Insertion (``HnswBuilder``, hnswalg.h addPoint in bulk-synchronous rounds):
a batch of points searches the frozen pre-batch graph — greedy descent above
each point's level (kernel Kε), an ef_construction beam at and below it
(kernel Kβ) — then each level applies all of the batch's forward and reverse
connections at once (``revconn.apply_insert``: Kγ + Kζ). Adjacency and
degrees stay on the device for the whole build; the host mirror is pulled
once at the end. ``collect`` mode (``HnswIndex.add_points``) records which
rows each level's apply wrote; ``_insert_batch`` is the host-planned form
for ids that are not consecutive (``HnswIndex.replace_points``), which also
keeps a host mirror of the adjacency in step.

NN-descent: kNN lists -> heuristic prune (Kγ) + mutual union at level 0;
exact kNN (Kα, self masked) + the same prune and union at the small upper
levels; a host-side connectivity repair (scipy) after each.

Where the JAX code draws with numpy (level sampling, the hop2 and random
long-range candidates) the port draws the same way with the same seeds.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import HnswConfig

from ..index.bruteforce import topk_dist
from ..ops.distance import gathered_dist, sq_norms
from ..ops.sort import dedup_pairs, lexsort_stable, run_scatter
from . import revconn
from . import search as gs
from .heuristic import prune_all, prune_batch
from .types import LevelGraph

INF = float("inf")


def sample_levels(n: int, mult: float, seed: int, cap: int = 12) -> np.ndarray:
    """Geometric level sampling (hnswalg.h getRandomLevel)."""
    rng = np.random.default_rng(seed)
    u = rng.random(n)
    u = np.clip(u, 1e-12, 1.0)
    return np.minimum((-np.log(u) * mult).astype(np.int32), cap)


def mutual_union(sel: torch.Tensor, d_sel: torch.Tensor, *, w_union: int):
    """Symmetrize pruned forward edges and keep each node's w_union nearest:
    dedup (src, tgt) pairs, rank by distance within each src. Returns rows
    i32[N, w_union] (-1 padded, ascending distance) and counts i32[N].

    On the card: a lexsort by (src, tgt) (two Kκ passes), the duplicate
    mark (Kμ dedup mode), a lexsort by (src, distance) (Kκ over the f32
    distances, then src), the ranked scatter (Kμ) and the row counts (Kθ).
    CPU tensors take each kernel's plain version."""
    from ..index.hnsw import _row_deg

    n, m = sel.shape
    dev = sel.device
    src1 = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(m)
    tgt1 = sel.reshape(-1).to(torch.int32)
    valid = tgt1 >= 0
    ok = torch.cat([valid, valid])
    src_m = torch.where(ok, torch.cat([src1, tgt1]), n).contiguous()
    tgt_m = torch.where(ok, torch.cat([tgt1, src1]), n).contiguous()
    dd = torch.cat([d_sel.reshape(-1)] * 2).to(torch.float32)
    bits = max(1, n.bit_length())  # ids and the drop key n
    s1, o = lexsort_stable(src_m, tgt_m, bits)
    t1s = torch.index_select(tgt_m, 0, o)
    d1s = torch.index_select(dd, 0, o)
    s2, o = lexsort_stable(dedup_pairs(s1, t1s, n), d1s, bits)
    rows = run_scatter(s2, torch.index_select(t1s, 0, o), n, w_union)
    return rows, _row_deg(rows)


def _edge_dists(q, qn, vectors, vn, sel, metric):
    """Exact distances q[i] -> vectors[sel[i, j]]; inf where sel < 0 (K1,
    which reads the rows by id)."""
    return gathered_dist(q, vectors, metric, qn=qn, vn=vn,
                         ids=sel.to(torch.int32).contiguous())


def level0_candidates(knn_ids: np.ndarray, hop2: int = 0,
                      seed: int = 0) -> np.ndarray:
    """knn_to_level0's candidate lists: each node's kNN plus hop2 2-hop and
    hop2 random candidates, drawn with numpy as the JAX code draws them.
    Returns i32[N, K + 2*hop2] (-1 = no candidate)."""
    n = knn_ids.shape[0]
    if hop2 > 0:
        rng = np.random.default_rng(seed)
        kk = knn_ids.shape[1]
        r1 = rng.integers(0, kk, (n, hop2))
        r2 = rng.integers(0, kk, (n, hop2))
        mid = np.take_along_axis(knn_ids, r1, axis=1)
        h2 = np.where(
            mid >= 0, knn_ids.reshape(-1)[np.maximum(mid, 0) * kk + r2], -1
        )
        rnd = rng.integers(0, n, (n, hop2)).astype(np.int32)
        knn_ids = np.concatenate([knn_ids, h2, rnd], axis=1)
    return knn_ids.astype(np.int32)


def level0_union(vectors, vn, sel: torch.Tensor, cap0: int, metric: str):
    """Symmetrize the pruned level-0 lists sel i32[N, M]. Returns the union
    rows i32[N, cap0+16] and the re-prune budgets i32[N]: cap0 where a row
    overflows cap0, else its count + 1 (hnswlib appends without pruning
    until a row overflows)."""
    n = sel.shape[0]
    d_sel = torch.cat([
        _edge_dists(vectors[s:s + 65536], vn[s:s + 65536], vectors, vn,
                    sel[s:s + 65536], metric)
        for s in range(0, n, 65536)
    ])
    rows, counts = mutual_union(sel, d_sel, w_union=cap0 + 16)
    return rows, torch.where(counts > cap0, cap0, counts + 1).to(torch.int32)


def knn_to_level0(vectors, vn, knn_ids, M: int, cap0: int, metric: str,
                  hop2: int = 0, seed: int = 0):
    """kNN lists (numpy) -> navigable level-0 adjacency: heuristic-prune each
    node's kNN (+hop2 2-hop and random candidates) to M, symmetrize, re-prune
    overflowing rows to cap0. Returns numpy i32[N, cap0]."""
    n = knn_ids.shape[0]
    dev = vectors.device
    base = torch.arange(n, dtype=torch.int32, device=dev)
    sel = prune_all(
        vectors, vn, base,
        torch.as_tensor(level0_candidates(knn_ids, hop2, seed), device=dev),
        torch.full((n,), M, dtype=torch.int32, device=dev),
        M=M, keep_all_under_m=True, metric=metric, keep_pruned=True,
    )
    rows, m_row = level0_union(vectors, vn, sel, cap0, metric)
    out = prune_all(vectors, vn, base, rows, m_row, M=cap0,
                    keep_all_under_m=True, metric=metric, out_width=cap0)
    return out.cpu().numpy()


def _exact_knn_subset(vectors, vn, sub_ids: np.ndarray, k: int, metric: str):
    """Exact kNN among a node subset, self excluded (Kα with the self mask).
    Returns global ids i32[S, k] and dists f32[S, k] (numpy)."""
    s = len(sub_ids)
    sub = torch.as_tensor(sub_ids, device=vectors.device).long()
    sv = vectors[sub].contiguous()
    svn = vn[sub].contiguous()
    k_eff = min(k, s - 1)
    out_i = np.full((s, k), -1, np.int32)
    out_d = np.full((s, k), np.inf, np.float32)
    for st in range(0, s, 65536):
        e = min(st + 65536, s)
        d, pos = topk_dist(sv[st:e], sv, svn, k_eff, metric, self_offset=st,
                           qn=svn[st:e])
        out_i[st:e, :k_eff] = sub_ids[pos.cpu().numpy()]
        out_d[st:e, :k_eff] = d.cpu().numpy()
    return out_i, out_d


def build_by_nnd(cfg: HnswConfig, vectors: torch.Tensor, vn: torch.Tensor,
                 nnd_k: int = 0, nnd_rounds: int = 25, hop2: int = 16,
                 verbose: bool = False):
    """NN-descent kNN graph -> heuristic prune + mutual union at level 0;
    exact kNN + the same prune at the upper levels. Runs on the device of
    ``vectors``. Returns (LevelGraph, levels)."""
    from .nnd import nn_descent

    n = vectors.shape[0]
    dev = vectors.device
    levels = sample_levels(n, cfg.mult, cfg.seed)
    lmax = int(levels.max(initial=0))
    k = nnd_k or max(cfg.maxM0, 48)
    knn_ids, _ = nn_descent(vectors, vn, k=k, rounds=nnd_rounds,
                            metric=cfg.metric, seed=cfg.seed, verbose=verbose)
    adj0 = knn_to_level0(vectors, vn, knn_ids.cpu().numpy(), M=cfg.M,
                         cap0=cfg.maxM0, metric=cfg.metric, hop2=hop2,
                         seed=cfg.seed)
    adj0 = repair_connectivity(adj0, np.arange(n, dtype=np.int32), vectors,
                               cfg.metric)
    adjs = [adj0]
    for l in range(1, lmax + 1):
        sub = np.nonzero(levels >= l)[0].astype(np.int32)
        full = np.full((n, cfg.maxM), -1, np.int32)
        if len(sub) > 1:
            ki, _ = _exact_knn_subset(vectors, vn, sub, min(k, len(sub) - 1),
                                      cfg.metric)
            rows = _subset_prune_union(vectors, vn, sub, ki, cfg.M, cfg.maxM,
                                       cfg.metric)
            full[sub] = repair_connectivity(rows, sub, vectors, cfg.metric)
        adjs.append(full)
    # enterpoint: first node at the top level (hnswalg.h enterpoint_node_)
    top = np.nonzero(levels == lmax)[0]
    entry = int(top[0]) if len(top) else 0
    return LevelGraph.from_numpy(adjs, levels, entry=entry, max_level=lmax,
                                 device=dev), levels


def _subset_prune_union(vecs, vn, sub_ids, knn_rows, M, cap, metric,
                        rand_cands: int = 16):
    """Prune+symmetrize a subset's kNN rows (global ids); returns [S, cap]."""
    s = len(sub_ids)
    dev = vecs.device
    if rand_cands > 0 and s > 2:
        rng = np.random.default_rng(1)
        rnd = sub_ids[rng.integers(0, s, (s, min(rand_cands, s - 1)))]
        knn_rows = np.concatenate([knn_rows, rnd.astype(np.int32)], axis=1)
    base = torch.as_tensor(sub_ids, device=dev)
    cand = torch.as_tensor(knn_rows, device=dev)
    sel, _ = prune_batch(vecs, vn, base, cand, cand >= 0, M=M,
                         keep_all_under_m=True, metric=metric,
                         keep_pruned=True)
    sel = sel.cpu().numpy()
    # map to local ids for the union, then back
    lookup = np.full(int(vecs.shape[0]), -1, np.int32)
    lookup[sub_ids] = np.arange(s, dtype=np.int32)
    loc = np.where(sel >= 0, lookup[np.maximum(sel, 0)], -1).astype(np.int32)
    sub_t = base.long()
    d_sel = _edge_dists(vecs[sub_t], vn[sub_t], vecs, vn,
                        torch.as_tensor(sel, device=dev), metric)
    rows_l, counts = mutual_union(torch.as_tensor(loc, device=dev), d_sel,
                                  w_union=cap + 8)
    rows_l = rows_l.cpu().numpy()
    counts = counts.cpu().numpy()
    rows_g = np.where(rows_l >= 0, sub_ids[np.maximum(rows_l, 0)], -1)
    m_row = np.where(counts > cap, cap, counts + 1).astype(np.int32)
    cand = torch.as_tensor(rows_g.astype(np.int32), device=dev)
    out, _ = prune_batch(vecs, vn, base, cand, cand >= 0, M=cap,
                         keep_all_under_m=True, metric=metric, out_width=cap,
                         m_per_row=torch.as_tensor(m_row, device=dev))
    return out.cpu().numpy()


def _components(rows: np.ndarray, node_ids: np.ndarray | None = None) -> np.ndarray:
    """Connected-component labels over an undirected view of `rows` (scipy
    csgraph). rows i32[S, W] hold global ids; node_ids maps row index ->
    global id (identity if None)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    s, w = rows.shape
    src = np.repeat(np.arange(s), w)
    tgt = rows.reshape(-1).astype(np.int64)
    m = tgt >= 0
    src, tgt = src[m], tgt[m]
    if node_ids is not None:
        lookup = np.full(int(node_ids.max(initial=0)) + 2, -1, np.int64)
        lookup[node_ids] = np.arange(s)
        tgt = lookup[tgt]
        m2 = tgt >= 0
        src, tgt = src[m2], tgt[m2]
    g = coo_matrix((np.ones(len(src), np.int8), (src, tgt)), shape=(s, s))
    _, labels = connected_components(g, directed=True, connection="weak")
    return labels


def repair_connectivity(rows: np.ndarray, node_ids: np.ndarray, vectors,
                        metric: str, max_rounds: int = 64,
                        sample: int = 256) -> np.ndarray:
    """Guarantee a single connected component by adding mutual edges between
    each stray component and the rest (closest cross pairs among samples)."""
    rows = rows.copy()
    for _ in range(max_rounds):
        comp = _components(rows, node_ids)
        labels, counts = np.unique(comp, return_counts=True)
        if len(labels) == 1:
            return rows
        main = labels[np.argmax(counts)]
        rng = np.random.default_rng(0)
        strays = [c for c in labels if c != main][:256]
        a_ss, b_ss = [], []
        for c in strays:
            a_idx = np.nonzero(comp == c)[0]
            b_idx = np.nonzero(comp != c)[0]
            a_ss.append(rng.choice(a_idx, size=sample,
                                   replace=len(a_idx) < sample))
            b_ss.append(rng.choice(b_idx, size=4 * sample,
                                   replace=len(b_idx) < 4 * sample))
        A = np.stack(a_ss)
        Bm = np.stack(b_ss)
        av = vectors[torch.as_tensor(node_ids[A], device=vectors.device).long()]
        bv = vectors[torch.as_tensor(node_ids[Bm], device=vectors.device).long()]
        dots = torch.bmm(av.float(), bv.float().transpose(1, 2))
        if metric == "ip":
            d_all = (1.0 - dots).cpu().numpy()
        else:
            an = (av.float() ** 2).sum(dim=2)
            bn = (bv.float() ** 2).sum(dim=2)
            d_all = (an[:, :, None] + bn[:, None, :] - 2.0 * dots).cpu().numpy()
        for si, c in enumerate(strays):
            d = d_all[si]
            a_s, b_s = a_ss[si], b_ss[si]
            # several bridges per stray component: single-edge bridges may be
            # cut by later pruning passes
            flat = np.argsort(d, axis=None)[: 4 * max(1, d.shape[0] // sample)]
            used_a = set()
            for f in flat[:8]:
                ai, bi = np.unravel_index(f, d.shape)
                if ai in used_a:
                    continue
                used_a.add(ai)
                u, v = a_s[ai], b_s[bi]
                if u == v or comp[u] == comp[v]:
                    continue
                _append_or_replace(rows, u, node_ids[v])
                _append_or_replace(rows, v, node_ids[u])
    return rows


def _append_or_replace(rows: np.ndarray, i: int, gid: int) -> None:
    """Append gid to rows[i]; if full, replace the last (farthest) slot."""
    if gid in rows[i]:
        return
    empty = np.nonzero(rows[i] < 0)[0]
    rows[i, empty[0] if len(empty) else -1] = gid


def _compact_rows(a: np.ndarray) -> np.ndarray:
    """Left-compact the -1 holes of each row, order kept."""
    order = np.argsort(a < 0, axis=1, kind="stable")
    return np.take_along_axis(a, order, axis=1)


def _to_dev(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev``: from pinned memory without blocking on the
    card (a pageable copy would wait for the queued kernels)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" \
        else t


def _build_search(adjs, entry: int, vectors, vn, q, lp_eff: np.ndarray, *,
                  max_level: int, efc: int, max_iters: int, metric: str):
    """Candidate search of upper-level inserts: greedy descent (Kε, one
    launch for all levels) above each point's level lp_eff (host int32[B]),
    a fresh single-seed buffer at it, and the ef_construction beam (Kβ, pop
    1) at and below it, the buffer carried from level to level. Returns per-level buffers (d f32[L+1, B,
    efc], ids i32[L+1, B, efc]), L = max_level; level l's rows matter where
    lp_eff >= l."""
    dev = q.device
    qn = sq_norms(q)
    cur, curdist = gs.entry_dist(vectors, vn, q, qn, entry, metric)
    buf_d, buf_id = gs.beam_init(cur, curdist, efc)
    lp = _to_dev(lp_eff, dev)
    # every query's descent (levels above its lp_eff) lies above its beam
    # levels, so all descents run first, in one Kε launch
    if (lp_eff < max_level).any():
        cur, curdist, _, _ = gs.greedy_descent_levels(
            vectors, q, qn, adjs[max_level:0:-1], max_level, cur, curdist,
            lp, metric)
    out_d, out_i = [None] * (max_level + 1), [None] * (max_level + 1)
    for l in range(max_level, -1, -1):
        # skip what no query does at this level (the host knows lp_eff)
        if (lp_eff == l).any():
            buf_d, buf_id = gs.beam_reseed(buf_d, buf_id, cur, curdist,
                                           lp == l)
        if (lp_eff >= l).any():
            buf_d, buf_id, _, _ = gs.beam_level(
                vectors, q, qn, adjs[l], buf_d, buf_id, lp >= l,
                max_iters=max_iters, metric=metric)
        out_d[l], out_i[l] = buf_d, buf_id
    return torch.stack(out_d), torch.stack(out_i)


# pops per iteration of the level-0 insert search (the JAX default)
INSERT_POP_WIDTH = 8


def _build_search0(adjs, entry: int, vectors, vn, q, active, *,
                   max_level: int, efc: int, max_iters: int, metric: str):
    """Candidate search of level-0-only inserts (``active`` bool[B]):
    greedy descent through every upper level (Kε, one launch), then one
    multi-pop
    ef_construction beam at level 0 from that seed (Kβ, one launch, pop
    INSERT_POP_WIDTH, no scan cap: the JAX straggler stages leave per-query
    results unchanged and share one global iteration budget). Inactive rows
    come back empty (id -1). Returns (d f32[B, efc], ids i32[B, efc])."""
    qn = sq_norms(q)
    cur, curdist = gs.entry_dist(vectors, vn, q, qn, entry, metric)
    cur, curdist, _, _ = gs.greedy_descent_levels(
        vectors, q, qn, adjs[max_level:0:-1], max_level, cur, curdist,
        torch.where(active, 0, max_level).to(torch.int32), metric)
    d, ids, _, _ = gs.beam_search(
        vectors, q, qn, adjs[0],
        torch.where(active, curdist, INF)[:, None].contiguous(),
        torch.where(active, cur, -1)[:, None].contiguous(), P=efc,
        ef_eff=efc, pop_width=INSERT_POP_WIDTH,
        cw=gs.cand_width(efc, INSERT_POP_WIDTH, adjs[0].shape[1], 0),
        max_iters=max_iters, k=efc, metric=metric)
    return d, ids


class _Spans:
    """Summed time of named build phases: CUDA events on the card (read
    once, after the build), the host clock on the CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.spans: list = []

    def stamp(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def add(self, name: str, start, end) -> None:
        self.spans.append((name, start, end))

    def totals(self) -> dict:
        out: dict = {}
        for name, a, b in self.spans:
            dt = a.elapsed_time(b) / 1e3 if self.cuda else b - a
            out[name] = out.get(name, 0.0) + dt
        return out


class HnswBuilder:
    """Builds a LevelGraph over a vector set in batched insertion rounds.

    A batch never exceeds the points already inserted (early rounds stay
    high-quality, later ones reach ``max_batch``). Each batch searches the
    frozen pre-batch graph, then applies its connections level by level
    from the top; the entry point moves, on the host, to each insert whose
    level exceeds the running maximum, in id order. No step reads the
    device back during the build; ``phase_s`` splits the build's seconds
    into the device spans of the batches' searches (level-0-only inserts
    "search0", upper-level inserts "search_up") and applies ("apply") and
    the rest ("host"), and ``overflow`` sums the reverse-connect overflow
    counters, read once at the end. The adjacency stays on the device; a
    host copy is the caller's to pull (``HnswIndex.host_adj``).
    """

    def __init__(self, cfg: HnswConfig, max_batch: int = 4096):
        self.cfg = cfg
        self.max_batch = max_batch
        self.phase_s: dict = {}
        self.overflow: dict = {}
        # (level, of_edges, of_targets, of_t, new_w) per apply, read lazily
        self._of_monitor: list = []

    def build(self, vectors: torch.Tensor, vn: torch.Tensor,
              verbose: bool = False):
        """Insert every row of ``vectors`` (on the build's device; vn their
        squared norms). Returns (LevelGraph, levels np.int32[N])."""
        t_wall = time.perf_counter()
        cfg = self.cfg
        n = vectors.shape[0]
        dev = vectors.device
        levels = sample_levels(n, cfg.mult, cfg.seed)
        lmax = int(levels.max(initial=0))
        caps = [cfg.maxM0] + [cfg.maxM] * lmax
        adj_dev = [torch.full((n, caps[l]), -1, dtype=torch.int32, device=dev)
                   for l in range(lmax + 1)]
        deg_dev = [torch.zeros((n,), dtype=torch.int32, device=dev)
                   for _ in range(lmax + 1)]
        self._of_monitor = []
        spans = _Spans(dev)
        # point 0 is inserted trivially (no peers to link)
        entry, _ = self._insert_range(
            1, n, levels, 0, int(levels[0]) if n else 0, vectors, vn,
            adj_dev, deg_dev, spans, verbose)
        self._check_overflow_monitor(verbose)
        wall = time.perf_counter() - t_wall
        self.phase_s = spans.totals()
        self.phase_s["host"] = wall - sum(self.phase_s.values())
        self.phase_s["wall"] = wall
        graph = LevelGraph(
            adjs=tuple(adj_dev),
            level=torch.as_tensor(levels, device=dev),
            entry=entry, max_level=lmax)
        return graph, levels

    def _insert_range(self, start, n, levels, entry, cur_maxlevel, vecs,
                      vn, adj_dev, deg_dev, spans, verbose, collect=None):
        """Insert ids [start, n) batch by batch; returns the final (entry,
        cur_maxlevel). ``collect``: see _insert_batch_bulk."""
        done = start
        while done < n:
            bsz = min(self._batch_size(done), n - done)
            ids = np.arange(done, done + bsz)
            self._insert_batch_bulk(ids, levels, entry, cur_maxlevel, vecs,
                                    vn, adj_dev, deg_dev, spans, collect)
            # entry-point update (hnswalg.h:1369-1374), in insertion order
            for j in np.nonzero(levels[ids] > cur_maxlevel)[0]:
                if levels[ids[j]] > cur_maxlevel:
                    cur_maxlevel = int(levels[ids[j]])
                    entry = int(ids[j])
            done += bsz
            if verbose and done % 65536 < bsz:
                print(f"  built {done}/{n}", flush=True)
        return entry, cur_maxlevel

    def _batch_size(self, cur: int) -> int:
        return max(1, min(cur, self.max_batch))

    def _search_batch(self, q, lp_eff, entry, cur_maxlevel, vecs, vn,
                      adj_dev, spans):
        """Both candidate searches of one batch (queries q, effective levels
        lp_eff) against the pre-batch graph. Levels above cur_maxlevel hold
        no edge yet, so the searches start there (the JAX program's extra
        levels are no-ops). Returns (i0 i32[B, efc] level-0 candidates, up
        the batch positions of the upper-level inserts, cand_up
        i32[L+1, len(up), efc] their per-level candidates or None)."""
        cfg = self.cfg
        dev = vecs.device
        efc = cfg.ef_construction
        max_iters = 2 * efc + 64
        t0 = spans.stamp()
        _, i0 = _build_search0(
            adj_dev, entry, vecs, vn, q, _to_dev(lp_eff == 0, dev),
            max_level=cur_maxlevel, efc=efc, max_iters=max_iters,
            metric=cfg.metric)
        t1 = spans.stamp()
        spans.add("search0", t0, t1)
        up = np.nonzero(lp_eff >= 1)[0]
        cand_up = None
        if len(up):
            up_dev = _to_dev(up.astype(np.int64), dev)
            _, cand_up = _build_search(
                adj_dev, entry, vecs, vn, q[up_dev], lp_eff[up],
                max_level=cur_maxlevel, efc=efc, max_iters=max_iters,
                metric=cfg.metric)
            # upper-level inserts take their level-0 candidates from their
            # own per-level search
            i0[up_dev] = cand_up[0]
        spans.add("search_up", t1, spans.stamp())
        return i0, up, cand_up

    def _insert_batch_bulk(self, ids, levels, entry, cur_maxlevel, vecs, vn,
                           adj_dev, deg_dev, spans, collect=None):
        """Search the batch ids (consecutive) against the pre-batch graph,
        then apply its connections per level.

        ``collect`` (a dict, level -> list of id arrays) is how the update
        flow learns which rows each level's apply wrote: the inserted ids,
        and the reverse-connect targets, which are the values of the
        inserted nodes' post-apply rows (their forward selection; candidates
        come from the frozen pre-batch graph, so they are disjoint from the
        batch). That read costs one device sync per level. Collect mode also
        widens the overflow re-prune: an update inserts into a mature graph
        whose rows sit at the cap, so nearly every reverse append
        overflows."""
        cfg = self.cfg
        dev = vecs.device
        lp_eff = np.minimum(levels[ids], cur_maxlevel).astype(np.int32)
        a_all = torch.arange(int(ids[0]), int(ids[-1]) + 1,
                             dtype=torch.int32, device=dev)
        # the batch's own rows are its queries, fp32 (a bfloat16 store's rows
        # widen exactly, as the JAX distances upcast them)
        q = vecs[int(ids[0]):int(ids[-1]) + 1].float()
        i0, up, cand_up = self._search_batch(q, lp_eff, entry, cur_maxlevel,
                                             vecs, vn, adj_dev, spans)
        t2 = spans.stamp()
        for l in range(int(lp_eff.max(initial=0)), -1, -1):
            cap_l = cfg.maxM0 if l == 0 else cfg.maxM
            of_t, new_w = (4096, 64) if l == 0 else (1024, 32)
            if collect is not None:
                of_t, new_w = (16384, 32) if l == 0 else (2048, 32)
            if l == 0:
                a_ids, cand = a_all, i0
            else:
                aidx = np.nonzero(lp_eff >= l)[0]
                # rows of cand_up follow `up` (both ascending)
                pos = np.searchsorted(up, aidx)
                cand = cand_up[l][_to_dev(pos.astype(np.int64), dev)]
                a_ids = _to_dev(ids[aidx].astype(np.int32), dev)
            of_e, of_tc = revconn.apply_insert(
                adj_dev[l], deg_dev[l], vecs, vn, a_ids, cand, M=cfg.M,
                cap=cap_l, metric=cfg.metric, of_t=of_t, new_w=new_w)
            self._of_monitor.append((l, of_e, of_tc, of_t, new_w))
            if collect is not None:
                rows = adj_dev[l][a_ids.long()].cpu().numpy()
                collect.setdefault(l, []).extend((
                    a_ids.cpu().numpy().astype(np.int64),
                    np.unique(rows[rows >= 0]).astype(np.int64)))
        spans.add("apply", t2, spans.stamp())

    def _insert_batch(self, ids, levels, entry, cur_maxlevel, vecs, vn,
                      adj_np, adj_dev, spans):
        """The host-planned insert batch, for ids in any order (reused
        slots): the same searches, then per level the forward prune (Kγ)
        and scatter on the device and the reverse connections planned on the
        host against the mirror ``adj_np``. Device rows and mirror rows are
        written together. Returns the ids of every row written."""
        cfg = self.cfg
        dev = vecs.device
        lp_eff = np.minimum(levels[ids], cur_maxlevel).astype(np.int32)
        q = vecs[_to_dev(ids.astype(np.int64), dev)].float()
        i0, up, cand_up = self._search_batch(q, lp_eff, entry, cur_maxlevel,
                                             vecs, vn, adj_dev, spans)
        t2 = spans.stamp()
        touched = []
        for l in range(int(lp_eff.max(initial=0)), -1, -1):
            cap_l = cfg.maxM0 if l == 0 else cfg.maxM
            aidx = np.nonzero(lp_eff >= l)[0]
            a_ids = ids[aidx]
            if l == 0:
                cand = i0
            else:
                pos = np.searchsorted(up, aidx)
                cand = cand_up[l][_to_dev(pos.astype(np.int64), dev)]
            a_dev = _to_dev(a_ids.astype(np.int32), dev)
            # forward selection: heuristic to M with the under-M early-out
            sel, _ = prune_batch(vecs, vn, a_dev, cand, cand >= 0, M=cfg.M,
                                 keep_all_under_m=True, metric=cfg.metric)
            fwd = torch.nn.functional.pad(sel, (0, cap_l - cfg.M), value=-1)
            adj_dev[l][a_dev.long()] = fwd
            targets, rows = self._reverse_connect(
                a_dev, sel, adj_np[l], cap_l, vecs, vn)
            if len(targets):
                adj_dev[l][_to_dev(targets, dev)] = _to_dev(rows, dev)
            adj_np[l][a_ids] = fwd.cpu().numpy()
            adj_np[l][targets] = rows
            touched += [a_ids.astype(np.int64), targets]
        spans.add("apply", t2, spans.stamp())
        return np.unique(np.concatenate(touched))

    def _reverse_connect(self, a_dev, sel, adj_l, cap_l, vecs, vn):
        """Reverse edges u -> p for each forward edge p -> u of ``sel``
        (hnswalg.h:618-687), planned on the host against the mirror rows
        ``adj_l``: the edge list stably sorted by target (Kι), appended in
        that order while the target's row has room, else {row ∪ the first
        64 new edges in arrival order} re-pruned to the cap (Kγ). Returns
        (targets int64[U] ascending, their new rows i32[U, cap_l])."""
        us, ps = revconn.reverse_edges(a_dev, sel, adj_l.shape[0])
        us, ps = us.cpu().numpy(), ps.cpu().numpy()
        ps = ps[us < revconn.BIG]
        us = us[us < revconn.BIG]
        if not len(us):
            return np.zeros(0, np.int64), np.zeros((0, cap_l), np.int32)
        uniq, starts, counts = np.unique(us, return_index=True,
                                         return_counts=True)
        col = np.arange(len(us)) - np.repeat(starts, counts)
        row = np.repeat(np.arange(len(uniq)), counts)
        existing = adj_l[uniq]
        ne = (existing >= 0).sum(axis=1)
        out = existing.copy()
        fits = ne + counts <= cap_l
        pf = fits[row]
        out[row[pf], ne[row[pf]] + col[pf]] = ps[pf]
        of = np.nonzero(~fits)[0]
        if len(of):
            dev = vecs.device
            new = np.full((len(uniq), 64), -1, np.int32)
            first = col < 64
            new[row[first], col[first]] = ps[first]
            cand = _to_dev(np.concatenate([existing[of], new[of]], axis=1),
                           dev)
            osel, _ = prune_batch(
                vecs, vn, _to_dev(uniq[of].astype(np.int32), dev), cand,
                cand >= 0, M=cap_l, keep_all_under_m=False,
                metric=self.cfg.metric, out_width=cap_l)
            out[of] = osel.cpu().numpy()
        return uniq.astype(np.int64), out

    def _check_overflow_monitor(self, verbose: bool) -> None:
        """Read the per-apply overflow counters (one transfer) into
        ``overflow`` and report truncation: applies whose unique overflow
        targets exceeded the re-prune width, whose excess reverse edges were
        dropped."""
        mon = self._of_monitor
        if not mon:
            self.overflow = {"edges": 0, "max_targets": 0,
                             "truncated_applies": 0, "applies": 0}
            return
        vals = torch.stack([torch.stack([e, t]) for _, e, t, _, _ in mon])
        vals = vals.cpu().numpy()
        trunc = int(sum(1 for (_, _, _, cap_t, _), (_, t) in zip(mon, vals)
                        if t > cap_t))
        self.overflow = {"edges": int(vals[:, 0].sum()),
                         "max_targets": int(vals[:, 1].max()),
                         "truncated_applies": trunc, "applies": len(mon)}
        if verbose or trunc:
            print(f"  reverse-connect overflow: {self.overflow}", flush=True)
        self._of_monitor = []
