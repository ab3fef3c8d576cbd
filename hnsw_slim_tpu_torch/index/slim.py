"""HNSW-Slim index (port of hnsw_slim_tpu/index/slim.py).

Build (or take) a vanilla HNSW, run the two-stage pruning conversion, then
serve batched queries with ``graph/search.chal_search``: greedy descent
above the threshold level (Kε), beams at and below it (Kβ), or, with
``seed_width`` > 1 at threshold level 0, exact seeds from all level>=1
vectors (Kα) straight into the base-layer beam. Search runs on the flat CHAL
arrays alone; ``densify_level0`` and ``densify_upper`` add dense serving
layouts that give the same results with one row read per pop, and
``update_dense0`` / ``update_dense_upper`` refresh them in place from a
changed host mirror. ``filter_mask`` filters in the kernel, ``entry`` gives
per-query entry points, ``search_async`` returns without a sync, a
repeated ``search`` on the card replays one CUDA graph (``replay.py``), and
``autotune_index`` calibrates (pop_width, scan_width) for one ef.

Not ported: ``straggler_stages`` (the kernels run each query on its own) and
``dynamic_ef`` / ``ef_max`` (nothing is compiled per ef); a config that sets
``dynamic_ef`` raises.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..config import HnswConfig, SearchConfig, SlimConfig

from ..graph import search as gs
from ..graph.prune import convert_to_slim
from ..graph.types import ChalGraph
from ..ops import cuda
from ..ops.distance import sq_norms
from ..persist.patch import _level_rows, _subset_rows, to_np
from ..utils import trace
from . import replay
from .bruteforce import exact_topk
from .hnsw import HnswIndex, LastStats, _check, allowed_rows, filter_iters


class HnswSlimIndex:
    """Pruned (Slim) index whose graph, vectors and serving layouts live on
    ``device``."""

    last_stats = LastStats()

    def __init__(self, metric: str = "l2",
                 search_cfg: SearchConfig | None = None, device=None):
        self.metric = metric
        self.scfg = search_cfg or SearchConfig()
        self.device = cuda.resolve_device(device)
        self.graph: ChalGraph | None = None
        self.vectors = None
        self.vn = None
        self.dense0 = None  # dense level-0 serving rows i32[N_pad, cap0]
        # dense upper-level serving layout: rank_up i32[N_pad] (append-only
        # row rank among level>=1 nodes, -1 below) and dense_up[l-1]
        # i32[R_pad, cap] rows for level l
        self.dense_up: tuple | None = None
        self.rank_up = None
        self._rank_np: np.ndarray | None = None
        self._n_up = 0
        # host numpy mirror {nbr, lvl_off, level}: when set, host-side
        # consumers read it instead of pulling the device arrays
        self.host_chal: dict | None = None
        # exact-seed table (seed_width > 1): vectors, norms and ids of all
        # level>=1 nodes, keyed by the graph object it was built for
        self.up_vecs = self.up_vn = self.up_ids = None
        self._up_for = None
        self._replay = replay.Replay()
        self.last_stats: dict = {}

    def _host_chal(self) -> dict:
        return self.host_chal if self.host_chal is not None \
            else to_np(self.graph)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def densify_level0(self) -> int:
        """Explode the level-0 CHAL slices into dense [N, cap0] rows (the
        serving layout of the base beam). Returns its bytes."""
        c = self._host_chal()
        n_pad = int(self.graph.level.shape[0])
        n = min(n_pad, len(c["lvl_off"]))
        rows = np.full((n_pad, self.graph.cap0), -1, np.int32)
        rows[:n] = _level_rows(c, 0, n, self.graph.cap0)
        self.dense0 = self._dev(rows)
        return int(self.dense0.numel() * 4)

    def update_dense0(self, host_chal: dict, ids) -> None:
        """Refresh the dense level-0 rows of ``ids`` in place from a changed
        host mirror, instead of rebuilding the whole array; falls back to
        densify_level0 when the node padding changed."""
        n_pad = int(self.graph.level.shape[0])
        if self.dense0 is None or int(self.dense0.shape[0]) != n_pad:
            self.densify_level0()
            return
        ids = np.unique(np.asarray(ids, np.int64))
        ids = ids[(ids >= 0) & (ids < len(host_chal["lvl_off"]))]
        if len(ids):
            rows = _subset_rows(host_chal, 0, ids, self.graph.cap0)
            self.dense0[self._dev(ids)] = self._dev(rows.astype(np.int32))

    def densify_upper(self, bucket: int = 4096) -> int:
        """Build the dense upper-level serving layout: one rank indirection
        (i32[N_pad], -1 for level-0-only nodes) and per-level dense rows
        i32[R_pad, cap], R_pad a multiple of ``bucket``. Ranks are
        append-only, so update_dense_upper maintains it with scatters.
        Returns its bytes."""
        c = self._host_chal()
        g = self.graph
        n_pad = int(g.level.shape[0])
        lvl = np.full(n_pad, -1, np.int32)
        lvl[: len(c["level"])] = c["level"]
        up_ids = np.nonzero(lvl >= 1)[0]
        rank = np.full(n_pad, -1, np.int32)
        rank[up_ids] = np.arange(len(up_ids), dtype=np.int32)
        r_pad = -(-max(len(up_ids), 1) // bucket) * bucket
        dense = []
        for l in range(1, g.max_level + 1):
            rows = np.full((r_pad, g.cap), -1, np.int32)
            sel = lvl[up_ids] >= l
            if sel.any():
                rows[rank[up_ids[sel]]] = _subset_rows(c, l, up_ids[sel],
                                                       g.cap)
            dense.append(self._dev(rows))
        self._rank_np = rank
        self._n_up = len(up_ids)
        self.rank_up = self._dev(rank)
        self.dense_up = tuple(dense)
        return int(sum(d.numel() for d in dense) + self.rank_up.numel()) * 4

    def update_dense_upper(self, host_chal: dict, ids) -> None:
        """Refresh the dense upper rows of ``ids`` in place: new level>=1
        nodes get appended ranks, changed rows are written at their ranks,
        nodes that dropped below level 1 lose their rank. Falls back to a
        full densify_upper when the node padding, max_level or the rank
        capacity changed."""
        g = self.graph
        n_pad = int(g.level.shape[0])
        if (self.dense_up is None or self._rank_np is None
                or len(self._rank_np) != n_pad
                or len(self.dense_up) != g.max_level):
            self.densify_upper()
            return
        lvl_np = host_chal["level"]
        ids = np.unique(np.asarray(ids, np.int64))
        ids = ids[(ids >= 0) & (ids < len(lvl_np))]
        if not len(ids):
            return
        up = ids[lvl_np[ids] >= 1]
        down = ids[(lvl_np[ids] < 1) & (self._rank_np[ids] >= 0)]
        if len(down):
            self._rank_np[down] = -1
            self.rank_up[self._dev(down)] = -1
        if not len(up):
            return
        fresh = up[self._rank_np[up] < 0]
        if len(fresh):
            if self._n_up + len(fresh) > int(self.dense_up[0].shape[0]):
                self.densify_upper()
                return
            self._rank_np[fresh] = np.arange(
                self._n_up, self._n_up + len(fresh), dtype=np.int32)
            self._n_up += len(fresh)
            self.rank_up[self._dev(fresh)] = self._dev(self._rank_np[fresh])
        ranks = self._dev(self._rank_np[up].astype(np.int64))
        for l in range(1, g.max_level + 1):
            # rows of nodes at this level; cleared rows for ranked nodes
            # whose (possibly lowered) level no longer reaches it
            rows = np.full((len(up), g.cap), -1, np.int32)
            at_l = lvl_np[up] >= l
            if at_l.any():
                rows[at_l] = _subset_rows(host_chal, l, up[at_l], g.cap)
            self.dense_up[l - 1][ranks] = self._dev(rows)

    @classmethod
    def from_hnsw(cls, hnsw: HnswIndex, slim_cfg: SlimConfig,
                  search_cfg: SearchConfig | None = None,
                  count_level0_hubs: bool = False,
                  verbose: bool = False) -> "HnswSlimIndex":
        """convertFromHNSW: the two-stage Slim conversion of a built HNSW."""
        idx = cls(metric=hnsw.cfg.metric, search_cfg=search_cfg,
                  device=hnsw.device)
        idx.vectors = hnsw.vectors
        idx.vn = hnsw.vn
        idx.graph = cls._convert(
            hnsw.graph, hnsw.vectors, hnsw.vn, slim_cfg,
            metric=hnsw.cfg.metric, count_level0_hubs=count_level0_hubs,
            verbose=verbose,
        )
        return idx

    _convert = staticmethod(convert_to_slim)

    @classmethod
    def build(cls, vectors: np.ndarray, hnsw_cfg: HnswConfig | None = None,
              slim_cfg: SlimConfig | None = None, max_batch: int = 4096,
              verbose: bool = False, device=None):
        """Full pipeline: build HNSW, then convert."""
        hnsw = HnswIndex(hnsw_cfg or HnswConfig(), max_batch=max_batch,
                         device=device)
        hnsw.build(vectors, verbose=verbose)
        return cls.from_hnsw(hnsw, slim_cfg or SlimConfig.from_ratios(),
                             verbose=verbose)

    def set_ef(self, ef: int) -> None:
        self.scfg = dataclasses.replace(self.scfg, ef=ef)

    def autotune(self, ef: int, **kw) -> dict:
        """Per-graph serve-time knob calibration — see autotune_index."""
        return autotune_index(self, ef, **kw)

    def _seed_table(self):
        """(up_vecs [n_up_pad, d] in the store's row type, up_vn
        f32[n_up_pad], up_ids i32[n_up_pad]) over all level>=1 nodes, padded
        to a power of two (>= 64) with id -1; rebuilt when the graph object
        changes."""
        if self.up_ids is None or self._up_for is not self.graph:
            lv = (self.host_chal["level"] if self.host_chal is not None
                  else self.graph.level.cpu().numpy())
            ids = np.nonzero(np.asarray(lv) >= 1)[0].astype(np.int32)
            pad = max(64, 1 << max(0, len(ids) - 1).bit_length())
            idp = np.full(pad, -1, np.int32)
            idp[: len(ids)] = ids
            self.up_ids = self._dev(idp)
            self.up_vecs = self.vectors[self.up_ids.clamp(min=0).long()]
            self.up_vn = sq_norms(self.up_vecs)
            self._up_for = self.graph
        return self.up_vecs, self.up_vn, self.up_ids

    def _reads(self) -> dict:
        """chal_search's arguments besides the queries, the entry, ef, k,
        the iteration cap and the allow-list: the graph, the store and the
        serving layouts a search reads, and the knobs."""
        if self.scfg.dynamic_ef:
            raise NotImplementedError(
                "dynamic_ef: the port compiles nothing per ef; set ef")
        g = self.graph
        up_vecs = up_vn = up_ids = None
        if self.scfg.seed_width > 1 and g.threshold_level == 0 \
                and g.max_level >= 1:
            up_vecs, up_vn, up_ids = self._seed_table()
        return dict(
            graph_nbr=g.nbr, graph_lvl_off=g.lvl_off, vectors=self.vectors,
            vn=self.vn, max_level=g.max_level,
            threshold_level=g.threshold_level, cap0=g.cap0, cap=g.cap,
            metric=self.metric, pop_width=self.scfg.pop_width,
            dense0=self.dense0, dense_up=self.dense_up, rank_up=self.rank_up,
            scan_width=self.scfg.scan_width, seed_width=self.scfg.seed_width,
            up_vecs=up_vecs, up_vn=up_vn, up_ids=up_ids,
            seed_strata=self.scfg.seed_strata)

    def search_async(self, queries, k: int,
                     filter_mask: np.ndarray | None = None, entry=None):
        """Enqueue one search — exactly what ``search`` runs eagerly — and
        return the device tensors (d f32[B, k], ids i32[B, k], hops i32[B],
        dcomp i32[B]) without waiting for the card, so a server can overlap
        batch k's read-back with batch k+1's compute."""
        reads = self._reads()
        allowed = None
        max_iters = self.scfg.iters()
        if filter_mask is not None:
            mask = np.asarray(filter_mask, bool)
            allowed = allowed_rows(mask, int(self.vectors.shape[0]),
                                   self.device)
            max_iters = filter_iters(max_iters, mask)
        with trace.span("index.upload"):
            q = torch.as_tensor(np.asarray(queries, np.float32),
                                device=self.device)
        return gs.chal_search(
            entry=self.graph.entry if entry is None else entry, q=q,
            ef=max(self.scfg.ef, k), k=k, max_iters=max_iters,
            allowed=allowed, **reads)

    def search(self, queries: np.ndarray, k: int,
               filter_mask: np.ndarray | None = None, entry=None):
        """(dists f32[B, k], ids i32[B, k]) as numpy — searchKnn. Sets
        ``last_stats`` (hops, distance_computations, summed when first
        read).

        filter_mask bool[N]: disallowed ids are traversed but never
        returned; the kernel keeps an allowed-only result track whose worst
        entry sets the stop bound, so a query returns k allowed ids whenever
        k allowed nodes are reachable. entry: per-query entry points i32[B]
        (default: the graph's entry point). A repeated call on the card
        without either replays one CUDA graph of the whole search
        (``replay``), with the same results."""
        with trace.span("index.search"):
            q = np.asarray(queries, np.float32)
            out = None
            if replay.engages(self.device, len(q), filter_mask, entry):
                kw = dict(entry=self.graph.entry, ef=max(self.scfg.ef, k),
                          k=k, max_iters=self.scfg.iters(), **self._reads())
                out = self._replay.search(
                    (kw,), q, k, lambda dq: gs.chal_search(q=dq, **kw),
                    self.device)
            if out is None:
                d, i, hops, dcomp = self.search_async(q, k, filter_mask,
                                                      entry)
                with trace.span("index.readback"):
                    d, i = d.cpu().numpy(), i.cpu().numpy()
            else:
                d, i, hops, dcomp = out
        self.last_stats = (hops, dcomp)
        return d, i

    def index_size(self) -> int:
        """Graph-only bytes in the reference's accounting."""
        if self.host_chal is not None:
            # host-resident CHAL: account from the mirror, as chal_bytes does
            c = self.host_chal
            levels = c["level"]
            real = levels >= 0
            total = int((c["lvl_off"][:, -1] - c["lvl_off"][:, 0]).sum())
            return int(16 * int(real.sum()) + 2 * int(levels[real].sum())
                       + 4 * total)
        return self.graph.chal_bytes()

    def check_integrity(self) -> dict:
        """checkIntegrity + the hierarchical membership rule: a level-l
        neighbor must itself be a level-l node unless l == threshold_level.
        Raises AssertionError on the first violated invariant."""
        g = self.graph
        n = g.n
        c = self._host_chal()
        levels = c["level"]
        off = c["lvl_off"]
        total_edges = 0
        for l in range(g.max_level + 1):
            cap_l = g.cap0 if l == 0 else g.cap
            sizes = off[:, l + 1] - off[:, l]
            _check((sizes >= 0).all(), f"negative slice @{l}")
            _check(sizes.max(initial=0) <= cap_l, f"level {l} over cap")
            _check(not (sizes[levels < l] > 0).any(), "slice on low node")
            rows = _level_rows(c, l, n, cap_l)
            valid = rows >= 0
            ids = rows[valid]
            _check((ids < n).all(), f"id out of range @{l}")
            _check(not (rows == np.arange(n)[:, None]).any(),
                   f"self loop @{l}")
            dup = valid[:, 1:] & (rows[:, 1:] == rows[:, :-1])
            _check(not dup.any(), f"dup edge @{l}")
            if l != g.threshold_level:
                _check((levels[ids] == l).all(), f"membership rule @{l}")
            total_edges += int(sizes.sum())
        return {"edges": total_edges, "bytes": self.index_size()}


def _timed_call(search_fn, queries, k) -> float:
    t0 = time.perf_counter()
    search_fn(queries, k=k)
    return time.perf_counter() - t0


def probe_queries(idx, vecs, n: int, sample: int) -> np.ndarray:
    """autotune_index's deterministic near-manifold probes: blends
    0.85 * a + 0.15 * b of pairs of stored rows (of any row type)."""
    idx_a = (np.arange(sample, dtype=np.int64) * 2654435761) % n
    idx_b = (idx_a * 40503 + 12345) % n
    va = vecs[idx._dev(idx_a)].float().cpu().numpy()
    vb = vecs[idx._dev(idx_b)].float().cpu().numpy()
    return (0.85 * va + 0.15 * vb).astype(np.float32)


def autotune_index(idx, ef: int, k: int = 10, sample: int = 256,
                   recall_slack: float = 0.002, queries=None, gt=None,
                   configs=None, verbose: bool = False) -> dict:
    """Serve-time knob calibration for one index at one ef (the JAX
    package's ``autotune_index``): sweep a small (pop_width, scan_width) grid
    on ``sample`` probe queries against exact ground truth (Kα), keep the
    fastest config whose recall is within ``recall_slack`` of the best
    observed. The lossless config (pop 8, no scan cap) is always in the
    grid, so the calibrated recall never falls below it. Sets idx.scfg and
    returns the report; results are cached per (ef, k).

    Probe queries default to blends of stored vectors (0.85*a + 0.15*b);
    pass queries/gt to calibrate on a real sample instead."""
    cache = getattr(idx, "_autotune_cache", None)
    if cache is None:
        cache = idx._autotune_cache = {}
    key = (ef, k)
    if key in cache:
        idx.scfg = dataclasses.replace(idx.scfg, ef=ef, **cache[key]["knobs"])
        return cache[key]
    g = idx.graph
    n = g.n
    vecs = getattr(idx, "vectors", None)
    if vecs is not None:
        vnv = idx.vn
    else:
        # SlimQ stores no raw vectors: probes and ground truth come from
        # the external rerank dataset
        if idx._dataset_dev is None:
            idx._dataset_dev = idx._dev(np.asarray(idx.dataset, np.float32))
        vecs = idx._dataset_dev
        vnv = sq_norms(vecs)
    if queries is None:
        queries = probe_queries(idx, vecs, n, sample)
    queries = np.asarray(queries, np.float32)
    if gt is None:
        _, gt = exact_topk(vecs, vnv, idx._dev(queries), k=k,
                           metric=idx.metric, n_valid=n)
        gt = gt.cpu().numpy()
    gt = np.asarray(gt)
    if configs is None:
        # (pop_width, scan_width): the first entry is the lossless one
        configs = [(8, 0), (16, 0)]
        if ef > 96:
            configs += [(16, 96), (16, 128), (16, 192)]
    # drop configs whose effective scan lane count is identical
    seen, uniq = set(), []
    for pop, scan in configs:
        eff = min(pop * g.cap0, scan or max(2 * ef, 128))
        if (pop, eff) not in seen:
            seen.add((pop, eff))
            uniq.append((pop, scan))
    report, results = [], []
    saved = idx.scfg
    for pop, scan in uniq:
        idx.scfg = dataclasses.replace(saved, ef=ef, pop_width=pop,
                                       scan_width=scan)
        _, ids = idx.search(queries, k=k)  # warm
        dt = min(_timed_call(idx.search, queries, k) for _ in range(2))
        rec = sum(len(set(a.tolist()) & set(b.tolist()))
                  for a, b in zip(np.asarray(ids), gt)) / gt.size
        report.append({"pop_width": pop, "scan_width": scan,
                       "recall": round(rec, 4),
                       "qps": round(len(queries) / dt, 1)})
        results.append((rec, dt, pop, scan))
        if verbose:
            print(f"  autotune ef={ef} pop={pop} scan={scan}: "
                  f"recall={rec:.4f} qps={len(queries) / dt:.0f}", flush=True)
    best_rec = max(r for r, *_ in results)
    ok = [r for r in results if r[0] >= best_rec - recall_slack]
    _, _, pop, scan = min(ok, key=lambda r: r[1])
    knobs = {"pop_width": pop, "scan_width": scan}
    idx.scfg = dataclasses.replace(saved, ef=ef, **knobs)
    out = {"knobs": knobs, "grid": report, "probe_recall": best_rec}
    cache[key] = out
    return out
