"""Vanilla HNSW index: batched build + batched search (port of
hnsw_slim_tpu/index/hnsw.py).

The index holds dense per-level adjacency (LevelGraph) and the vectors on
its device, as fp32 or (``HnswConfig.store_dtype="bfloat16"``) bfloat16
rows; every kernel that reads the store takes either row type. Builds by
insertion rounds (``HnswBuilder``: Kε, Kβ, Kγ, Kζ) or by NN-descent;
searches by greedy descent (Kε) and the level-0 beam (Kβ), filtered in the
kernel when the caller passes ``filter_mask``.

Updates: ``add_points`` appends a batch through the same insert machinery
into capacity-bucketed arrays, in place; ``replace_points`` reuses deleted
slots (sever, overwrite, re-insert). Both keep the host mirror
(``host_adj``) in step and return the ids of every row they wrote: the
working set of the incremental Slim re-prune (graph/incremental.py). The
arrays of the pre-update ``graph`` object are the ones updated, so that
object must not be used afterwards.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..config import HnswConfig, SearchConfig

from ..graph import search as gs
from ..graph.build import (HnswBuilder, _compact_rows, _Spans, _to_dev,
                           sample_levels)
from ..graph.prune import _pad_to_len
from ..graph.types import LevelGraph
from ..ops import cuda
from ..ops.distance import sq_norms
from ..utils import trace
from . import replay

# HnswConfig.store_dtype -> the vector store's torch dtype
STORE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# NND's exact-kNN candidate sets over-prune on clustered data at scale, so
# "auto" picks NND only below this size (as the JAX package does)
AUTO_NND_MAX_N = 200_000


def resolve_build_strategy(strategy: str, n: int) -> str:
    """Resolve "auto" to a concrete build strategy for an n-point build:
    NN-descent below AUTO_NND_MAX_N, insertion rounds at scale."""
    if strategy != "auto":
        return strategy
    return "nnd" if n < AUTO_NND_MAX_N else "insert"


def filter_iters(max_iters: int, mask: np.ndarray) -> int:
    """Iteration cap of a filtered search: heavy filtering needs more hops
    to fill the allowed-only track, so the cap grows with the inverse of the
    allowed share (floored at 5%), as in the JAX package."""
    return int(share_iters(max_iters, np.mean(mask)))


def share_iters(max_iters: int, share) -> np.ndarray:
    """``filter_iters`` of allowed shares (float64, any shape), one cap
    each, as i32: a tag-filtered search caps each query by its own
    predicate's share."""
    density = np.maximum(np.asarray(share, np.float64), 0.05)
    return ((max_iters / density).astype(np.int64) + 8).astype(np.int32)


def allowed_rows(mask: np.ndarray, rows: int, device) -> torch.Tensor:
    """The kernels' allowed flags, one per row of the vector store: a mask
    over the logical nodes alone (as the JAX package takes it, e.g. a
    server's live flags) is padded with False over the capacity rows, which
    no traversal reaches."""
    if len(mask) < rows:
        mask = np.concatenate([mask, np.zeros(rows - len(mask), bool)])
    return torch.as_tensor(mask, device=device)


def row_deg_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Kθ: per row of a i32[N, cap], the count of ids >= 0."""
    return (a >= 0).sum(1, dtype=torch.int32)


def _row_deg(a: torch.Tensor) -> torch.Tensor:
    """Kθ (csrc/row_deg.cu): row occupancy i32[N] of an adjacency
    i32[N, cap]. Every writer keeps rows left-packed, so this is the degree
    the insert apply appends against. CPU tensors run ``row_deg_plain``."""
    if not a.is_cuda:
        return row_deg_plain(a)
    n, cap = a.shape
    cuda.require(a, torch.int32, "a", (n, cap))
    deg = torch.empty((n,), dtype=torch.int32, device=a.device)
    if n:
        cuda.launch("row_deg", a.data_ptr(), n, cap, deg.data_ptr())
    return deg


def _check(ok, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


class LastStats:
    """``last_stats`` of a search index: {"hops", "distance_computations"}
    of the last ``search``. A search stores its (hops, dcomp) device
    tensors; the first read sums them, so a search that nobody asks about
    pays no reduction and no read-back for them. Any other value (a dict)
    is kept as it is."""

    def __get__(self, obj, owner=None):
        if obj is None:
            return self
        st = obj.__dict__.get("_last_stats", {})
        if isinstance(st, tuple):
            hops, dcomp = st
            st = obj.__dict__["_last_stats"] = {
                "hops": int(hops.sum()),
                "distance_computations": int(dcomp.sum())}
        return st

    def __set__(self, obj, value) -> None:
        obj.__dict__["_last_stats"] = value


class HnswIndex:
    """Build-once, query-many vanilla HNSW whose vectors and graph live on
    ``device`` (the CUDA card unless the caller passes another).

    strategy="auto" (default): NN-descent below AUTO_NND_MAX_N points,
    insertion rounds at scale; "nnd" and "insert" force one.
    """

    last_stats = LastStats()

    def __init__(self, cfg: HnswConfig, search_cfg: SearchConfig | None = None,
                 max_batch: int = 4096, strategy: str = "auto",
                 nnd_opts: dict | None = None, device=None):
        self.cfg = cfg
        self.scfg = search_cfg or SearchConfig(ef=cfg.ef_search)
        self.max_batch = max_batch
        self.strategy = strategy
        self.nnd_opts = nnd_opts or {}
        self.device = cuda.resolve_device(device)
        self.graph: LevelGraph | None = None
        self.levels: np.ndarray | None = None
        self.vectors = None
        self.vn = None
        self._adj_np = None
        self.last_stats: dict = {}
        # insertion build: phase seconds and overflow counters (HnswBuilder)
        self.build_stats: dict = {}
        # the last add_points / replace_points: seconds by step, the device
        # spans of its batches, overflow counters, rows touched
        self.last_update_stats: dict = {}

    def build(self, vectors: np.ndarray, verbose: bool = False) -> None:
        """Build the graph over ``vectors`` (float32 [N, d]). The graph is
        built from the fp32 vectors whatever the store's type; a bfloat16
        store (``cfg.store_dtype``) is then cast from them (round to nearest
        even) and its norms taken from the bf16 rows, as in the JAX
        package, so the conversions, updates and searches read bf16 rows."""
        store = STORE_DTYPES.get(self.cfg.store_dtype)
        if store is None:
            raise ValueError(f"store_dtype={self.cfg.store_dtype!r}: expected "
                             f"one of {sorted(STORE_DTYPES)}")
        strategy = resolve_build_strategy(self.strategy,
                                          int(np.asarray(vectors).shape[0]))
        x32 = torch.as_tensor(np.asarray(vectors, np.float32),
                              device=self.device)
        vn32 = sq_norms(x32)
        self._adj_np = None
        if strategy == "nnd":
            from ..graph.build import build_by_nnd

            self.graph, self.levels = build_by_nnd(
                self.cfg, x32, vn32, verbose=verbose, **self.nnd_opts)
        elif strategy == "insert":
            builder = HnswBuilder(self.cfg, self.max_batch)
            self.graph, self.levels = builder.build(x32, vn32,
                                                    verbose=verbose)
            self.build_stats = {"phase_s": builder.phase_s,
                                "overflow": builder.overflow}
        else:
            raise ValueError(f"unknown build strategy {strategy!r}")
        if store == torch.float32:
            self.vectors, self.vn = x32, vn32
        else:
            self.vectors = x32.to(store)
            del x32, vn32
            self.vn = sq_norms(self.vectors)

    @contextlib.contextmanager
    def _phase(self, name: str, marks: dict):
        """One step of the update flows: a span ``insert.<name>`` whose host
        seconds, the card's queued work included, add into marks[name]."""
        with trace.phase(f"insert.{name}", marks, name):
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize()

    def _grow_capacity(self, n_new: int, lmax_new: int, bucket: int = 16384):
        """Grow vectors, adjacency and levels to a capacity that is a
        multiple of ``bucket`` and holds n_new points, and the adjacency to
        lmax_new levels. A batch then costs no copy of the vectors until the
        bucket is full. Padding rows carry level -1 and no edges, so no
        traversal reaches them; the logical count is the graph's ``n_real``.
        Returns (host mirror, device adjacency), both lists by level; the
        existing device arrays are kept where they already fit."""
        dev = self.device
        cap_cur = int(self.vectors.shape[0])
        cap_new = -(-max(n_new, cap_cur) // bucket) * bucket
        adj_np = self.host_adj()
        lmax_old = self.graph.max_level
        lmax = max(lmax_new, lmax_old)
        caps = [self.cfg.maxM0] + [self.cfg.maxM] * lmax
        self.levels = np.asarray(self.levels, np.int32)
        if cap_new > cap_cur:
            self.vectors = torch.cat([
                self.vectors,
                torch.zeros((cap_new - cap_cur, self.vectors.shape[1]),
                            dtype=self.vectors.dtype, device=dev)])
            adj_np = [_pad_to_len(a, cap_new, -1) for a in adj_np]
        self.levels = _pad_to_len(self.levels, cap_new, -1)
        adj_dev = []
        for l in range(lmax + 1):
            if l <= lmax_old:
                d = self.graph.adjs[l]
                if d.shape[0] < cap_new:
                    d = torch.cat([d, torch.full(
                        (cap_new - d.shape[0], d.shape[1]), -1,
                        dtype=torch.int32, device=dev)])
            else:
                d = torch.full((cap_new, caps[l]), -1, dtype=torch.int32,
                               device=dev)
                adj_np.append(np.full((cap_new, caps[l]), -1, np.int32))
            adj_dev.append(d)
        self._adj_np = adj_np
        return adj_np, adj_dev

    def add_points(self, new_vectors: np.ndarray,
                   verbose: bool = False) -> np.ndarray:
        """Insert a batch into the existing graph (the reference's addPoint
        loop), in place on capacity-bucketed arrays: only the batch goes up
        to the device. Levels are drawn from ``seed + n`` of before the
        batch. Returns the ids of every vanilla row the insert wrote (the
        new nodes and their reverse-connect targets), and sets
        ``last_update_stats``."""
        marks: dict = {}
        new_np = np.asarray(new_vectors, np.float32)
        b = len(new_np)
        n_old = self.graph.n
        n_new = n_old + b
        with self._phase("grow", marks):
            new_levels = sample_levels(b, self.cfg.mult,
                                       self.cfg.seed + n_old)
            lmax_old = self.graph.max_level
            lmax = max(lmax_old, int(new_levels.max(initial=0)))
            adj_np, adj_dev = self._grow_capacity(n_new, lmax)
        with self._phase("vectors", marks):
            self.levels = self.levels.copy()
            self.levels[n_old:n_new] = new_levels
            self.vectors[n_old:n_new] = torch.as_tensor(
                new_np, device=self.device).to(self.vectors.dtype)
            self.vn = sq_norms(self.vectors)
        with self._phase("insert_batches", marks):
            # rows are left-packed, so occupancy is the count of ids
            deg_dev = [_row_deg(a) for a in adj_dev]
            ins = HnswBuilder(self.cfg, self.max_batch)
            spans = _Spans(self.device)
            collect: dict = {}
            entry, _ = ins._insert_range(
                n_old, n_new, self.levels, int(self.graph.entry), lmax_old,
                self.vectors, self.vn, adj_dev, deg_dev, spans, verbose,
                collect=collect)
            ins._check_overflow_monitor(verbose)
        with self._phase("mirror_sync", marks):
            # one host-mirror sync per level over every touched row
            touched = [np.zeros(0, np.int64)]
            for l, parts in collect.items():
                rows = np.unique(np.concatenate(parts))
                touched.append(rows)
                adj_np[l][rows] = adj_dev[l][_to_dev(rows, self.device)] \
                    .cpu().numpy()
            self.graph = LevelGraph(
                adjs=tuple(adj_dev),
                level=torch.as_tensor(self.levels, device=self.device),
                entry=entry, max_level=lmax, n_real=n_new)
        out = np.unique(np.concatenate(touched))
        self.last_update_stats = {
            "seconds": marks, "phase_s": spans.totals(),
            "overflow": ins.overflow, "touched": len(out)}
        return out

    def replace_points(self, slots: np.ndarray, new_vectors: np.ndarray,
                       verbose: bool = False):
        """Reuse deleted slots for new vectors (the reference's
        replace_deleted path): sever every edge from and to a slot,
        overwrite its vector, draw it a fresh level (clamped to the graph's
        max_level, so that a reused slot never adds a level), and re-insert
        it through the host-planned insert batch. Returns (touched row ids,
        ids whose level changed), and sets ``last_update_stats``;
        ``verbose`` prints each batch and the seconds of each step."""
        marks: dict = {}
        dev = self.device
        slots = np.asarray(slots, np.int64)
        if len(slots) != len(new_vectors):
            raise ValueError("replace_points: one vector per slot")
        with self._phase("sever", marks):
            slots_dev = _to_dev(slots, dev)
            self.vectors[slots_dev] = torch.as_tensor(
                np.asarray(new_vectors, np.float32), device=dev).to(
                    self.vectors.dtype)
            levels_arr = np.asarray(self.levels, np.int32).copy()
            is_slot = torch.zeros(self.vectors.shape[0], dtype=torch.bool,
                                  device=dev)
            is_slot[slots_dev] = True
            touched = [slots]
            adj_np = self.host_adj()
            adj_dev = list(self.graph.adjs)
            for l, a in enumerate(adj_dev):
                # rows holding an edge to a slot; only those and the slots'
                # own rows change, so only they are compacted and shipped
                hit = is_slot[a.clamp(min=0).long()] & (a >= 0)
                in_rows = hit.any(dim=1).nonzero()[:, 0]
                touched.append(in_rows.cpu().numpy())
                upd = torch.unique(torch.cat([slots_dev, in_rows]))
                rows = torch.where(hit[upd], -1, a[upd])
                rows[is_slot[upd]] = -1
                rows_np = _compact_rows(rows.cpu().numpy())
                a[upd] = _to_dev(rows_np, dev)
                adj_np[l][upd.cpu().numpy()] = rows_np
        with self._phase("insert_batches", marks):
            old_levels = levels_arr[slots].copy()
            lmax = self.graph.max_level
            levels_arr[slots] = np.minimum(sample_levels(
                len(slots), self.cfg.mult, self.cfg.seed + int(slots[0])),
                lmax)
            level_changed = slots[levels_arr[slots] != old_levels]
            self.vn = sq_norms(self.vectors)
            entry = int(self.graph.entry)
            cur_maxlevel = lmax
            if bool(is_slot[entry]):  # the entry point was replaced: promote
                entry = int(np.nonzero(levels_arr == levels_arr.max())[0][0])
                cur_maxlevel = int(levels_arr[entry])
            ins = HnswBuilder(self.cfg, self.max_batch)
            spans = _Spans(dev)
            for s in range(0, len(slots), self.max_batch):
                touched.append(ins._insert_batch(
                    slots[s:s + self.max_batch], levels_arr, entry,
                    cur_maxlevel, self.vectors, self.vn, adj_np, adj_dev,
                    spans))
                if verbose:
                    print(f"  replaced {min(s + self.max_batch, len(slots))}"
                          f"/{len(slots)}", flush=True)
        self.levels = levels_arr
        self.graph = LevelGraph(
            adjs=tuple(adj_dev),
            level=torch.as_tensor(levels_arr, device=dev), entry=entry,
            max_level=lmax, n_real=self.graph.n)
        out = np.unique(np.concatenate(touched))
        self.last_update_stats = {"seconds": marks,
                                  "phase_s": spans.totals(),
                                  "touched": len(out)}
        if verbose:
            print("  replace_points: " + " ".join(
                f"{k}={v:.2f}s" for k, v in marks.items()), flush=True)
        return out, level_changed

    def host_adj(self) -> list[np.ndarray]:
        """Host mirror of the per-level adjacency: pulled once, lazily, then
        kept in step by add_points and replace_points."""
        if self._adj_np is None:
            self._adj_np = [a.cpu().numpy() if a.is_cuda else a.numpy().copy()
                            for a in self.graph.adjs]
        return self._adj_np

    def set_ef(self, ef: int) -> None:
        self.scfg = dataclasses.replace(self.scfg, ef=ef)

    def search(self, queries: np.ndarray, k: int,
               filter_mask: np.ndarray | None = None):
        """(dists f32[B, k], ids i32[B, k]) approximate top-k, ascending, as
        numpy. Sets ``last_stats`` (hops, distance_computations of the
        level-0 beam, summed when first read).

        filter_mask bool[N]: traverse everything, return only allowed ids,
        keep searching until k allowed results are held (the kernel's
        allowed-only result track)."""
        return replay.batch_search(self, queries, k,
                                   lambda: self._plan(k, filter_mask))

    def _plan(self, k: int, filter_mask):
        """(reads, chain) of ``replay.batch_search`` (which has no graphs of
        this index): none, and level_search on uploaded queries."""
        g = self.graph
        kw = dict(max_level=g.max_level, ef=max(self.scfg.ef, k), k=k,
                  max_iters=self.scfg.iters(), metric=self.cfg.metric,
                  pop_width=self.scfg.pop_width)
        if filter_mask is not None:
            mask = np.asarray(filter_mask, bool)
            kw.update(allowed=allowed_rows(mask, int(self.vectors.shape[0]),
                                           self.device),
                      max_iters=filter_iters(kw["max_iters"], mask))
        return (), lambda q: gs.level_search(g.adjs, g.entry, self.vectors,
                                             self.vn, q, **kw)

    def check_integrity(self) -> dict:
        """Structural invariants (hnswalg.h checkIntegrity): ids in range,
        no self loops, no duplicate edges, edges only on rows of nodes of
        sufficient level. Raises AssertionError on the first violation."""
        g = self.graph
        n = g.n
        levels = g.level.cpu().numpy()
        inbound = np.zeros(n, np.int64)
        for l, a in enumerate(self.host_adj()):
            valid = a >= 0
            _check(not valid[n:].any(), f"level {l}: edge on padding row")
            _check(a[valid].max(initial=0) < n, f"level {l}: id out of range")
            _check(not (a == np.arange(len(a))[:, None])[valid].any(),
                   f"level {l}: self loop")
            _check(not valid[levels < l].any(), f"level {l}: edge on low node")
            srt = np.sort(np.where(valid, a, -1 - np.arange(a.shape[1])),
                          axis=1)
            _check(not (srt[:, 1:] == srt[:, :-1]).any(),
                   f"level {l}: duplicate edge")
            inbound += np.bincount(a[valid], minlength=n)[:n]
        return {
            "min_in": int(inbound[:n].min(initial=0)),
            "max_in": int(inbound.max(initial=0)),
            "connections": int(inbound.sum()),
        }
