"""Vanilla HNSW index: batched build + batched search (port of
hnsw_slim_tpu/index/hnsw.py).

The index holds dense per-level adjacency (LevelGraph) and the vectors on
its device. Builds by insertion rounds (``HnswBuilder``: Kε, Kβ, Kγ, Kζ) or
by NN-descent; searches by greedy descent (Kε) and the level-0 beam (Kβ),
filtered in the kernel when the caller passes ``filter_mask``.
The update flows (``add_points``, ``replace_points``) are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import HnswConfig, SearchConfig

from ..graph import search as gs
from ..graph.build import HnswBuilder
from ..graph.types import LevelGraph
from ..ops import cuda
from ..ops.distance import sq_norms

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
    density = max(float(np.mean(mask)), 0.05)
    return int(max_iters / density) + 8


def _check(ok, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


class HnswIndex:
    """Build-once, query-many vanilla HNSW whose vectors and graph live on
    ``device`` (the CUDA card unless the caller passes another).

    strategy="auto" (default): NN-descent below AUTO_NND_MAX_N points,
    insertion rounds at scale; "nnd" and "insert" force one.
    """

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

    def build(self, vectors: np.ndarray, verbose: bool = False) -> None:
        if self.cfg.store_dtype != "float32":
            raise NotImplementedError(
                f"store_dtype={self.cfg.store_dtype}: ROADMAP queue 1")
        strategy = resolve_build_strategy(self.strategy,
                                          int(np.asarray(vectors).shape[0]))
        self.vectors = torch.as_tensor(np.asarray(vectors, np.float32),
                                       device=self.device)
        self.vn = sq_norms(self.vectors)
        self._adj_np = None
        if strategy == "nnd":
            from ..graph.build import build_by_nnd

            self.graph, self.levels = build_by_nnd(
                self.cfg, self.vectors, self.vn, verbose=verbose,
                **self.nnd_opts)
        elif strategy == "insert":
            builder = HnswBuilder(self.cfg, self.max_batch)
            self.graph, self.levels = builder.build(self.vectors, self.vn,
                                                    verbose=verbose)
            self.build_stats = {"phase_s": builder.phase_s,
                                "overflow": builder.overflow}
        else:
            raise ValueError(f"unknown build strategy {strategy!r}")

    def host_adj(self) -> list[np.ndarray]:
        """Host mirror of the per-level adjacency (pulled once, lazily)."""
        if self._adj_np is None:
            self._adj_np = [a.cpu().numpy() for a in self.graph.adjs]
        return self._adj_np

    def set_ef(self, ef: int) -> None:
        self.scfg = dataclasses.replace(self.scfg, ef=ef)

    def search(self, queries: np.ndarray, k: int,
               filter_mask: np.ndarray | None = None):
        """(dists f32[B, k], ids i32[B, k]) approximate top-k, ascending, as
        numpy. Sets ``last_stats`` (hops, distance_computations of the
        level-0 beam).

        filter_mask bool[N]: traverse everything, return only allowed ids,
        keep searching until k allowed results are held (the kernel's
        allowed-only result track)."""
        g = self.graph
        ef = max(self.scfg.ef, k)
        allowed = None
        max_iters = self.scfg.iters()
        if filter_mask is not None:
            mask = np.asarray(filter_mask, bool)
            allowed = torch.as_tensor(mask, device=self.device)
            max_iters = filter_iters(max_iters, mask)
        q = torch.as_tensor(np.asarray(queries, np.float32),
                            device=self.device)
        d, i, hops, dcomp = gs.level_search(
            g.adjs, g.entry, self.vectors, self.vn, q,
            max_level=g.max_level, ef=ef, k=k, max_iters=max_iters,
            metric=self.cfg.metric, pop_width=self.scfg.pop_width,
            allowed=allowed)
        d, i = d.cpu().numpy(), i.cpu().numpy()
        self.last_stats = {
            "hops": int(hops.sum()),
            "distance_computations": int(dcomp.sum()),
        }
        return d, i

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
