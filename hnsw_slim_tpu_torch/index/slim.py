"""HNSW-Slim index (port of hnsw_slim_tpu/index/slim.py, serving slice).

Build (or take) a vanilla HNSW, run the two-stage pruning conversion, then
serve batched queries: exact seeds from all level>=1 vectors (Kα) feed a
per-query base-layer beam over dense level-0 rows (Kβ).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import HnswConfig, SearchConfig, SlimConfig

from ..graph import search as gs
from ..graph.prune import convert_to_slim
from ..graph.types import ChalGraph
from ..ops import cuda
from ..ops.distance import sq_norms
from ..persist.patch import _level_rows, to_np
from .hnsw import HnswIndex, _check


class HnswSlimIndex:
    """Pruned (Slim) index whose graph, vectors and serving layouts live on
    ``device``."""

    def __init__(self, metric: str = "l2",
                 search_cfg: SearchConfig | None = None, device=None):
        self.metric = metric
        self.scfg = search_cfg or SearchConfig()
        self.device = cuda.resolve_device(device)
        self.graph: ChalGraph | None = None
        self.vectors = None
        self.vn = None
        self.dense0 = None  # dense level-0 serving rows i32[N_pad, cap0]
        # exact-seed table (seed_width > 1): vectors, norms and ids of all
        # level>=1 nodes, keyed by the graph object it was built for
        self.up_vecs = self.up_vn = self.up_ids = None
        self._up_for = None
        self.last_stats: dict = {}

    def densify_level0(self) -> int:
        """Explode the level-0 CHAL slices into dense [N, cap0] rows (the
        serving layout of the base beam). Returns its bytes."""
        c = to_np(self.graph)
        n_pad = int(self.graph.level.shape[0])
        n = min(n_pad, len(c["lvl_off"]))
        rows = np.full((n_pad, self.graph.cap0), -1, np.int32)
        rows[:n] = _level_rows(c, 0, n, self.graph.cap0)
        self.dense0 = torch.as_tensor(rows, device=self.device)
        return int(self.dense0.numel() * 4)

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
        idx.graph = convert_to_slim(
            hnsw.graph, hnsw.vectors, hnsw.vn, slim_cfg,
            metric=hnsw.cfg.metric, count_level0_hubs=count_level0_hubs,
            verbose=verbose,
        )
        return idx

    @classmethod
    def build(cls, vectors: np.ndarray, hnsw_cfg: HnswConfig | None = None,
              slim_cfg: SlimConfig | None = None, verbose: bool = False,
              device=None) -> "HnswSlimIndex":
        """Full pipeline: build HNSW, then convert."""
        hnsw = HnswIndex(hnsw_cfg or HnswConfig(), device=device)
        hnsw.build(vectors, verbose=verbose)
        return cls.from_hnsw(hnsw, slim_cfg or SlimConfig.from_ratios(),
                             verbose=verbose)

    def set_ef(self, ef: int) -> None:
        self.scfg = dataclasses.replace(self.scfg, ef=ef)

    def _seed_table(self):
        """(up_vecs f32[n_up_pad, d], up_vn f32[n_up_pad], up_ids
        i32[n_up_pad]) over all level>=1 nodes, padded to a power of two
        (>= 64) with id -1; rebuilt when the graph object changes."""
        if self.up_ids is None or self._up_for is not self.graph:
            lv = self.graph.level.cpu().numpy()
            ids = np.nonzero(lv >= 1)[0].astype(np.int32)
            pad = max(64, 1 << max(0, len(ids) - 1).bit_length())
            idp = np.full(pad, -1, np.int32)
            idp[: len(ids)] = ids
            self.up_ids = torch.as_tensor(idp, device=self.device)
            self.up_vecs = self.vectors[self.up_ids.clamp(min=0).long()]
            self.up_vn = sq_norms(self.up_vecs)
            self._up_for = self.graph
        return self.up_vecs, self.up_vn, self.up_ids

    def search(self, queries: np.ndarray, k: int,
               filter_mask: np.ndarray | None = None):
        """(dists f32[B, k], ids i32[B, k]) as numpy — searchKnn. Sets
        ``last_stats`` (hops, distance_computations)."""
        if filter_mask is not None:
            raise NotImplementedError("filtered search: ROADMAP K6")
        g = self.graph
        ef = max(self.scfg.ef, k)
        up_vecs = up_vn = up_ids = None
        if self.scfg.seed_width > 1 and g.threshold_level == 0 \
                and g.max_level >= 1:
            up_vecs, up_vn, up_ids = self._seed_table()
        q = torch.as_tensor(np.asarray(queries, np.float32),
                            device=self.device)
        d, i, hops, dcomp = gs.chal_search(
            self.vectors, q, self.dense0, max_level=g.max_level, threshold_level=g.threshold_level,
            ef=ef, k=k, max_iters=self.scfg.iters(), metric=self.metric,
            pop_width=self.scfg.pop_width, scan_width=self.scfg.scan_width,
            seed_width=self.scfg.seed_width, up_vecs=up_vecs, up_vn=up_vn,
            up_ids=up_ids, seed_strata=self.scfg.seed_strata,
        )
        d, i = d.cpu().numpy(), i.cpu().numpy()
        self.last_stats = {
            "hops": int(hops.sum()),
            "distance_computations": int(dcomp.sum()),
        }
        return d, i

    def index_size(self) -> int:
        """Graph-only bytes in the reference's accounting."""
        return self.graph.chal_bytes()

    def check_integrity(self) -> dict:
        """checkIntegrity + the hierarchical membership rule: a level-l
        neighbor must itself be a level-l node unless l == threshold_level.
        Raises AssertionError on the first violated invariant."""
        g = self.graph
        n = g.n
        c = to_np(g)
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
        return {"edges": total_edges, "bytes": g.chal_bytes()}
