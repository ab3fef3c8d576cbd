"""A client's local Slim index: ``HnswSlimIndex.build`` (the insertion
build at scale, then the two-stage conversion), both dense serving layouts,
and the configuration's search knobs; queried through
``HnswSlimIndex.search``."""

from __future__ import annotations

import torch


class SlimIndexSystem:
    def __init__(self, index):
        self.index = index
        self.info = {"n": int(index.graph.n), "dim": int(index.vectors.shape[1]),
                     "n_up": int((index.graph.level >= 1).sum())}

    def search(self, queries, k: int):
        """(d f32[B, k], ids i32[B, k]) as host arrays."""
        return self.index.search(queries, k)

    def close(self) -> None:
        self.index = None


def build(cfg: dict, data, device) -> SlimIndexSystem:
    from hnsw_slim_tpu_torch.config import HnswConfig, SearchConfig, SlimConfig
    from hnsw_slim_tpu_torch.index.slim import HnswSlimIndex

    idx = HnswSlimIndex.build(
        data.base, hnsw_cfg=HnswConfig(**cfg["hnsw"]),
        slim_cfg=SlimConfig.from_ratios(**cfg["slim"]), device=device)
    idx.densify_level0()
    idx.densify_upper()
    idx.scfg = SearchConfig(**cfg["search"])
    if torch.cuda.is_available() and idx.vectors.is_cuda:
        torch.cuda.synchronize()
    return SlimIndexSystem(idx)
