"""A client's local SlimQ index: ``HnswSlimQIndex.build`` (the insertion
build, the Slim conversion, KMeans, the rotation and the RaBitQ codes; the
raw vectors kept for the rerank), both dense serving layouts, and the
configuration's search knobs; queried through ``HnswSlimQIndex.search``."""

from __future__ import annotations

import torch


class SlimQIndexSystem:
    def __init__(self, index):
        self.index = index
        self.info = {"n": int(index.graph.n),
                     "dim": int(index.dataset.shape[1]),
                     "n_up": int((index.graph.level >= 1).sum()),
                     "p": 32 * int(index.codes.bin_code.shape[1]),
                     "clusters": int(index.centroids_rot.shape[0])}

    def search(self, queries, k: int):
        """(d f32[B, k], ids i32[B, k]) as host arrays: the reranked top k,
        with exact distances."""
        return self.index.search(queries, k)

    def close(self) -> None:
        self.index = None


def build(cfg: dict, data, device) -> SlimQIndexSystem:
    from hnsw_slim_tpu_torch.config import (HnswConfig, QuantConfig,
                                            SearchConfig, SlimConfig)
    from hnsw_slim_tpu_torch.index.slimq import HnswSlimQIndex

    idx = HnswSlimQIndex.build(
        data.base, hnsw_cfg=HnswConfig(**cfg["hnsw"]),
        slim_cfg=SlimConfig.from_ratios(**cfg["slim"]),
        quant_cfg=QuantConfig(**cfg["quant"]), device=device)
    idx.densify_level0()
    idx.densify_upper()
    idx.scfg = SearchConfig(**cfg["search"])
    if torch.cuda.is_available() and idx.codes.bin_code.is_cuda:
        torch.cuda.synchronize()
    return SlimQIndexSystem(idx)
