"""HNSW-SlimZero index (port of hnsw_slim_tpu/index/slimzero.py): in-degree-
guarded pruning, no reverse-edge union. Search, serving layouts and
persistence are the Slim index's (same CHAL layout); only the conversion
differs (``graph/prune.convert_to_slimzero``, Kγ in guarded mode).
"""

from __future__ import annotations

import math

from ..config import SlimConfig
from ..graph.prune import convert_to_slimzero
from .slim import HnswSlimIndex


class HnswSlimZeroIndex(HnswSlimIndex):
    """``from_hnsw`` and ``build`` are the Slim index's, run through the
    SlimZero conversion."""

    _convert = staticmethod(convert_to_slimzero)

    @staticmethod
    def size_estimate(n: int, branching_factor: str,
                      slim_cfg: SlimConfig) -> float:
        """Closed-form index-size model in bytes (the reference strategy's
        estimate)."""
        decay = 1.0 / float(branching_factor)
        size_1 = 16.0 * n
        size_2 = 2.0 * n * decay / (1 - decay)
        mix = (slim_cfg.top_degree_percent * slim_cfg.top_M
               + (1 - slim_cfg.top_degree_percent) * slim_cfg.low_m)
        if slim_cfg.threshold_level == 0:
            size_3 = 4.0 * n * (2 + decay) * mix
        else:
            size_3 = (4.0 * n
                      * (2 - decay
                         + math.pow(decay, slim_cfg.threshold_level + 1))
                      * mix)
        return size_1 + size_2 + size_3
