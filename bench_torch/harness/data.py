"""The cells' data, made from ``--seed`` on the device in a few large calls.

``clustered`` follows the port's ``utils/data.py clustered`` (Gaussian
clusters around standard-normal centres), drawn with a ``torch.Generator``
on the device instead of numpy: the same seed gives the same vectors on the
same device type.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Data:
    base: np.ndarray  # f32[n, dim], what the system indexes
    pool: np.ndarray  # f32[2 * pool_queries, dim]: the query pool twice, so
    # that any run of consecutive pool rows is one contiguous view
    extra: np.ndarray  # f32[n_extra, dim]: vectors to insert, base-like
    pool_n: int

    def queries(self, start: int, count: int) -> np.ndarray:
        """Pool rows start, start + 1, ... (wrapping), without a copy."""
        if count > self.pool_n:
            raise ValueError(f"{count} queries from a pool of {self.pool_n}")
        s = start % self.pool_n
        return self.pool[s:s + count]


def clustered(n: int, dim: int, n_queries: int, n_clusters: int,
              scale: float, seed: int, device, n_extra: int = 0):
    """(base, queries, extra) as f32 tensors on ``device``: every row is a
    centre (standard normal, one of ``n_clusters``, picked uniformly) plus
    ``scale`` times standard-normal noise."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))

    def draw(rows: int, centers=None):
        asn = torch.randint(0, n_clusters, (rows,), generator=g,
                            device=device)
        noise = torch.randn(rows, dim, generator=g, device=device)
        return centers[asn] + scale * noise

    centers = torch.randn(n_clusters, dim, generator=g, device=device)
    base = draw(n, centers)
    queries = draw(n_queries, centers)
    extra = draw(n_extra, centers)
    return base, queries, extra


def make(cfg: dict, seed: int, device, n_extra: int = 0) -> Data:
    """The configuration's data from the seed, handed to the host (the
    system under test takes host arrays)."""
    d = cfg["data"]
    base, queries, extra = clustered(
        cfg["n"], cfg["dim"], d["pool_queries"], d["n_clusters"], d["scale"],
        seed, device, n_extra)
    host = [t.cpu().numpy() for t in (base, queries, extra)]
    del base, queries, extra
    return Data(base=host[0], pool=np.concatenate([host[1], host[1]]),
                extra=host[2], pool_n=d["pool_queries"])
