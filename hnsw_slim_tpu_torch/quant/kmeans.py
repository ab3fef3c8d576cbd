"""Lloyd's KMeans on the index's device (port of
hnsw_slim_tpu/quant/kmeans.py): the KMeans-16 centroids and cluster ids that
the SlimQ build quantizes against.

``_assign`` is the nearest-centroid search: kernel Kα (``topk_dist`` with
k = 1 and the centroids as its table) on CUDA tensors, its plain version on
the CPU. Initial centers and the reseeding of empty clusters draw from the
same numpy generator as the JAX package, so both engines start equal; the
centroid sums are float64 ``index_add_`` on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..index.bruteforce import topk_dist
from ..ops import cuda
from ..ops.distance import sq_norms


def _assign(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """i64[B]: index of the nearest centroid (L2; lowest index on ties)."""
    return topk_dist(x, cent, sq_norms(cent), 1)[1][:, 0].long()


def kmeans(vectors, k: int = 16, iters: int = 25, seed: int = 0,
           batch: int = 262144, device=None):
    """(centroids f32[k, d], assignments i32[N]) by Lloyd's iterations, as
    numpy arrays. ``vectors``: a numpy array, or a tensor already on the
    device."""
    if isinstance(vectors, torch.Tensor):
        xt = vectors
    else:
        xt = torch.as_tensor(np.asarray(vectors, np.float32),
                             device=cuda.resolve_device(device))
    n, d = xt.shape
    dev = xt.device
    rng = np.random.default_rng(seed)

    def rows(ids):
        return xt[torch.as_tensor(ids, device=dev)].cpu().numpy()

    cent = rows(rng.choice(n, size=k, replace=False))
    asn = torch.zeros(n, dtype=torch.int64, device=dev)
    for _ in range(iters):
        ct = torch.as_tensor(cent, device=dev)
        for s in range(0, n, batch):
            e = min(s + batch, n)
            asn[s:e] = _assign(xt[s:e].contiguous(), ct)
        sums = torch.zeros((k, d), dtype=torch.float64, device=dev)
        for s in range(0, n, batch):
            e = min(s + batch, n)
            sums.index_add_(0, asn[s:e], xt[s:e].double())
        counts = torch.bincount(asn, minlength=k).double()
        sums, counts = sums.cpu().numpy(), counts.cpu().numpy()
        empty = counts == 0
        if empty.any():  # reseed empty clusters
            cent[empty] = rows(rng.choice(n, size=int(empty.sum())))
        nz = ~empty
        cent[nz] = (sums[nz] / counts[nz, None]).astype(np.float32)
    return cent, asn.cpu().numpy().astype(np.int32)
