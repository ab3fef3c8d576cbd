"""The plain reference of the label-filtered configurations: the exact k
nearest neighbours under squared L2 among the rows whose tag word holds the
query's need word (``filtered_topk``), for recall and ``filter_miss``, and
``exact_knn``'s ``pair_dist`` and ``to_device`` for the distances of the
answers (and its unfiltered ``exact_topk``, which every reference has).

The filtered part is a copy of the repository's ``tests/plain_filtered.py``
(the benchmark imports nothing from ``tests/``; a tier-1 test holds the two
equal): plain float32 PyTorch with TF32 off, in blocks, importing nothing of
the index packages. Tag and need words are u32 held as int32 (the same
bits); row x is allowed for query q iff (tags[x] & need[q]) == need[q], so
one-hot words make the predicate an equality test on a label. A query whose
predicate allows fewer than k rows gets those rows, then -1 ids at inf
distance, as the index returns them.

``tf32=True`` computes the same top-k with TF32 matrix products (on a CPU
the products' inputs are rounded to TF32's 10-bit mantissa first): the
control, the reference one precision below what the configuration states.
"""

from __future__ import annotations

import numpy as np
import torch

from reference.exact_knn import (exact_topk, matmul_precision,  # noqa: F401
                                  pair_dist, round_tf32, to_device)


def words(a) -> torch.Tensor:
    """u32 words (integers below 2**32, as an array or a list) as int32
    bits."""
    return torch.as_tensor(np.asarray(a, np.int64).astype(np.uint32)
                           .view(np.int32))


def passes(tags: torch.Tensor, need: torch.Tensor) -> torch.Tensor:
    """bool[B, M]: row tags[m] (i32[M]) allowed for need word need[b]
    (i32[B])."""
    nd = need[:, None]
    return (tags[None, :] & nd) == nd


def filtered_topk(base: torch.Tensor, queries: torch.Tensor,
                  tags: torch.Tensor, need: torch.Tensor, k: int, *,
                  tf32: bool = False, q_block: int = 2048,
                  x_block: int = 1 << 18):
    """(d f32[B, k], ids i64[B, k]), ascending: the k allowed rows of
    ``base`` nearest each query, distances ||q||^2 + ||x||^2 - 2 q.x in
    float32; inf / -1 past the allowed rows."""
    xn = (base * base).sum(1)
    emulate = tf32 and base.device.type != "cuda"
    out_d, out_i = [], []
    with matmul_precision(tf32):
        for q0 in range(0, len(queries), q_block):
            q = queries[q0:q0 + q_block]
            nq = need[q0:q0 + q_block]
            qn = (q * q).sum(1, keepdim=True)
            qm = round_tf32(q) if emulate else q
            best_d = best_i = None
            for x0 in range(0, len(base), x_block):
                x = base[x0:x0 + x_block]
                xm = round_tf32(x) if emulate else x
                d = qn + xn[x0:x0 + x_block] - 2.0 * (qm @ xm.T)
                d = torch.where(passes(tags[x0:x0 + x_block], nq), d,
                                float("inf"))
                dd, ii = torch.topk(d, min(k, d.shape[1]), dim=1,
                                    largest=False)
                ii = ii + x0
                if best_d is not None:
                    dd = torch.cat([best_d, dd], 1)
                    ii = torch.cat([best_i, ii], 1)
                    dd, j = torch.topk(dd, min(k, dd.shape[1]), dim=1,
                                       largest=False)
                    ii = torch.gather(ii, 1, j)
                best_d, best_i = dd, ii
            if best_d.shape[1] < k:
                pad = k - best_d.shape[1]
                best_d = torch.cat([best_d, best_d.new_full(
                    (len(q), pad), float("inf"))], 1)
                best_i = torch.cat([best_i, best_i.new_full((len(q), pad),
                                                            -1)], 1)
            out_d.append(best_d)
            out_i.append(torch.where(torch.isinf(best_d), -1, best_i))
    return torch.cat(out_d), torch.cat(out_i)


def filter_misses(tags: torch.Tensor, need: torch.Tensor,
                  ids: torch.Tensor) -> int:
    """The returned ids (>= 0, i64/i32[B, k]) whose row fails its query's
    need word (need i32[B])."""
    ok = ids >= 0
    t = tags[ids.clamp(min=0).long()]
    nd = need[:, None]
    return int((ok & ((t & nd) != nd)).sum())
