"""Exact k-nearest neighbours under squared L2, in plain float32 PyTorch
with TF32 off, computed in blocks so that it fits beside nothing else.

``tf32=True`` computes the same top-k with TF32 matrix products: the control,
the reference put in the system's place one precision below what the
configurations state (fp32 with TF32 off). A CPU has no TF32 unit, so there
the products' inputs are rounded to TF32's 10-bit mantissa first.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 on or off for float32 matrix products, restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to nearest on TF32's 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def exact_topk(base: torch.Tensor, queries: torch.Tensor, k: int, *,
               tf32: bool = False, q_block: int = 2048,
               x_block: int = 1 << 18):
    """(d f32[B, k], ids i64[B, k]), ascending: the k rows of ``base`` nearest
    each query, distances ||q||^2 + ||x||^2 - 2 q.x in float32."""
    xn = (base * base).sum(1)
    emulate = tf32 and base.device.type != "cuda"
    out_d, out_i = [], []
    with matmul_precision(tf32):
        for q0 in range(0, len(queries), q_block):
            q = queries[q0:q0 + q_block]
            qn = (q * q).sum(1, keepdim=True)
            qm = round_tf32(q) if emulate else q
            best_d = best_i = None
            for x0 in range(0, len(base), x_block):
                x = base[x0:x0 + x_block]
                xm = round_tf32(x) if emulate else x
                d = qn + xn[x0:x0 + x_block] - 2.0 * (qm @ xm.T)
                kk = min(k, d.shape[1])
                dd, ii = torch.topk(d, kk, dim=1, largest=False)
                ii = ii + x0
                if best_d is not None:
                    dd = torch.cat([best_d, dd], 1)
                    ii = torch.cat([best_i, ii], 1)
                    dd, j = torch.topk(dd, min(k, dd.shape[1]), dim=1,
                                       largest=False)
                    ii = torch.gather(ii, 1, j)
                best_d, best_i = dd, ii
            out_d.append(best_d)
            out_i.append(best_i)
    return torch.cat(out_d), torch.cat(out_i)


def pair_dist(base: torch.Tensor, queries: torch.Tensor,
              ids: torch.Tensor) -> torch.Tensor:
    """f32[B, k]: the squared L2 distance of each query to each of its
    ``ids`` rows, from the differences (no cancellation); nan where an id is
    out of range."""
    n = base.shape[0]
    valid = (ids >= 0) & (ids < n)
    rows = base[ids.clamp(0, n - 1)]  # [B, k, dim]
    diff = rows - queries[:, None, :]
    d = (diff * diff).sum(-1)
    return torch.where(valid, d, torch.full_like(d, float("nan")))


def to_device(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), device=device)
