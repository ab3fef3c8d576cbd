"""Distance functions (port of hnsw_slim_tpu/ops/distance.py).

Same expansion as the JAX code, so near-ties break the same way:
    L2²(q, x) = ‖q‖² + ‖x‖² − 2 qᵀx
    IPdist(q, x) = 1 − qᵀx

The GEMM forms run as fp32 ``torch.matmul``. The JAX package computes them
at ``Precision.HIGHEST`` (true fp32), so TF32 is switched off for cuBLAS and
cuDNN when this module is imported. ``gathered_dist`` and ``point_dist`` are
kernel K1 (csrc/point_dist.cu) on CUDA tensors and their plain versions on
CPU tensors; the gathered form inside the other kernels' loops is fused into
those kernels (beam search, prune, NN-descent merge).

Rows may be fp32 or bfloat16 (a ``store_dtype="bfloat16"`` store): they are
widened to fp32 element by element and every sum is fp32, as the JAX code
upcasts before its einsum.
"""

from __future__ import annotations

import torch

from . import cuda

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F32 = torch.float32
INF = float("inf")
NORM_CHUNK = 1 << 20  # rows per sq_norms pass over a bfloat16 store


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """‖x‖² per row: f32[...]. A bfloat16 table is reduced in chunks of
    NORM_CHUNK rows, so its fp32 upcast never exists whole (8 GB at
    16M × 128)."""
    if x.dtype == F32:
        return torch.sum(x * x, dim=-1)
    if x.dim() != 2 or x.shape[0] <= NORM_CHUNK:
        x = x.to(F32)
        return torch.sum(x * x, dim=-1)
    return torch.cat([sq_norms(x[s:s + NORM_CHUNK])
                      for s in range(0, x.shape[0], NORM_CHUNK)])


def pairwise_dist(q, x, metric: str = "l2", qn=None, xn=None) -> torch.Tensor:
    """All-pairs distances f32[B, N] between q[B, d] and x[N, d]."""
    dots = q.to(F32) @ x.to(F32).T
    if metric == "ip":
        return 1.0 - dots
    if qn is None:
        qn = sq_norms(q)
    if xn is None:
        xn = sq_norms(x)
    return qn[:, None] + xn[None, :] - 2.0 * dots


def gathered_dist_plain(q, vecs, metric: str = "l2", qn=None, vn=None,
                        ids=None) -> torch.Tensor:
    """Plain PyTorch K1 (see gathered_dist): a gather, then ``torch.bmm``."""
    if ids is not None:
        ok = ids >= 0
        safe = ids.clamp(min=0).long()
        d = gathered_dist_plain(q, vecs[safe], metric, qn=qn,
                                vn=None if vn is None else vn[safe])
        return torch.where(ok, d, INF)
    dots = torch.bmm(vecs.to(F32), q.to(F32)[:, :, None])[:, :, 0]
    if metric == "ip":
        return 1.0 - dots
    if qn is None:
        qn = sq_norms(q)
    if vn is None:
        vn = sq_norms(vecs)
    return qn[:, None] + vn - 2.0 * dots


def gathered_dist(q, vecs, metric: str = "l2", qn=None, vn=None,
                  ids=None) -> torch.Tensor:
    """K1: distances f32[B, W] between q[B, d] and per-query rows.

    Without ``ids`` the rows are vecs[B, W, d] and ``vn`` (optional) their
    squared norms f32[B, W]. With ``ids`` i32[B, W] they are vecs[ids] of a
    store vecs[N, d], gathered inside the kernel, and ``vn`` (optional) is
    the store's f32[N]; a negative id gives +inf. Without ``vn`` the norms
    come from the rows. Rows are fp32 or bfloat16. CUDA tensors launch
    csrc/point_dist.cu, CPU tensors run gathered_dist_plain."""
    if not q.is_cuda:
        return gathered_dist_plain(q, vecs, metric, qn, vn, ids)
    b, d = q.shape
    if ids is None:
        w = vecs.shape[1]
        rows = vecs.reshape(b * w, d).contiguous()
    else:
        w = ids.shape[1]
        rows = vecs
        cuda.require(ids, torch.int32, "ids", (b, w))
    return _point_launch(q, rows, metric, qn, vn, ids, w, diff=False)


def point_dist_plain(a, b, metric: str = "l2") -> torch.Tensor:
    """Plain PyTorch rowwise distance (see point_dist)."""
    a = a.to(F32)
    b = b.to(F32)
    if metric == "ip":
        return 1.0 - torch.sum(a * b, dim=-1)
    diff = a - b
    return torch.sum(diff * diff, dim=-1)


def point_dist(a, b, metric: str = "l2") -> torch.Tensor:
    """K1 rowwise: f32[B] between a f32[B, d] and rows b[B, d] (fp32 or
    bfloat16), in the difference form Σ(a − b)² (or 1 − aᵀb). CUDA tensors
    launch csrc/point_dist.cu, CPU tensors run point_dist_plain."""
    if not a.is_cuda:
        return point_dist_plain(a, b, metric)
    return _point_launch(a, b, metric, None, None, None, 1, diff=True)[:, 0]


def _point_launch(q, rows, metric, qn, vn, ids, w: int, diff: bool):
    """Validate and launch K1 over q f32[B, d] and rows[*, d]."""
    b, d = q.shape
    cuda.require(q, F32, "q", (b, d))
    cuda.require(rows, cuda.ROW_TYPES, "rows", (-1, d))
    if metric == "l2" and not diff:
        if qn is None:
            qn = sq_norms(q)
        cuda.require(qn, F32, "qn", (b,))
    else:
        qn = None
    if vn is not None:
        cuda.require(vn, F32, "vn",
                     (rows.shape[0],) if ids is not None else (b, w))
    out = torch.empty((b, w), dtype=F32, device=q.device)
    if b and w:
        entry, modes = cuda.row_type(rows, "point_dist")
        cuda.launch(
            "point_dist", q.data_ptr(), None if qn is None else qn.data_ptr(),
            rows.data_ptr(), None if vn is None else vn.data_ptr(),
            None if ids is None else ids.data_ptr(), b, w, d,
            int(metric == "ip"), int(diff), out.data_ptr(), entry=entry,
            modes=modes)
    return out
