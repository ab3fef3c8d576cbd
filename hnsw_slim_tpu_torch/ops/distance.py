"""Distance functions (port of hnsw_slim_tpu/ops/distance.py).

Same expansion as the JAX code, so near-ties break the same way:
    L2²(q, x) = ‖q‖² + ‖x‖² − 2 qᵀx
    IPdist(q, x) = 1 − qᵀx

The GEMM forms run as fp32 ``torch.matmul``. The JAX package computes them
at ``Precision.HIGHEST`` (true fp32), so TF32 is switched off for cuBLAS and
cuDNN when this module is imported. ``sq_norms`` is kernel Kξ
(csrc/row_norms.cu) on CUDA tensors, ``gathered_dist`` and ``point_dist``
are kernel K1 (csrc/point_dist.cu); CPU tensors take their plain versions.
The gathered form inside the other kernels' loops is fused into those
kernels (beam search, prune, NN-descent merge). The plain versions of every
kernel take their norms from ``sq_norms``, so on the card a kernel and its
plain version see the same norms.

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


def sq_norms_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Kξ: ‖x‖² per row, f32[x.shape[:-1]] (bfloat16 rows
    widened to fp32 first)."""
    x = x.to(F32)
    return torch.sum(x * x, dim=-1)


# Kξ's C entry point and modes by row type
_NORM_ENTRY = {torch.float32: ("row_norms", ()),
               torch.bfloat16: ("row_norms_bf16", ("bf16",))}


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """Kξ: ‖x‖² per row, f32[x.shape[:-1]], from fp32 or bfloat16 rows of
    any width (a 1-D x gives a 0-d tensor). CUDA tensors launch
    csrc/row_norms.cu: one pass, no temporary beyond the output, 2-D rows
    may be strided; CPU tensors run sq_norms_plain. A contiguous 2-D batch
    (every query batch, every store) takes a short path with no view or
    stride test; the launch is the same."""
    if not x.is_cuda:
        return sq_norms_plain(x)
    ent = _NORM_ENTRY.get(x.dtype)
    if ent is None:
        raise ValueError(f"sq_norms: expected {cuda.ROW_TYPES}, got "
                         f"{x.dtype}")
    if x.dim() == 2 and x.is_contiguous():
        n, d = x.shape
        out = x.new_empty(n, dtype=F32)  # the cheapest allocation call
        if n:
            cuda.launch("row_norms", x.data_ptr(), n, d, d, out.data_ptr(),
                        entry=ent[0], modes=ent[1])
        return out
    out = torch.empty(x.shape[:-1], dtype=F32, device=x.device)
    n, d = out.numel(), x.shape[-1]
    if n == 0:
        return out
    try:
        rows = x.view(n, d)
    except RuntimeError as e:
        raise ValueError(f"sq_norms: x{tuple(x.shape)} is not a view of "
                         f"[N, D] rows") from e
    if d > 1 and rows.stride(1) != 1 or n > 1 and rows.stride(0) < d:
        raise ValueError(f"sq_norms: rows of x{tuple(x.shape)} are not "
                         f"contiguous, non-overlapping runs of D elements")
    cuda.launch("row_norms", rows.data_ptr(), n, d, rows.stride(0),
                out.data_ptr(), entry=ent[0], modes=ent[1])
    return out


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
