"""The S-way top-k merge of per-shard results, kernel K19
(csrc/shard_merge.cu).

Port of the merge in hnsw_slim_tpu/parallel/sharded.py (``_local_search``'s
id map and ``_sharded_search_jit``'s all_gather + sort + psum) and of the
host merge of parallel/flat_union.py's ``seed_width == 0`` search: every
shard's local ids map to global ids through a gid table (-1 marks a padded
node), the distance of an entry whose global id is < 0 becomes +inf, and
each query keeps the first k of a stable sort by distance over its shards'
lists concatenated shard-major (ties keep shard order); hops and distance
computations are summed over shards.
"""

from __future__ import annotations

import torch

from ..ops import cuda

INF = float("inf")


def _global_ids(ids, gid):
    """Global id of every entry of ids i32[S, B, k]; -1 where the local id
    is < 0. gid: i32[S, n_per] per shard or i32[G] for all shards."""
    s = ids.shape[0]
    safe = ids.clamp(min=0).long()
    if gid.dim() == 1:
        g = gid[safe]
    else:
        g = torch.gather(gid, 1, safe.reshape(s, -1)).reshape(ids.shape)
    return torch.where(ids >= 0, g, -1).to(torch.int32)


def merge_topk_plain(d, ids, gid, hops, dcomp):
    """Plain PyTorch K19: a stable sort of the concatenation. d f32[S, B, k]
    and local ids i32[S, B, k] (views of any strides), gid i32[S, n_per] or
    i32[G], hops / dcomp i32[S, B]. Returns (d f32[B, k], global ids
    i32[B, k], hops i32[B], dcomp i32[B])."""
    s, b, k = d.shape
    gi = _global_ids(ids, gid)
    dd = torch.where(gi >= 0, d, INF)
    cat_d = dd.permute(1, 0, 2).reshape(b, s * k)
    cat_i = gi.permute(1, 0, 2).reshape(b, s * k)
    sd, order = torch.sort(cat_d, dim=1, stable=True)
    return (sd[:, :k].contiguous(),
            torch.gather(cat_i, 1, order[:, :k]).contiguous(),
            hops.sum(0, dtype=torch.int32), dcomp.sum(0, dtype=torch.int32))


def merge_topk(d, ids, gid, hops, dcomp):
    """K19: the merge of merge_topk_plain, one warp per query. Each shard's
    list must come sorted ascending by distance (chal_search returns its
    beam buffer so); d and ids may be strided views (a [B, S, k] tensor
    permuted to [S, B, k] needs no copy) with the last dimension dense. CUDA
    tensors launch csrc/shard_merge.cu, CPU tensors run merge_topk_plain."""
    if not d.is_cuda:
        return merge_topk_plain(d, ids, gid, hops, dcomp)
    s, b, k = d.shape
    if not 1 <= s <= 32:
        raise ValueError(f"merge_topk: {s} shards (1..32)")
    for t, name, dtype in ((d, "d", torch.float32), (ids, "ids", torch.int32),
                           (hops, "hops", torch.int32),
                           (dcomp, "dcomp", torch.int32)):
        if not t.is_cuda or t.dtype != dtype:
            raise ValueError(f"merge_topk: {name} must be a CUDA {dtype}")
    if ids.shape != d.shape or ids.stride() != d.stride() or d.stride(2) != 1:
        raise ValueError("merge_topk: d and ids need one shape and one "
                         "layout with a dense last dimension")
    if hops.shape != (s, b) or dcomp.shape != (s, b) \
            or hops.stride() != dcomp.stride():
        raise ValueError("merge_topk: hops and dcomp must be [S, B] views "
                         "of one layout")
    if gid.dim() == 1:
        cuda.require(gid, torch.int32, "gid", (-1,))
        gid_stride = 0
    else:
        cuda.require(gid, torch.int32, "gid", (s, -1))
        gid_stride = gid.shape[1]
    dev = d.device
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    out_h = torch.empty((b,), dtype=torch.int32, device=dev)
    out_c = torch.empty((b,), dtype=torch.int32, device=dev)
    if b and k:
        cuda.launch(
            "shard_merge", d.data_ptr(), ids.data_ptr(), d.stride(0),
            d.stride(1), gid.data_ptr(), gid_stride, hops.data_ptr(),
            dcomp.data_ptr(), hops.stride(0), hops.stride(1), s, b, k,
            out_d.data_ptr(), out_i.data_ptr(), out_h.data_ptr(),
            out_c.data_ptr())
    return out_d, out_i, out_h, out_c
