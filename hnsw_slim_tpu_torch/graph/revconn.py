"""Fused insert apply (port of hnsw_slim_tpu/graph/revconn.py).

mutuallyConnectNewElement (hnswalg.h:549-687) for a batch of inserted nodes
at one level, in the JAX program's order:

1. forward prune of each node's candidates to M with the under-M early-out
   (kernel Kγ);
2. forward scatter of those rows and their degrees;
3. the reverse edges u -> p, stably sorted by target u, so that a target's
   new edges come in ascending inserter order (kernel Kι: the ids map of
   the radix sort Kκ);
4. fitting appends at column deg[u] + rank within the target's run, the
   degree update, and the first ``of_t`` overflow targets in ascending id
   order with their candidate rows {row ∪ their first ``new_w`` new
   edges} (kernel Kζ, ``append_overflow``: one call, two launches). The
   JAX program sorts the overflow edges by target and the first-of-run
   targets once more; both lists are already in order (a target's
   overflow edges are the tail of its run), so the kernel numbers them
   with a scan instead;
5. the candidate rows re-pruned down to the cap (Kγ) and written back (Kζ).

``adj`` and ``deg`` are updated in place (the JAX program donates them).
No step reads a value back to the host, so a batch costs no device sync;
the overflow counters stay on the device until the builder asks.
"""

from __future__ import annotations

import torch

from ..ops import cuda
from ..ops.sort import kv_radix_sort
from .heuristic import rng_prune

BIG = 2**30


def rev_append_plain(adj, deg, us, ps):
    """Plain PyTorch Kζ append: for the target-sorted edge list (us i32[E],
    2^30 = padding; ps i32[E] inserters) write each edge at column
    deg[u] + rank where that is below the cap, and add the appended edges
    to deg. Returns ovf bool[E] (edges that did not fit)."""
    cap = adj.shape[1]
    iota = torch.arange(us.shape[0], device=us.device)
    rank = iota - torch.searchsorted(us, us, side="left")
    valid = us < BIG
    safe_u = torch.where(valid, us, 0).long()
    col = deg[safe_u].long() + rank
    ok = valid & (col < cap)
    adj.view(-1)[(safe_u * cap + col)[ok]] = ps[ok]
    deg.index_add_(0, safe_u[ok], torch.ones_like(ps[ok]))
    return valid & (col >= cap)


def overflow_rows_plain(adj, of_u, of_p, ut, new_w: int):
    """Plain PyTorch Kζ row assembly: for each overflow target ut i32[T]
    (2^30 = padding) its row followed by its first new_w new edges from the
    sorted overflow list (of_u, of_p). Returns (base i32[T], 0 for padding;
    cand i32[T, cap + new_w], empty rows for padding)."""
    e = of_u.shape[0]
    tvalid = ut < BIG
    safe_t = torch.where(tvalid, ut, 0)
    start = torch.searchsorted(of_u, safe_t, side="left")
    tcnt = torch.searchsorted(of_u, safe_t, side="right") - start
    cur = torch.where(tvalid[:, None], adj[safe_t.long()], -1)
    j = torch.arange(new_w, device=ut.device)[None, :]
    srcpos = (start[:, None] + j).clamp(0, max(e - 1, 0))
    newmat = torch.where(
        (j < tcnt.clamp(max=new_w)[:, None]) & tvalid[:, None],
        of_p[srcpos], -1)
    return safe_t.to(torch.int32), torch.cat([cur, newmat], dim=1)


def write_rows_plain(adj, deg, ut, osel, ocnt):
    """Plain PyTorch Kζ write-back: adj[u] = osel, deg[u] = ocnt for every
    valid target u of ut (2^30 = padding)."""
    ok = ut < BIG
    rows = ut[ok].long()
    adj[rows] = osel[ok]
    deg[rows] = ocnt[ok]


def write_rows(adj, deg, ut, osel, ocnt):
    """Kζ write-back, one warp per target (csrc/rev_connect.cu). CPU tensors
    run ``write_rows_plain``."""
    if not adj.is_cuda:
        return write_rows_plain(adj, deg, ut, osel, ocnt)
    n, cap = adj.shape
    t = ut.shape[0]
    cuda.require(adj, torch.int32, "adj", (n, cap))
    cuda.require(deg, torch.int32, "deg", (n,))
    cuda.require(ut, torch.int32, "ut", (t,))
    cuda.require(osel, torch.int32, "osel", (t, cap))
    cuda.require(ocnt, torch.int32, "ocnt", (t,))
    if t:
        cuda.launch("rev_connect", adj.data_ptr(), deg.data_ptr(), cap,
                    ut.data_ptr(), t, osel.data_ptr(), ocnt.data_ptr(),
                    entry="rev_write_rows")


def kv_sort_plain(keys, payload=None, n=None):
    """Plain PyTorch Kι: keys i32[E] ascending, equal keys in input order,
    with payload i32[E] (or None) carried along. Returns (keys, payload).
    ``n`` is ignored: the ids map orders ids below n and the 2^30 padding as
    the i32 order does."""
    out, order = torch.sort(keys, stable=True)
    return out, None if payload is None else payload[order]


def kv_sort(keys, payload=None, n=None):
    """Kι, a mode of Kκ (csrc/radix_sort.cu): stable ascending sort of keys
    i32[E] carrying payload i32[E] (None: keys only). With ``n`` the keys are
    node ids below n or the 2^30 padding, sorted over n.bit_length() bits
    (the ``radix_sort.ids`` mode); without it, any i32 keys (the signed
    map). CPU tensors run ``kv_sort_plain``. Returns new contiguous (keys,
    payload); nothing is read back."""
    if not keys.is_cuda:
        return kv_sort_plain(keys, payload, n)
    if n is None:
        return kv_radix_sort(keys, payload, 32, key_map="signed")
    return kv_radix_sort(keys, payload, max(1, n.bit_length()),
                         key_map="ids")


def reverse_edges(a_ids, sel, n=None):
    """The reverse-edge list of forward rows sel i32[P, M] (-1 padded) of
    inserted nodes a_ids i32[P], stably sorted by target: (us i32[E],
    ps i32[E]), padding targets 2^30 last. ``n`` bounds the node ids (the
    ids map of ``kv_sort``)."""
    p_rows, m = sel.shape
    u = torch.where(sel >= 0, sel, BIG).reshape(-1)
    p = a_ids[:, None].expand(p_rows, m).reshape(-1)
    return kv_sort(u.contiguous(), p.contiguous(), n)


def overflow_targets_plain(us, ps, ovf, of_t: int):
    """Overflow edges in target order and the first of_t overflow targets in
    ascending id order (padding 2^30), by the JAX program's two stable
    sorts (``kv_sort_plain``). Returns (of_u, of_p, ut, of_edges,
    of_targets) — the last two are 0-d tensors."""
    of_edges = ovf.sum(dtype=torch.int32)
    of_u, of_p = kv_sort_plain(torch.where(ovf, us, BIG), ps)
    valid = of_u < BIG
    first = valid.clone()
    first[1:] &= of_u[1:] != of_u[:-1]
    of_targets = first.sum(dtype=torch.int32)
    t = min(of_t, us.shape[0])
    ut = kv_sort_plain(torch.where(first, of_u, BIG))[0][:t].contiguous()
    return of_u, of_p, ut, of_edges, of_targets


def append_overflow_plain(adj, deg, us, ps, of_t: int, new_w: int):
    """Plain PyTorch Kζ append + settle, the JAX program's composition:
    ``rev_append_plain``, ``overflow_targets_plain`` (two sorts) and
    ``overflow_rows_plain``. Returns (ut i32[T], base i32[T],
    cand i32[T, cap + new_w], of_edges, of_targets) with T = min(of_t, E);
    adj and deg change in place."""
    ovf = rev_append_plain(adj, deg, us, ps)
    of_u, of_p, ut, of_edges, of_targets = overflow_targets_plain(us, ps, ovf,
                                                                  of_t)
    base, cand = overflow_rows_plain(adj, of_u, of_p, ut, new_w)
    return ut, base, cand, of_edges, of_targets


SETTLE_TILE = 1024  # edges a tile of rev_connect.cu's settle launch takes


def append_overflow(adj, deg, us, ps, of_t: int, new_w: int):
    """Kζ append + settle (csrc/rev_connect.cu hs_rev_apply, two launches):
    the fitting appends of the target-sorted edge list (us i32[E], 2^30 =
    padding; ps i32[E] inserters), the degree update, and the first of_t
    overflow targets with their candidate rows, numbered by a scan over
    the runs. CPU tensors run ``append_overflow_plain``. Same arguments and
    results; the counters are device scalars."""
    if not adj.is_cuda:
        return append_overflow_plain(adj, deg, us, ps, of_t, new_w)
    n, cap = adj.shape
    e = us.shape[0]
    cuda.require(adj, torch.int32, "adj", (n, cap))
    cuda.require(deg, torch.int32, "deg", (n,))
    cuda.require(us, torch.int32, "us", (e,))
    cuda.require(ps, torch.int32, "ps", (e,))
    t = min(of_t, e)
    tiles = max(1, -(-e // SETTLE_TILE))
    dev = adj.device
    cand = torch.empty((t, cap + new_w), dtype=torch.int32, device=dev)
    # ut, base, the tile ticket (and a pad word), the look-back words (u64)
    meta = torch.empty((2 * t + 2 + 2 * tiles,), dtype=torch.int32,
                       device=dev)
    counters = torch.empty((2,), dtype=torch.int32, device=dev)
    ptr = meta.data_ptr()
    cuda.launch("rev_connect", us.data_ptr(), ps.data_ptr(), e,
                adj.data_ptr(), deg.data_ptr(), cap, t, new_w, ptr,
                ptr + 4 * t, cand.data_ptr(), ptr + 8 * t, ptr + 8 * t + 8,
                tiles, counters.data_ptr(), entry="rev_apply")
    return meta[:t], meta[t:2 * t], cand, counters[0], counters[1]


def apply_insert(adj, deg, vecs, vn, a_ids, cand, *, M: int, cap: int,
                 metric: str, of_t: int, new_w: int):
    """Connect inserted nodes a_ids i32[P] to their search candidates
    cand i32[P, C] (-1 padded) at one level: adj i32[N, cap] and deg i32[N]
    change in place. Returns (of_edges, of_targets): overflowing reverse
    edges and unique overflow targets, device scalars for monitoring."""
    b = a_ids.shape[0]
    dev = adj.device
    sel, cnt = rng_prune(
        vecs, vn, a_ids, cand, torch.full((b,), M, dtype=torch.int32,
                                          device=dev),
        keep_all_under_m=True, keep_pruned=False, out_width=M, metric=metric,
        m_max=M)
    rows = a_ids.long()
    adj[rows] = torch.nn.functional.pad(sel, (0, cap - M), value=-1)
    deg[rows] = cnt
    us, ps = reverse_edges(a_ids, sel, adj.shape[0])
    ut, base, ocand, of_edges, of_targets = append_overflow(
        adj, deg, us, ps, of_t, new_w)
    osel, ocnt = rng_prune(
        vecs, vn, base, ocand, torch.full((ut.shape[0],), cap,
                                          dtype=torch.int32, device=dev),
        keep_all_under_m=False, keep_pruned=False, out_width=cap,
        metric=metric, m_max=cap)
    write_rows(adj, deg, ut, osel, ocnt)
    return of_edges, of_targets
