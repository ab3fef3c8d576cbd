"""Fused insert apply (port of hnsw_slim_tpu/graph/revconn.py).

mutuallyConnectNewElement (hnswalg.h:549-687) for a batch of inserted nodes
at one level, in the JAX program's order:

1. forward prune of each node's candidates to M with the under-M early-out
   (kernel Kγ);
2. forward scatter of those rows and their degrees;
3. the reverse edges u -> p, stably sorted by target u, so that a target's
   new edges come in ascending inserter order (kernel Kι: the ids map of
   the radix sort Kκ);
4. fitting appends at column deg[u] + rank within the target's run, and the
   degree update (kernel Kζ);
5. the overflow edges sorted by target again and the first-of-run targets
   sorted alone (Kι twice more), then the first ``of_t`` overflow targets
   in ascending id order re-pruned over
   {row ∪ their first ``new_w`` new edges} down to the cap: Kζ assembles the
   candidate rows, Kγ prunes them, Kζ writes them back.

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


def rev_append(adj, deg, us, ps):
    """Kζ append (csrc/rev_connect.cu, two launches: appends, then degrees).
    CPU tensors run ``rev_append_plain``. Same arguments and result."""
    if not adj.is_cuda:
        return rev_append_plain(adj, deg, us, ps)
    n, cap = adj.shape
    e = us.shape[0]
    cuda.require(adj, torch.int32, "adj", (n, cap))
    cuda.require(deg, torch.int32, "deg", (n,))
    cuda.require(us, torch.int32, "us", (e,))
    cuda.require(ps, torch.int32, "ps", (e,))
    ovf = torch.empty((e,), dtype=torch.bool, device=adj.device)
    if e:
        cuda.launch("rev_connect", us.data_ptr(), ps.data_ptr(), e,
                    adj.data_ptr(), deg.data_ptr(), cap, ovf.data_ptr(),
                    entry="rev_append")
    return ovf


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


def overflow_rows(adj, of_u, of_p, ut, new_w: int):
    """Kζ row assembly, one warp per target (csrc/rev_connect.cu). CPU
    tensors run ``overflow_rows_plain``. Same arguments and results."""
    if not adj.is_cuda:
        return overflow_rows_plain(adj, of_u, of_p, ut, new_w)
    n, cap = adj.shape
    e, t = of_u.shape[0], ut.shape[0]
    cuda.require(adj, torch.int32, "adj", (n, cap))
    cuda.require(of_u, torch.int32, "of_u", (e,))
    cuda.require(of_p, torch.int32, "of_p", (e,))
    cuda.require(ut, torch.int32, "ut", (t,))
    base = torch.empty((t,), dtype=torch.int32, device=adj.device)
    cand = torch.empty((t, cap + new_w), dtype=torch.int32, device=adj.device)
    if t:
        cuda.launch("rev_connect", adj.data_ptr(), cap, of_u.data_ptr(),
                    of_p.data_ptr(), e, ut.data_ptr(), t, new_w,
                    base.data_ptr(), cand.data_ptr(),
                    entry="rev_overflow_rows")
    return base, cand


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


def overflow_targets(us, ps, ovf, of_t: int, n=None):
    """Overflow edges in target order and the first of_t overflow targets in
    ascending id order (padding 2^30; ``n`` as in ``reverse_edges``).
    Returns (of_u, of_p, ut, of_edges, of_targets) — the last two are device
    scalars."""
    of_edges = ovf.sum(dtype=torch.int32)
    of_u, of_p = kv_sort(torch.where(ovf, us, BIG), ps, n)
    valid = of_u < BIG
    first = valid.clone()
    first[1:] &= of_u[1:] != of_u[:-1]
    of_targets = first.sum(dtype=torch.int32)
    t = min(of_t, us.shape[0])
    ut = kv_sort(torch.where(first, of_u, BIG), None, n)[0][:t].contiguous()
    return of_u, of_p, ut, of_edges, of_targets


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
    ovf = rev_append(adj, deg, us, ps)
    of_u, of_p, ut, of_edges, of_targets = overflow_targets(us, ps, ovf, of_t,
                                                            adj.shape[0])
    base, ocand = overflow_rows(adj, of_u, of_p, ut, new_w)
    osel, ocnt = rng_prune(
        vecs, vn, base, ocand, torch.full((ut.shape[0],), cap,
                                          dtype=torch.int32, device=dev),
        keep_all_under_m=False, keep_pruned=False, out_width=cap,
        metric=metric, m_max=cap)
    write_rows(adj, deg, ut, osel, ocnt)
    return of_edges, of_targets
