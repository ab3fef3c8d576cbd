"""Graph search (port of hnsw_slim_tpu/graph/search.py): the Slim query
path, the vanilla HNSW query path and the pieces the insertion build uses.

Slim serving (``chal_search``) runs in the slice's configuration: threshold
level 0, exact seeding from the table of all level>=1 vectors (kernel Kα),
then the base-layer beam over dense level-0 rows (kernel Kβ,
``beam_search``). The vanilla path (``level_search``) descends the upper
levels greedily (kernel Kε, ``greedy_descent``) and runs the same Kβ beam at
level 0. The per-query semantics of Kβ are those of ``beam_level_scored``:

* a sorted buffer of P (distance, id, checked) entries; the first ``ef_eff``
  slots are the working window (P > ef_eff only for ef >= 256 that is not a
  bitonic width, where JAX rounds the buffer up and keeps the window at ef);
* stop when the best unchecked entry in the window is farther than the
  window's last distance, or after ``max_iters`` iterations;
* pop the E (pop_width) best unchecked entries within that bound, fetch their
  rows, drop invalid ids, ids already in the buffer and in-batch duplicates,
  and keep ``cw`` candidate lanes (the ``2·cw`` pre-window rule when
  ``2·cw < E·W``); no visited table;
* score with ‖x‖² recomputed from the gathered row; merge keeping the P
  smallest (buffer entries first on equal distance, candidates by id).

Kβ takes a whole sorted, -1/inf-padded buffer as its seeds (S = P), so the
build's per-level beam over a carried buffer is the same kernel. Its checked
bits live inside one Kβ call: every call starts with all entries unchecked,
which is what the JAX build does between levels. A row that should not beam
enters with an empty buffer (id -1), leaves at once, and gets its carried
buffer back.

Straggler compaction (``beam_staged_scored``) exists in the JAX package only
for lockstep batching and leaves per-query results unchanged, so the port
has none: the kernels run each query on its own.
"""

from __future__ import annotations

import torch

from ..index.bruteforce import topk_dist
from ..ops import cuda
from ..ops.distance import gathered_dist, sq_norms

INF = float("inf")
BIG = 2**30


def bitonic_buffer_width(ef: int) -> int:
    """Physical buffer width the JAX engine uses for ef: the next power of
    two or 3*2^k (its bitonic merge widths)."""
    w = 1 << max(ef - 1, 1).bit_length()
    if w >= 4 and 3 * (w // 4) >= ef:
        return 3 * (w // 4)
    return w


def _is_bitonic_width(P: int) -> bool:
    if P & (P - 1) == 0:
        return True
    m = P // 3
    return 3 * m == P and m & (m - 1) == 0


def cand_width(P: int, pop_width: int, W: int, scan_width: int) -> int:
    """Surviving candidate lanes per iteration (JAX ``cw``)."""
    ew = pop_width * W
    return min(ew, scan_width or max(2 * P, 128)) if pop_width > 1 else ew


def beam_search_plain(vectors, q, qn, rows, seed_d, seed_id, *, P: int,
                      ef_eff: int, pop_width: int, cw: int, max_iters: int,
                      k: int, metric: str = "l2"):
    """Plain PyTorch Kβ: the JAX lockstep batched beam, step for step.
    Returns (d f32[B, k], ids i32[B, k], hops i32[B], dcomp i32[B])."""
    b, S = seed_d.shape
    dev = q.device
    E, W = pop_width, rows.shape[1]
    ew = E * W
    buf_d = torch.full((b, P), INF, device=dev)
    buf_id = torch.full((b, P), -1, dtype=torch.int32, device=dev)
    buf_d[:, :S] = seed_d
    buf_id[:, :S] = seed_id
    buf_chk = torch.zeros((b, P), dtype=torch.int32, device=dev)
    pos = torch.arange(P, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    hops = torch.zeros(b, dtype=torch.int32, device=dev)
    dcomp = torch.zeros(b, dtype=torch.int32, device=dev)
    for _ in range(max_iters):
        if bool(done.all()):
            break
        unchk = (buf_chk == 0) & (buf_id >= 0) & (pos < ef_eff)
        bound = buf_d[:, ef_eff - 1]
        rank = torch.cumsum(unchk.int(), dim=1) - 1
        first = unchk & (rank == 0)
        sel_d = torch.where(first, buf_d, -INF).max(dim=1).values
        done = done | ~first.any(dim=1) | (sel_d > bound)
        selmask = unchk & (rank < E) & (buf_d <= bound[:, None]) & ~done[:, None]
        buf_chk = torch.where(selmask, 1, buf_chk)
        popkey = torch.where(selmask, rank, BIG)
        sk, order = torch.sort(popkey, dim=1, stable=True)
        sv = torch.gather(buf_id, 1, order)
        pops = torch.where(sk[:, :E] < BIG, sv[:, :E], -1)
        ids = torch.where(pops[:, :, None] >= 0, rows[pops.clamp(min=0)],
                          -1).reshape(b, ew)
        valid = (ids >= 0) & ~done[:, None]
        if E > 1 and 2 * cw < ew:
            cs0 = torch.sort(torch.where(valid, ids, BIG), dim=1).values
            dup0 = torch.cat([torch.zeros((b, 1), dtype=torch.bool, device=dev),
                              cs0[:, 1:] == cs0[:, :-1]], dim=1)
            pre = torch.where(dup0, BIG, cs0)[:, : 2 * cw]
            dupb = (pre[:, :, None] == buf_id[:, None, :]).any(dim=2)
            pre = torch.where(dupb, BIG, pre)
            cand_sorted = torch.sort(pre, dim=1).values[:, :cw]
        else:
            dup = (ids[:, :, None] == buf_id[:, None, :]).any(dim=2)
            cand_sorted = torch.sort(torch.where(valid & ~dup, ids, BIG),
                                     dim=1).values
            if E > 1:
                dup2 = torch.cat(
                    [torch.zeros((b, 1), dtype=torch.bool, device=dev),
                     cand_sorted[:, 1:] == cand_sorted[:, :-1]], dim=1)
                cand_sorted = torch.where(dup2, BIG, cand_sorted)
            cand_sorted = cand_sorted[:, :cw]
        cand = cand_sorted < BIG
        safe = torch.where(cand, cand_sorted, 0)
        d = torch.where(cand, gathered_dist(q, vectors[safe], metric, qn=qn),
                        INF)
        hops += selmask.sum(dim=1, dtype=torch.int32)
        dcomp += cand.sum(dim=1, dtype=torch.int32)
        cat_d = torch.cat([buf_d, d], dim=1)
        cat_i = torch.cat([buf_id, torch.where(cand, cand_sorted, -1)], dim=1)
        cat_c = torch.cat([buf_chk, torch.zeros_like(cand_sorted)], dim=1)
        sd, order = torch.sort(cat_d, dim=1, stable=True)
        buf_d = sd[:, :P]
        buf_id = torch.gather(cat_i, 1, order[:, :P])
        buf_chk = torch.gather(cat_c, 1, order[:, :P])
    return buf_d[:, :k], buf_id[:, :k], hops, dcomp


def beam_search(vectors, q, qn, rows, seed_d, seed_id, *, P: int,
                ef_eff: int, pop_width: int, cw: int, max_iters: int, k: int,
                metric: str = "l2"):
    """Kβ: base-layer beam, one CUDA block per query (csrc/beam_search.cu).
    CPU tensors run ``beam_search_plain``. Same arguments and results."""
    if not q.is_cuda:
        return beam_search_plain(
            vectors, q, qn, rows, seed_d, seed_id, P=P, ef_eff=ef_eff,
            pop_width=pop_width, cw=cw, max_iters=max_iters, k=k,
            metric=metric)
    b, d = q.shape
    S = seed_d.shape[1]
    W = rows.shape[1]
    if not (1 <= k <= P <= 512 and 1 <= ef_eff <= P and S <= P):
        raise ValueError(f"beam_search: need k <= P <= 512, ef_eff <= P, "
                         f"seeds <= P (k={k}, P={P}, ef_eff={ef_eff}, S={S})")
    if not (1 <= pop_width <= 64 and pop_width * W <= 4096 and cw >= 1):
        raise ValueError(f"beam_search: pop_width={pop_width}, W={W}, cw={cw}")
    cuda.require(vectors, torch.float32, "vectors", (-1, d))
    cuda.require(q, torch.float32, "q", (b, d))
    cuda.require(qn, torch.float32, "qn", (b,))
    cuda.require(rows, torch.int32, "rows", (-1, W))
    cuda.require(seed_d, torch.float32, "seed_d", (b, S))
    cuda.require(seed_id, torch.int32, "seed_id", (b, S))
    out_d = torch.empty((b, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=q.device)
    hops = torch.empty((b,), dtype=torch.int32, device=q.device)
    dcomp = torch.empty((b,), dtype=torch.int32, device=q.device)
    if b:
        cuda.launch(
            "beam_search", vectors.data_ptr(), d, rows.data_ptr(), W,
            q.data_ptr(), qn.data_ptr(), seed_d.data_ptr(),
            seed_id.data_ptr(), b, S, P, ef_eff, pop_width, cw, max_iters, k,
            int(metric == "ip"), out_d.data_ptr(), out_i.data_ptr(),
            hops.data_ptr(), dcomp.data_ptr(),
        )
    return out_d, out_i, hops, dcomp


def greedy_descent_plain(vectors, q, qn, rows, cur, curdist, active=None,
                         metric: str = "l2"):
    """Plain PyTorch Kε: JAX ``greedy_level`` step for step (the batch moves
    in lockstep while any query still improves). Returns (cur i32[B],
    curdist f32[B], hops i32[B] rows fetched, dcomp i32[B] distances)."""
    b = q.shape[0]
    dev = q.device
    cur = cur.to(torch.int32).clone()
    curdist = curdist.clone()
    changed = (torch.ones(b, dtype=torch.bool, device=dev) if active is None
               else active.clone())
    hops = torch.zeros(b, dtype=torch.int32, device=dev)
    dcomp = torch.zeros(b, dtype=torch.int32, device=dev)
    while bool(changed.any()):
        ids = rows[cur.long()]
        valid = (ids >= 0) & changed[:, None]
        safe = ids.clamp(min=0)
        d = torch.where(valid, gathered_dist(q, vectors[safe.long()], metric,
                                             qn=qn), INF)
        dmin = d.min(dim=1).values
        # smallest id among the lanes at the minimum distance
        best = torch.where(d == dmin[:, None], safe, BIG).min(dim=1).values
        better = dmin < curdist
        hops += changed.to(torch.int32)
        dcomp += valid.sum(dim=1, dtype=torch.int32)
        cur = torch.where(better, best, cur)
        curdist = torch.where(better, dmin, curdist)
        changed = changed & better
    return cur, curdist, hops, dcomp


def greedy_descent(vectors, q, qn, rows, cur, curdist, active=None,
                   metric: str = "l2"):
    """Kε: one level of greedy descent over dense rows i32[N, W], one warp
    per query (csrc/greedy_descent.cu). ``active`` bool[B] (None = all):
    inactive queries keep (cur, curdist). CPU tensors run
    ``greedy_descent_plain``. Same arguments and results."""
    if not q.is_cuda:
        return greedy_descent_plain(vectors, q, qn, rows, cur, curdist,
                                    active, metric)
    b, d = q.shape
    W = rows.shape[1]
    cuda.require(vectors, torch.float32, "vectors", (-1, d))
    cuda.require(q, torch.float32, "q", (b, d))
    cuda.require(qn, torch.float32, "qn", (b,))
    cuda.require(rows, torch.int32, "rows", (-1, W))
    if active is not None:
        cuda.require(active, torch.bool, "active", (b,))
    cur = cur.to(torch.int32).contiguous().clone()
    curdist = curdist.to(torch.float32).contiguous().clone()
    cuda.require(cur, torch.int32, "cur", (b,))
    cuda.require(curdist, torch.float32, "curdist", (b,))
    hops = torch.zeros((b,), dtype=torch.int32, device=q.device)
    dcomp = torch.zeros((b,), dtype=torch.int32, device=q.device)
    if b:
        cuda.launch(
            "greedy_descent", vectors.data_ptr(), d, rows.data_ptr(), W,
            q.data_ptr(), qn.data_ptr(),
            None if active is None else active.data_ptr(), b,
            int(metric == "ip"), cur.data_ptr(), curdist.data_ptr(),
            hops.data_ptr(), dcomp.data_ptr(),
        )
    return cur, curdist, hops, dcomp


def entry_dist(vectors, vn, q, qn, entry: int, metric: str = "l2"):
    """(cur i32[B], curdist f32[B]): every query at the entry point, with
    the distance in the JAX form (the entry's stored norm)."""
    b = q.shape[0]
    cur = torch.full((b,), entry, dtype=torch.int32, device=q.device)
    e = cur.long()
    curdist = gathered_dist(q, vectors[e][:, None, :], metric, qn=qn,
                            vn=vn[e][:, None])[:, 0]
    return cur, curdist


def beam_init(seed_id, seed_d, ef: int):
    """Buffer (d f32[B, ef], id i32[B, ef]) seeded with one entry per query,
    inf / -1 padded."""
    b = seed_id.shape[0]
    buf_d = torch.full((b, ef), INF, device=seed_d.device)
    buf_id = torch.full((b, ef), -1, dtype=torch.int32, device=seed_id.device)
    buf_d[:, 0] = seed_d
    buf_id[:, 0] = seed_id
    return buf_d, buf_id


def beam_reseed(buf_d, buf_id, seed_id, seed_d, active):
    """Replace the buffers of ``active`` queries with a fresh single seed
    (a build query moving from greedy descent to the beam)."""
    new_d, new_id = beam_init(seed_id, seed_d, buf_d.shape[1])
    return (torch.where(active[:, None], new_d, buf_d),
            torch.where(active[:, None], new_id, buf_id))


def beam_level(vectors, q, qn, rows, buf_d, buf_id, active, *,
               max_iters: int, metric: str = "l2"):
    """One level's beam (JAX ``beam_level`` with pop_width 1, exact scorer,
    no filter) from the carried sorted buffer (P = its width, ef_eff = P) on
    Kβ. Rows where ``active`` is false keep their buffer. Returns (buf_d,
    buf_id, hops, dcomp)."""
    P = buf_d.shape[1]
    seed_d = torch.where(active[:, None], buf_d, INF).contiguous()
    seed_id = torch.where(active[:, None], buf_id, -1).contiguous()
    d, ids, hops, dcomp = beam_search(
        vectors, q, qn, rows, seed_d, seed_id, P=P, ef_eff=P, pop_width=1,
        cw=cand_width(P, 1, rows.shape[1], 0), max_iters=max_iters, k=P,
        metric=metric)
    return (torch.where(active[:, None], d, buf_d),
            torch.where(active[:, None], ids, buf_id), hops, dcomp)


def level_search(adjs, entry: int, vectors, vn, q, *, max_level: int,
                 ef: int, k: int, max_iters: int, metric: str = "l2",
                 pop_width: int = 1):
    """Vanilla HNSW query path (hnswalg.h searchKnn): greedy descent
    max_level..1 (Kε), then the ef-beam at level 0 from that one seed (Kβ).
    Returns (dists f32[B, k], ids i32[B, k], hops i32[B], dcomp i32[B]);
    hops and dcomp count the level-0 beam, as in the JAX package."""
    qn = sq_norms(q)
    cur, curdist = entry_dist(vectors, vn, q, qn, entry, metric)
    for l in range(max_level, 0, -1):
        cur, curdist, _, _ = greedy_descent(vectors, q, qn, adjs[l], cur,
                                            curdist, None, metric)
    return beam_search(
        vectors, q, qn, adjs[0], curdist[:, None].contiguous(),
        cur[:, None].contiguous(), P=ef, ef_eff=ef, pop_width=pop_width,
        cw=cand_width(ef, pop_width, adjs[0].shape[1], 0),
        max_iters=max_iters, k=k, metric=metric)


def chal_search(vectors, q, dense0, *, max_level: int,
                threshold_level: int, ef: int, k: int, max_iters: int,
                metric: str = "l2", pop_width: int = 1, scan_width: int = 0,
                seed_width: int = 0, up_vecs=None, up_vn=None, up_ids=None,
                seed_strata: int = 0):
    """Slim query path in the slice's configuration (JAX ``chal_search``
    with threshold_level 0, the exact seed table and dense level-0 rows).
    Returns (dists f32[B, k], ids i32[B, k], hops i32[B], dcomp i32[B])."""
    if threshold_level > 0:
        raise NotImplementedError(
            "threshold_level > 0 (greedy/beam upper levels): ROADMAP K4/K5")
    if seed_strata > 1:
        raise NotImplementedError("stratified seeds: ROADMAP K3-strata")
    if dense0 is None:
        raise NotImplementedError(
            "CHAL/rank fetch at level 0: ROADMAP K4 (call densify_level0)")
    P, ef_eff = ef, ef
    if ef >= 256 and not _is_bitonic_width(ef):
        P = bitonic_buffer_width(ef)
    seed_width = min(seed_width, P)
    if max_level < 1 or seed_width <= 1 or up_vecs is None:
        raise NotImplementedError(
            "entry-point, greedy-descent (K5) or level-1-beam seeding of the "
            "Slim path: ROADMAP queue 1 item 5")
    qn = sq_norms(q)
    sd, spos = topk_dist(q, up_vecs, up_vn, seed_width, metric,
                         row_ids=up_ids)
    si = torch.where(spos >= 0, up_ids[spos.clamp(min=0).long()], -1)
    si = torch.where(torch.isinf(sd), -1, si).to(torch.int32)
    dcomp0 = int((up_ids >= 0).sum())
    d, ids, hops, dcomp = beam_search(
        vectors, q, qn, dense0, sd.contiguous(), si.contiguous(), P=P,
        ef_eff=ef_eff, pop_width=pop_width,
        cw=cand_width(P, pop_width, dense0.shape[1], scan_width),
        max_iters=max_iters, k=k, metric=metric,
    )
    return d, ids, hops, dcomp + dcomp0
