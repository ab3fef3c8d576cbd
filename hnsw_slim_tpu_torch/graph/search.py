"""Graph search (port of hnsw_slim_tpu/graph/search.py): the Slim query
path in full, the vanilla HNSW query path and the pieces the insertion build
uses.

``chal_search`` is the JAX function of that name: greedy descent (kernel Kε,
``greedy_descent_levels``, one launch) over levels
max_level..threshold_level+1, then beams
(kernel Kβ, ``beam_search``) over levels threshold_level..0 on one carried
buffer. With threshold level 0 and ``seed_width`` > 1 the descent is
replaced by seeds: the exact top-S of all level>=1 vectors (kernel Kα,
stratified per table segment when ``seed_strata`` > 1), or a level-1 beam
when there is no seed table. ``allowed`` filters in the kernel. The vanilla
path (``level_search``) descends every upper level greedily and beams at
level 0.

A level's neighbor rows reach the kernels through a ``Fetch``: dense rows,
rows behind a rank indirection (the dense upper layout), or slices of the
flat CHAL arrays. The three hold the same ids, and both kernels are blind to
lane order (Kβ sorts its candidates, Kε's argmin takes the smallest id among
equal minima), so results do not depend on the form.

The per-query semantics of Kβ are those of ``beam_level_scored``:

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
  smallest (buffer entries first on equal distance, candidates by id);
* filtered (``allowed``): a second sorted list of P, the result track, takes
  the scored candidates that are allowed and not yet in it; the bound above
  becomes the track's ``ef_eff``-th distance, and results come from the
  track. Disallowed nodes are traversed, never returned. In tag mode
  (``tags`` and ``need`` in place of ``allowed``) a node is allowed for a
  query iff (tags[id] & need[query]) == need[query]: one predicate a query,
  so one batch mixes predicates. Either way the beam also returns, a
  query, the scored candidates that passed (``admit``);
* ``iters`` (i32[B], optional): a per-query iteration cap in place of
  ``max_iters``.

Kβ takes a whole sorted, -1/inf-padded buffer as its seeds (S <= P), so a
beam over a carried buffer (the build's per-level beam, the levels below the
threshold level) is the same kernel. Its checked bits live inside one Kβ
call: every call starts with all entries unchecked, which is what JAX does
between levels. A row that should not beam enters with an empty buffer (id
-1), leaves at once, and gets its carried buffer back.

Beside the Fetch, both kernels take a scorer description and Kβ a pop track,
the port's forms of JAX's ``score`` closure and ``pop_hook``:

* ``scorer`` (quant/estimator.py ``QuantScorer``): candidates are scored by
  their RaBitQ estimate from one packed code row instead of the exact
  distance to a gathered vector (SlimQ); ``vectors``, ``q`` and ``qn`` are
  then unused (None). A launch whose code rows arrive in one gather round
  (``quant/estimator.py gather_rounds``) counts the trace counter
  ``index.quant_one_round``;
* ``pop_track`` (``PopTrack``, quantized beams only): every iteration's
  popped ids get their exact distance to an external dataset and enter a
  sorted list of kk (distance, id) — pops already in it dropped, then a
  stable merge by distance alone (track entries first on equal distance,
  pops in pop order). The track comes in and goes out whole, so a caller
  carries it across levels. Its distances are not counted in ``dcomp``.

Not ported: straggler compaction (``beam_staged_scored``, ``stages``) exists
in the JAX package only for lockstep batching and leaves per-query results
unchanged, and the kernels run each query on its own; ``dynamic_ef`` /
``ef_max`` (one compiled program for every ef) has no counterpart without a
compiler.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..index.bruteforce import topk_dist, topk_dist_strata
from ..ops import cuda
from ..ops.distance import gathered_dist, gathered_dist_plain, sq_norms
from ..quant.estimator import QuantScorer, packed_estimate_plain
from ..utils import trace

INF = float("inf")
BIG = 2**30


class Fetch(NamedTuple):
    """How to read node v's neighbor row at one level (ids, -1 = no
    neighbor), the port's form of JAX's fetch closures:

    * ``dense``: ``rows`` i32[N, width] (make_dense_fetch);
    * ``rank``: ``aux`` = rank i32[N] maps v to its row of ``rows``
      i32[R, width], -1 = no row at this level (make_rank_fetch);
    * ``chal``: ``rows`` = nbr i32[E], ``aux`` = lvl_off i32[N, L+2]; the row
      is nbr[lvl_off[v, level] : lvl_off[v, level+1]] cut at ``width``
      (make_chal_fetch).
    """

    mode: str
    rows: torch.Tensor
    aux: torch.Tensor | None
    width: int
    level: int = 0


class PopTrack(NamedTuple):
    """The rerank track of a quantized beam: ``dataset`` f32[N, D] raw
    vectors, ``q_raw`` f32[B, D], ``qn_raw`` f32[B] squared norms (None for
    the IP metric), and the track so far (``d`` f32[B, kk] ascending, ``ids``
    i32[B, kk], inf / -1 padded)."""

    dataset: torch.Tensor
    q_raw: torch.Tensor
    qn_raw: torch.Tensor | None
    d: torch.Tensor
    ids: torch.Tensor


def pop_track_init(dataset, q_raw, kk: int, metric: str = "l2") -> PopTrack:
    """An empty track of kk entries for raw queries ``q_raw``."""
    b = q_raw.shape[0]
    return PopTrack(
        dataset, q_raw, sq_norms(q_raw) if metric == "l2" else None,
        torch.full((b, kk), INF, device=q_raw.device),
        torch.full((b, kk), -1, dtype=torch.int32, device=q_raw.device))


def pop_track_merge_plain(t: PopTrack, pops, metric: str) -> PopTrack:
    """Plain PyTorch rerank step: popped ids i32[B, E] (-1 = no pop) into
    the track, as the JAX pop_hook does it."""
    ok = pops >= 0
    vecs = t.dataset[pops.clamp(min=0).long()]
    dot = torch.einsum("bd,bed->be", t.q_raw, vecs)
    if metric == "ip":
        ed = 1.0 - dot
    else:
        ed = t.qn_raw[:, None] + (vecs * vecs).sum(-1) - 2.0 * dot
    dup = (pops[:, :, None] == t.ids[:, None, :]).any(dim=2)
    keep = ok & ~dup
    cd = torch.cat([t.d, torch.where(keep, ed, INF)], dim=1)
    ci = torch.cat([t.ids, torch.where(keep, pops, -1)], dim=1)
    sd, order = torch.sort(cd, dim=1, stable=True)
    kk = t.d.shape[1]
    return t._replace(d=sd[:, :kk],
                      ids=torch.gather(ci, 1, order[:, :kk]).contiguous())


def dense_fetch(rows) -> Fetch:
    return Fetch("dense", rows, None, int(rows.shape[1]))


def rank_fetch(rank, dense_l) -> Fetch:
    return Fetch("rank", dense_l, rank, int(dense_l.shape[1]))


def chal_fetch(nbr, lvl_off, l: int, width: int) -> Fetch:
    return Fetch("chal", nbr, lvl_off, int(width), int(l))


def as_fetch(rows) -> Fetch:
    """A Fetch as it is; a dense row tensor i32[N, W] as a dense Fetch."""
    return rows if isinstance(rows, Fetch) else dense_fetch(rows)


def fetch_rows_plain(fetch: Fetch, v) -> torch.Tensor:
    """Plain PyTorch fetch: the rows of nodes ``v`` (any int dtype, [B]) as
    i32[B, width], -1 padded, lane for lane as the JAX closures give them."""
    v = v.long()
    if fetch.mode == "dense":
        return fetch.rows[v]
    if fetch.mode == "rank":
        r = fetch.aux[v].long()
        return torch.where(r[:, None] >= 0, fetch.rows[r.clamp(min=0)], -1)
    start = fetch.aux[v, fetch.level].long()
    end = fetch.aux[v, fetch.level + 1].long()
    idx = start[:, None] + torch.arange(fetch.width, device=v.device)
    ids = fetch.rows[idx.clamp(0, fetch.rows.shape[0] - 1)]
    return torch.where(idx < end[:, None], ids, -1)


def _fetch_args(fetch: Fetch) -> tuple:
    """The six kernel arguments of a Fetch (rows, aux, mode, W, level,
    stride), validated."""
    if fetch.mode == "dense":
        cuda.require(fetch.rows, torch.int32, "rows", (-1, fetch.width))
        return fetch.rows.data_ptr(), None, 0, fetch.width, 0, 0
    if fetch.mode == "rank":
        cuda.require(fetch.rows, torch.int32, "dense rows", (-1, fetch.width))
        cuda.require(fetch.aux, torch.int32, "rank", (-1,))
        return (fetch.rows.data_ptr(), fetch.aux.data_ptr(), 1, fetch.width,
                0, 0)
    if fetch.mode != "chal":
        raise ValueError(f"unknown fetch mode {fetch.mode!r}")
    cuda.require(fetch.rows, torch.int32, "nbr", (-1,))
    cuda.require(fetch.aux, torch.int32, "lvl_off", (-1, -1))
    stride = int(fetch.aux.shape[1])
    if not 0 <= fetch.level < stride - 1:
        raise ValueError(f"level {fetch.level} outside lvl_off's {stride} "
                         "columns")
    return (fetch.rows.data_ptr(), fetch.aux.data_ptr(), 2, fetch.width,
            fetch.level, stride)


def admits(ids, allowed=None, tags=None, need=None):
    """bool of ``ids``' shape [B, ...]: whether each node id (>= 0) passes
    its query row's filter: ``allowed[id]`` (bool[N]), or in tag mode
    (tags[id] & need[row]) == need[row] (``tags`` i32[N], ``need`` i32[B]:
    u32 words held as int32)."""
    if allowed is not None:
        return allowed[ids.long()]
    nd = need.reshape(-1, *([1] * (ids.dim() - 1)))
    return (tags[ids.long()] & nd) == nd


def bitonic_buffer_width(ef: int) -> int:
    """Physical buffer width the JAX engine uses for ef: the next power of
    two or 3*2^k (its bitonic merge widths)."""
    w = 1 << max(ef - 1, 1).bit_length()
    if w >= 4 and 3 * (w // 4) >= ef:
        return 3 * (w // 4)
    return w


def cand_width(P: int, pop_width: int, W: int, scan_width: int) -> int:
    """Surviving candidate lanes per iteration (JAX ``cw``)."""
    ew = pop_width * W
    return min(ew, scan_width or max(2 * P, 128)) if pop_width > 1 else ew


def beam_search_plain(vectors, q, qn, rows, seed_d, seed_id, *, P: int,
                      ef_eff: int, pop_width: int, cw: int, max_iters: int,
                      k: int, metric: str = "l2", allowed=None, track_d=None,
                      track_id=None, scorer: QuantScorer | None = None,
                      pop_track: PopTrack | None = None,
                      seen: list | None = None, iters=None, tags=None,
                      need=None):
    """Plain PyTorch Kβ: the JAX lockstep batched beam, step for step.
    ``rows`` is a Fetch or dense rows. Returns (d f32[B, k], ids i32[B, k],
    hops i32[B], dcomp i32[B]); filtered (``allowed`` bool[N], or ``tags``
    and ``need``: see ``admits``), with the incoming track (f32/i32[B, P]),
    three more: the track after the beam and admit i32[B]; with
    ``pop_track`` one more: the PopTrack after the beam. ``iters`` i32[B]:
    each query's own iteration cap. A ``seen`` list gets, each step, the ids
    whose rows were fetched and the ids scored (what a bound on the call's
    traffic counts)."""
    fetch = as_fetch(rows)
    b, S = seed_d.shape
    dev = seed_d.device
    filtered = allowed is not None or tags is not None
    if iters is not None:
        max_iters = int(iters.max()) if b else 0
    E, W = pop_width, fetch.width
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
    admit = torch.zeros(b, dtype=torch.int32, device=dev)
    for it in range(max_iters):
        if iters is not None:
            done = done | (iters <= it)
        if bool(done.all()):
            break
        unchk = (buf_chk == 0) & (buf_id >= 0) & (pos < ef_eff)
        # allowed-only bound: search on until ef_eff allowed results exist
        bound = (track_d if filtered else buf_d)[:, ef_eff - 1]
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
        if pop_track is not None:
            pop_track = pop_track_merge_plain(pop_track, pops, metric)
        fetched = fetch_rows_plain(fetch, pops.clamp(min=0).reshape(b * E))
        ids = torch.where(pops[:, :, None] >= 0, fetched.reshape(b, E, W),
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
        if seen is not None:
            seen.append((pops[pops >= 0], cand_sorted[cand]))
        safe = torch.where(cand, cand_sorted, 0)
        if scorer is not None:
            d = packed_estimate_plain(scorer, safe)
        else:
            d = gathered_dist_plain(q, vectors[safe], metric, qn=qn)
        d = torch.where(cand, d, INF)
        hops += selmask.sum(dim=1, dtype=torch.int32)
        dcomp += cand.sum(dim=1, dtype=torch.int32)
        if filtered:
            # allowed candidates not yet in the track merge into it, track
            # entries first on equal distance (a stable sort)
            fdup = (cand_sorted[:, :, None] == track_id[:, None, :]).any(dim=2)
            ok = cand & admits(safe, allowed, tags, need)
            admit += ok.sum(dim=1, dtype=torch.int32)
            take = ok & ~fdup
            fc_d = torch.cat([track_d, torch.where(take, d, INF)], dim=1)
            fc_i = torch.cat([track_id, torch.where(take, cand_sorted, -1)],
                             dim=1)
            rd, order = torch.sort(fc_d, dim=1, stable=True)
            track_d = rd[:, :P]
            track_id = torch.gather(fc_i, 1, order[:, :P])
        cat_d = torch.cat([buf_d, d], dim=1)
        cat_i = torch.cat([buf_id, torch.where(cand, cand_sorted, -1)], dim=1)
        cat_c = torch.cat([buf_chk, torch.zeros_like(cand_sorted)], dim=1)
        sd, order = torch.sort(cat_d, dim=1, stable=True)
        buf_d = sd[:, :P]
        buf_id = torch.gather(cat_i, 1, order[:, :P])
        buf_chk = torch.gather(cat_c, 1, order[:, :P])
    out = (buf_d[:, :k], buf_id[:, :k], hops, dcomp)
    if filtered:
        out += (track_d, track_id, admit)
    if pop_track is not None:
        out += (pop_track,)
    return out


def beam_search(vectors, q, qn, rows, seed_d, seed_id, *, P: int,
                ef_eff: int, pop_width: int, cw: int, max_iters: int, k: int,
                metric: str = "l2", allowed=None, track_d=None,
                track_id=None, scorer: QuantScorer | None = None,
                pop_track: PopTrack | None = None, iters=None, tags=None,
                need=None):
    """Kβ: one level's beam, one CUDA block per query (csrc/beam_search.cu),
    over a Fetch (or dense rows), filtered when ``allowed`` (or ``tags`` and
    ``need``) is given, on RaBitQ estimates when ``scorer`` is given, with
    the rerank track when ``pop_track`` is, each query capped at its own
    ``iters`` where given. CPU tensors run ``beam_search_plain``. Same
    arguments and results."""
    if not seed_d.is_cuda:
        return beam_search_plain(
            vectors, q, qn, rows, seed_d, seed_id, P=P, ef_eff=ef_eff,
            pop_width=pop_width, cw=cw, max_iters=max_iters, k=k,
            metric=metric, allowed=allowed, track_d=track_d,
            track_id=track_id, scorer=scorer, pop_track=pop_track,
            iters=iters, tags=tags, need=need)
    fetch = as_fetch(rows)
    b, S = seed_d.shape
    W = fetch.width
    filtered = allowed is not None or tags is not None
    if scorer is not None:
        if filtered or iters is not None:
            raise NotImplementedError(
                "beam_search: no filtered or per-query capped quantized beam")
        return _beam_search_quant(fetch, scorer, pop_track, seed_d, seed_id,
                                  P, ef_eff, pop_width, cw, max_iters, k,
                                  metric)
    if pop_track is not None:
        raise ValueError("beam_search: a pop track needs a quantized scorer")
    d = q.shape[1]
    _check_beam_shape(k, P, ef_eff, S, pop_width, W, cw)
    cuda.require(vectors, cuda.ROW_TYPES, "vectors", (-1, d))
    cuda.require(q, torch.float32, "q", (b, d))
    cuda.require(qn, torch.float32, "qn", (b,))
    fargs = _fetch_args(fetch)
    cuda.require(seed_d, torch.float32, "seed_d", (b, S))
    cuda.require(seed_id, torch.int32, "seed_id", (b, S))
    dev = q.device
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    hops = torch.empty((b,), dtype=torch.int32, device=dev)
    dcomp = torch.empty((b,), dtype=torch.int32, device=dev)
    entry, modes = cuda.row_type(
        vectors, "beam_search",
        () if fetch.mode == "dense" else (fetch.mode,))
    filt = (None,) * 5
    tag = (None, None)
    admit = None
    if iters is not None:
        cuda.require(iters, torch.int32, "iters", (b,))
    if filtered:
        if tags is not None:
            cuda.require(tags, torch.int32, "tags", (vectors.shape[0],))
            cuda.require(need, torch.int32, "need", (b,))
            tag = (tags.data_ptr(), need.data_ptr())
        else:
            cuda.require(allowed, torch.bool, "allowed", (vectors.shape[0],))
        cuda.require(track_d, torch.float32, "track_d", (b, P))
        cuda.require(track_id, torch.int32, "track_id", (b, P))
        trk_d = torch.empty((b, P), dtype=torch.float32, device=dev)
        trk_i = torch.empty((b, P), dtype=torch.int32, device=dev)
        admit = torch.empty((b,), dtype=torch.int32, device=dev)
        filt = (None if allowed is None else allowed.data_ptr(),
                track_d.data_ptr(), track_id.data_ptr(), trk_d.data_ptr(),
                trk_i.data_ptr())
        modes += ("filtered",) if tags is None else ("tags",)
    if b:
        cuda.launch(
            "beam_search", vectors.data_ptr(), d, *fargs, q.data_ptr(),
            qn.data_ptr(), seed_d.data_ptr(), seed_id.data_ptr(), b, S, P,
            ef_eff, pop_width, cw, max_iters, k, int(metric == "ip"),
            *filt[:3], out_d.data_ptr(), out_i.data_ptr(), hops.data_ptr(),
            dcomp.data_ptr(), *filt[3:], *tag,
            None if iters is None else iters.data_ptr(),
            None if admit is None else admit.data_ptr(), entry=entry,
            modes=modes, shape=f"E{pop_width} ef{ef_eff} S{S}",
        )
    if filtered:
        return out_d, out_i, hops, dcomp, trk_d, trk_i, admit
    return out_d, out_i, hops, dcomp


def _check_beam_shape(k, P, ef_eff, S, pop_width, W, cw):
    if not (1 <= k <= P <= 512 and 1 <= ef_eff <= P and S <= P):
        raise ValueError(f"beam_search: need k <= P <= 512, ef_eff <= P, "
                         f"seeds <= P (k={k}, P={P}, ef_eff={ef_eff}, S={S})")
    if not (1 <= pop_width <= 64 and pop_width * W <= 4096 and cw >= 1):
        raise ValueError(f"beam_search: pop_width={pop_width}, W={W}, cw={cw}")


def _beam_search_quant(fetch, scorer, pop_track, seed_d, seed_id, P, ef_eff,
                       pop_width, cw, max_iters, k, metric):
    """Kβ's quantized mode on CUDA tensors (see beam_search)."""
    b, S = seed_d.shape
    _check_beam_shape(k, P, ef_eff, S, pop_width, fetch.width, cw)
    sargs = scorer.args()
    if scorer.q_rot.shape[0] != b:
        raise ValueError("beam_search: scorer and seeds disagree on the batch")
    fargs = _fetch_args(fetch)
    cuda.require(seed_d, torch.float32, "seed_d", (b, S))
    cuda.require(seed_id, torch.int32, "seed_id", (b, S))
    dev = seed_d.device
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    hops = torch.empty((b,), dtype=torch.int32, device=dev)
    dcomp = torch.empty((b,), dtype=torch.int32, device=dev)
    modes = () if fetch.mode == "dense" else (fetch.mode,)
    modes += ("quant_ex" if scorer.use_ex else "quant",)
    targs = (None, 0, None, None, 0, None, None)
    touts = (None, None)
    new_track = None
    if pop_track is not None:
        t = pop_track
        dr = t.q_raw.shape[1]
        kk = t.d.shape[1]
        cuda.require(t.dataset, torch.float32, "dataset", (-1, dr))
        cuda.require(t.q_raw, torch.float32, "q_raw", (b, dr))
        if metric == "l2":
            cuda.require(t.qn_raw, torch.float32, "qn_raw", (b,))
        cuda.require(t.d, torch.float32, "track d", (b, kk))
        cuda.require(t.ids, torch.int32, "track ids", (b, kk))
        new_track = t._replace(d=torch.empty_like(t.d),
                               ids=torch.empty_like(t.ids))
        targs = (t.dataset.data_ptr(), dr, t.q_raw.data_ptr(),
                 t.qn_raw.data_ptr() if metric == "l2" else None, kk,
                 t.d.data_ptr(), t.ids.data_ptr())
        touts = (new_track.d.data_ptr(), new_track.ids.data_ptr())
        modes += ("rerank",)
    if b:
        cuda.launch(
            "beam_search", *sargs, *fargs, seed_d.data_ptr(),
            seed_id.data_ptr(), b, S, P, ef_eff, pop_width, cw, max_iters, k,
            int(metric == "ip"), *targs, out_d.data_ptr(), out_i.data_ptr(),
            hops.data_ptr(), dcomp.data_ptr(), *touts,
            entry="beam_search_quant", modes=modes,
            shape=f"E{pop_width} ef{ef_eff} S{S}",
            counters=scorer.counters())
    out = (out_d, out_i, hops, dcomp)
    return out if pop_track is None else out + (new_track,)


def greedy_descent_plain(vectors, q, qn, rows, cur, curdist, active=None,
                         metric: str = "l2",
                         scorer: QuantScorer | None = None,
                         seen: list | None = None):
    """Plain PyTorch Kε: JAX ``greedy_level`` step for step (the batch moves
    in lockstep while any query still improves), over a Fetch or dense rows,
    on RaBitQ estimates when ``scorer`` is given (``vectors``, ``q``, ``qn``
    unused; ``curdist`` None: each query starts from the estimate of its
    ``cur``). Returns (cur i32[B], curdist f32[B], hops i32[B] rows fetched,
    dcomp i32[B] distances). A ``seen`` list gets, each step, the ids whose
    rows were fetched and the ids scored (as beam_search_plain's)."""
    fetch = as_fetch(rows)
    b = cur.shape[0]
    dev = cur.device
    cur = cur.to(torch.int32).clone()
    if curdist is None:
        curdist = packed_estimate_plain(scorer, cur[:, None])[:, 0]
        if seen is not None:
            seen.append((cur[:0], cur))
    curdist = curdist.clone()
    changed = (torch.ones(b, dtype=torch.bool, device=dev) if active is None
               else active.clone())
    hops = torch.zeros(b, dtype=torch.int32, device=dev)
    dcomp = torch.zeros(b, dtype=torch.int32, device=dev)
    while bool(changed.any()):
        ids = fetch_rows_plain(fetch, cur)
        valid = (ids >= 0) & changed[:, None]
        if seen is not None:
            seen.append((cur[changed], ids[valid]))
        safe = ids.clamp(min=0)
        if scorer is not None:
            d = packed_estimate_plain(scorer, safe)
        else:
            d = gathered_dist_plain(q, vectors[safe.long()], metric, qn=qn)
        d = torch.where(valid, d, INF)
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
                   metric: str = "l2", scorer: QuantScorer | None = None):
    """Kε: one level of greedy descent over a Fetch (or dense rows
    i32[N, W]), one warp per query (csrc/greedy_descent.cu: the launch of
    greedy_descent_levels with one level), on RaBitQ estimates when
    ``scorer`` is given. ``active`` bool[B] (None = all): inactive queries
    keep (cur, curdist). With a scorer, ``curdist`` None lets the kernel
    score each query's ``cur`` itself before it descends (the SlimQ search's
    entry point; with no query active that is all the launch does). CPU
    tensors run ``greedy_descent_plain``. Same arguments and results."""
    if not cur.is_cuda:
        return greedy_descent_plain(vectors, q, qn, rows, cur, curdist,
                                    active, metric, scorer)
    stop = None
    if active is not None:
        cuda.require(active, torch.bool, "active", (cur.shape[0],))
        stop = torch.where(active, 0, 1).to(torch.int32)
    return _descend(vectors, q, qn, [as_fetch(rows)], 1, cur, curdist, stop,
                    metric, scorer, "level")


MAX_LEVELS = 32  # levels of one fused Kε launch (csrc/greedy_descent.cu)


def greedy_descent_levels_plain(vectors, q, qn, fetches, top: int, cur,
                                curdist, stop=None, metric: str = "l2",
                                scorer: QuantScorer | None = None):
    """Plain twin of ``greedy_descent_levels``: greedy_descent_plain level
    by level, ``fetches[i]`` being level top - i, query b active at level l
    only if l > stop[b] (stop None: every level). Returns (cur, curdist,
    hops, dcomp) with hops and dcomp summed over the levels."""
    cur = cur.to(torch.int32)
    if curdist is None:
        curdist = packed_estimate_plain(scorer, cur[:, None])[:, 0]
    hops = torch.zeros(cur.shape[0], dtype=torch.int32, device=cur.device)
    dcomp = torch.zeros_like(hops)
    for i, rows in enumerate(fetches):
        act = None if stop is None else stop < top - i
        cur, curdist, h, dc = greedy_descent_plain(vectors, q, qn, rows, cur,
                                                   curdist, act, metric,
                                                   scorer)
        hops, dcomp = hops + h, dcomp + dc
    return cur, curdist, hops, dcomp


def greedy_descent_levels(vectors, q, qn, fetches, top: int, cur, curdist,
                          stop=None, metric: str = "l2",
                          scorer: QuantScorer | None = None):
    """Kε over a run of levels in one launch (csrc/greedy_descent.cu):
    ``fetches[i]`` (a Fetch or dense rows, at most MAX_LEVELS of them) is
    level top - i, and query b walks level l only if l > stop[b] (``stop``
    i32[B], None: every level; at or above ``top``: none), on its own,
    without waiting for the batch at a level boundary. Same results as greedy_descent level by level (see
    greedy_descent_levels_plain, which CPU tensors run); with a scorer,
    ``curdist`` None lets the kernel score each query's ``cur`` first (with
    no level, that is all the launch does)."""
    if not cur.is_cuda:
        return greedy_descent_levels_plain(vectors, q, qn, fetches, top, cur,
                                           curdist, stop, metric, scorer)
    fetches = [as_fetch(f) for f in fetches]
    if not fetches and curdist is not None:
        zeros = torch.zeros(cur.shape, dtype=torch.int32, device=cur.device)
        return cur.to(torch.int32), curdist, zeros, zeros.clone()
    if len(fetches) > MAX_LEVELS:
        raise ValueError(f"greedy_descent_levels: {len(fetches)} levels, "
                         f"one launch takes at most {MAX_LEVELS}")
    return _descend(vectors, q, qn, fetches, top, cur, curdist, stop, metric,
                    scorer, f"levels {len(fetches)}")


def _descend(vectors, q, qn, fetches, top, cur, curdist, stop, metric,
             scorer, shape):
    """The Kε launch of greedy_descent_levels on CUDA tensors; ``shape``
    is its launch class."""
    b = cur.shape[0]
    dev = cur.device
    zeros = torch.zeros((b,), dtype=torch.int32, device=dev)
    if scorer is None:
        d = q.shape[1]
        cuda.require(vectors, cuda.ROW_TYPES, "vectors", (-1, d))
        cuda.require(q, torch.float32, "q", (b, d))
        cuda.require(qn, torch.float32, "qn", (b,))
    elif scorer.q_rot.shape[0] != b:
        raise ValueError("greedy_descent: scorer and cur disagree on the "
                         "batch")
    score_cur = curdist is None
    if score_cur:
        if scorer is None:
            raise ValueError("greedy_descent: curdist=None needs a scorer")
        curdist = torch.empty((b,), dtype=torch.float32, device=dev)
    fargs = [_fetch_args(f) for f in fetches]
    ptrs = np.array([[a[0], a[1] or 0] for a in fargs], np.int64)
    params = np.array([a[2:] for a in fargs], np.int32)
    if stop is not None:
        cuda.require(stop, torch.int32, "stop", (b,))
    cur = cur.to(torch.int32).contiguous().clone()
    curdist = curdist.to(torch.float32).contiguous().clone()
    cuda.require(cur, torch.int32, "cur", (b,))
    cuda.require(curdist, torch.float32, "curdist", (b,))
    hops, dcomp = zeros, zeros.clone()
    modes = tuple(sorted({f.mode for f in fetches} - {"dense"}))
    lvl = (len(fetches), int(top), ptrs.ctypes.data, params.ctypes.data)
    stop_p = None if stop is None else stop.data_ptr()
    if b and scorer is not None:
        cuda.launch(
            "greedy_descent", *scorer.args(), *lvl, stop_p, b, int(score_cur),
            cur.data_ptr(), curdist.data_ptr(), hops.data_ptr(),
            dcomp.data_ptr(), entry="greedy_levels_quant",
            modes=modes + ("quant",), shape=shape,
            counters=scorer.counters())
    elif b:
        entry, modes = cuda.row_type(vectors, "greedy_levels", modes)
        cuda.launch(
            "greedy_descent", vectors.data_ptr(), d, *lvl, q.data_ptr(),
            qn.data_ptr(), stop_p, b, int(metric == "ip"), cur.data_ptr(),
            curdist.data_ptr(), hops.data_ptr(), dcomp.data_ptr(),
            entry=entry, modes=modes, shape=shape)
    return cur, curdist, hops, dcomp


def entry_dist(vectors, vn, q, qn, entry, metric: str = "l2"):
    """(cur i32[B], curdist f32[B]): every query at its entry point (one int
    for all, or per-query ids [B]), with the distance in the JAX form (the
    entry's stored norm); K1 reads the entry rows by id from the store."""
    b = q.shape[0]
    if isinstance(entry, int):
        cur = torch.full((b,), entry, dtype=torch.int32, device=q.device)
    else:
        cur = torch.as_tensor(entry, device=q.device).to(torch.int32)
        cur = cur.broadcast_to((b,)).contiguous()
    curdist = gathered_dist(q, vectors, metric, qn=qn, vn=vn,
                            ids=cur[:, None])[:, 0]
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


def filter_track_init(allowed, cur, curdist, P: int, tags=None, need=None):
    """The allowed-only result track (d f32[B, P], id i32[B, P]) seeded with
    the beam's best seed when that seed is allowed (by ``allowed``, or in tag
    mode by its query's predicate: ``admits``) — and with nothing else:
    the other exact seeds sit in the traversal buffer, are never scored
    again, and so never enter the track (the JAX package's behaviour, kept
    for id parity)."""
    seed_ok = admits(cur.clamp(min=0), allowed, tags, need) & (cur >= 0)
    return beam_init(torch.where(seed_ok, cur, -1),
                     torch.where(seed_ok, curdist, INF), P)


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
                 pop_width: int = 1, allowed=None):
    """Vanilla HNSW query path (hnswalg.h searchKnn): greedy descent
    max_level..1 (Kε), then the ef-beam at level 0 from that one seed (Kβ),
    filtered in the kernel when ``allowed`` (bool[N]) is given. Returns
    (dists f32[B, k], ids i32[B, k], hops i32[B], dcomp i32[B]); hops and
    dcomp count the level-0 beam, as in the JAX package."""
    trace.count("index.queries", q.shape[0])
    with trace.span("index.descent"):
        qn = sq_norms(q)
        cur, curdist = entry_dist(vectors, vn, q, qn, entry, metric)
        cur, curdist, _, _ = greedy_descent_levels(
            vectors, q, qn, adjs[max_level:0:-1], max_level, cur, curdist,
            None, metric)
        kw = dict(P=ef, ef_eff=ef, pop_width=pop_width,
                  cw=cand_width(ef, pop_width, adjs[0].shape[1], 0),
                  max_iters=max_iters, metric=metric)
        seeds = (curdist[:, None].contiguous(), cur[:, None].contiguous())
        filt = {}
        if allowed is not None:
            trk_d, trk_i = filter_track_init(allowed, cur, curdist, ef)
            filt = dict(allowed=allowed, track_d=trk_d, track_id=trk_i)
    with trace.span("index.beam"):
        out = beam_search(vectors, q, qn, adjs[0], *seeds, k=k, **kw, **filt)
        trace.count("index.beam_dcomp", out[3])
    if allowed is None:
        return out
    return out[4][:, :k], out[5][:, :k], out[2], out[3]


def buffer_width(ef: int) -> int:
    """The Slim chains' buffer width P at ef (the window stays ef): from
    256 up, ef rounded up to a bitonic width, as the JAX engine does."""
    return bitonic_buffer_width(ef) if ef >= 256 else ef


def slim_fetch(nbr, lvl_off, cap0: int, cap: int, dense0=None, dense_up=None,
               rank_up=None):
    """The Slim chains' level-fetch rule, l -> the Fetch of level l's rows:
    ``dense0`` at 0, ``dense_up`` through ``rank_up`` above, where given,
    else the CHAL slices."""
    def fetch(l: int) -> Fetch:
        if l == 0 and dense0 is not None:
            return dense_fetch(dense0)
        if l > 0 and dense_up is not None and l - 1 < len(dense_up):
            return rank_fetch(rank_up, dense_up[l - 1])
        return chal_fetch(nbr, lvl_off, l, cap if l > 0 else cap0)

    return fetch


def base_beam(fetch, vectors, q, qn, buf_d, buf_id, hops, dcomp, *,
              threshold_level: int, max_level: int, P: int, ef: int, k: int,
              pop_width: int, scan_width: int, max_iters: int, metric: str,
              **beam):
    """Both Slim chains' base beam (span ``index.beam``): the seeds (buf_d,
    buf_id) beamed (Kβ) over levels min(threshold_level, max_level)..0 in
    one carried buffer, P wide, k out of level 0, rows from ``fetch(l)``,
    beam_search's other keywords ``beam``, its result track carried level
    to level. Adds each level's counts to the seed step's ``hops`` and
    ``dcomp`` (ints or i32[B]), its dcomp also to ``index.beam_dcomp``, a
    filtered beam's admitted candidates to ``index.filter_admit``.
    Returns (buf_d, buf_id, hops, dcomp, beam)."""
    with trace.span("index.beam"):
        for l in range(min(threshold_level, max_level), -1, -1):
            f = fetch(l)
            out = beam_search(
                vectors, q, qn, f, buf_d, buf_id, P=P, ef_eff=ef,
                pop_width=pop_width,
                cw=cand_width(P, pop_width, f.width, scan_width),
                max_iters=max_iters, k=P if l > 0 else k, metric=metric,
                **beam)
            trace.count("index.beam_dcomp", out[3])
            buf_d, buf_id = out[0], out[1]
            hops, dcomp = hops + out[2], dcomp + out[3]
            if beam.get("track_d") is not None:
                trace.count("index.filter_admit", out[6])
                beam.update(track_d=out[4], track_id=out[5])
            elif beam.get("pop_track") is not None:
                beam.update(pop_track=out[4])
    return buf_d, buf_id, hops, dcomp, beam


def chal_search(graph_nbr, graph_lvl_off, entry, vectors, vn, q, *,
                max_level: int, threshold_level: int, cap0: int, cap: int,
                ef: int, k: int, max_iters: int, metric: str = "l2",
                pop_width: int = 1, dense0=None, dense_up=None, rank_up=None,
                allowed=None, scan_width: int = 0, seed_width: int = 0,
                up_vecs=None, up_vn=None, up_ids=None, up_count: int = 0,
                seed_strata: int = 0, tags=None, need=None, iters=None):
    """Full Slim query path (hnswalg_slim.h searchKnn; JAX ``chal_search``).

    Greedy descent (Kε) for levels max_level..threshold_level+1, then one
    carried buffer beamed (Kβ) over levels threshold_level..0, checked bits
    reset between levels (``base_beam``). ``entry``: one id or per-query ids
    [B]. Level 0 reads ``dense0`` rows when given, upper levels ``dense_up``
    through ``rank_up`` when given, else the CHAL slices. ``allowed`` (bool[N])
    filters in the kernel: results come from the allowed-only track, whose
    worst entry sets the stop bound, and the candidate cap ``scan_width`` is
    not applied (as in JAX). ``tags`` i32[N] with ``need`` i32[B] filter the
    same way by each query's own predicate (``admits``; counter
    ``index.filter_queries``). ``iters`` i32[B]: each query's own iteration
    cap for every beam, in place of ``max_iters``. ``seed_width`` > 1 with
    threshold_level 0 seeds level 0 with seed_width entries: the exact top
    of the (up_vecs, up_vn, up_ids) table of all level>=1 nodes,
    ``up_count`` of them real (Kα; per table segment when ``seed_strata``
    > 1; the entry unread), or without the table the buffer of a
    seed_width-wide level-1 beam. ef >= 256 that
    is not a bitonic width rounds the buffer up and keeps the window at ef.
    Returns (dists f32[B, k], ids i32[B, k], hops i32[B], dcomp i32[B]);
    hops and dcomp count the beams and the seed scan, as in the JAX package.
    """
    P = buffer_width(ef)
    fetch = slim_fetch(graph_nbr, graph_lvl_off, cap0, cap, dense0, dense_up,
                       rank_up)
    seed_width = min(seed_width, P)
    use_seed = seed_width > 1 and threshold_level == 0 and max_level >= 1
    table = use_seed and up_vecs is not None
    trace.count("index.queries", q.shape[0])
    # up to the base beam: the Kα seed scan, or the Kε descent
    with trace.span("index.seed" if table else "index.descent"):
        qn = sq_norms(q)
        # the seed scan computes a distance to every real row of the table
        hops, dcomp = 0, up_count if table else 0
        if table:
            if seed_strata > 1:
                buf_d, buf_id = topk_dist_strata(
                    q, up_vecs, up_vn, up_ids, seed_width, seed_strata,
                    metric, qn=qn)
            else:
                buf_d, spos = topk_dist(q, up_vecs, up_vn, seed_width, metric,
                                        row_ids=up_ids, qn=qn)
                si = torch.where(spos >= 0,
                                 up_ids[spos.clamp(min=0).long()], -1)
                buf_id = torch.where(torch.isinf(buf_d), -1, si).to(
                    torch.int32)
            buf_d, buf_id = buf_d.contiguous(), buf_id.contiguous()
        else:
            cur, curdist = entry_dist(vectors, vn, q, qn, entry, metric)
            # greedy levels max..lo+1; with seeds and no table, level 1 beams
            lo = 1 if use_seed else threshold_level
            cur, curdist, _, _ = greedy_descent_levels(
                vectors, q, qn, [fetch(l) for l in range(max_level, lo, -1)],
                max_level, cur, curdist, None, metric)
            buf_d = curdist[:, None].contiguous()
            buf_id = cur[:, None].contiguous()
            if use_seed:
                f1 = fetch(1)
                pw = min(4, seed_width)
                buf_d, buf_id, hops, dcomp = beam_search(
                    vectors, q, qn, f1, buf_d, buf_id, P=seed_width,
                    ef_eff=seed_width, pop_width=pw,
                    cw=cand_width(seed_width, pw, f1.width, 0),
                    max_iters=max_iters, k=seed_width, metric=metric,
                    iters=iters)
                trace.count("index.beam_dcomp", dcomp)
        filt = {} if iters is None else {"iters": iters}
        filtered = allowed is not None or tags is not None
        if filtered:
            # the allowed track's seed keys off the best seed
            trk_d, trk_i = filter_track_init(allowed, buf_id[:, 0],
                                             buf_d[:, 0], P, tags, need)
            filt.update(allowed=allowed, track_d=trk_d, track_id=trk_i)
            if tags is not None:
                filt.update(tags=tags, need=need)
                trace.count("index.filter_queries", q.shape[0])
    buf_d, buf_id, hops, dcomp, filt = base_beam(
        fetch, vectors, q, qn, buf_d, buf_id, hops, dcomp,
        threshold_level=threshold_level, max_level=max_level, P=P, ef=ef,
        k=k, pop_width=pop_width,
        scan_width=0 if filtered else scan_width,
        max_iters=max_iters, metric=metric, **filt)
    if filtered:
        return filt["track_d"][:, :k], filt["track_id"][:, :k], hops, dcomp
    return buf_d, buf_id, hops, dcomp
