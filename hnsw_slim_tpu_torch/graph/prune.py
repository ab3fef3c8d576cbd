"""Two-stage Slim pruning: HNSW LevelGraph -> compact CHAL graph (port of
hnsw_slim_tpu/graph/prune.py: convert_to_slim, convert_to_slimzero,
level_indegrees, pack_chal_arrays).

Host numpy passes around the RNG prune (kernel Kγ):
  1. degree histogram + per-level top-alpha% threshold walk
  2. per-(node,level) heuristic prune to hub/low budgets
  3. reverse-edge union + dedup
  4. re-prune to maxM0/maxM where the union overflows
  5. hierarchical filter: keep neighbor u at level l only if
     element_level(u) == l, unless l == threshold_level
  6. pack CHAL (flat ids + per-level prefix offsets)

The reference quirk is kept: level_cnts[0] is never incremented, so every
level-0 node takes the low budget unless count_level0_hubs=True.

The SlimZero conversion keeps steps 1, 5 and 6 and replaces 2-4: no
reverse-edge union; a guarded prune (Kγ's guarded mode) keeps every neighbor
whose live in-degree is at the floor, in sequential chunks that lower the
live count by what they discard, and a host pass restores the floor where
it was still broken.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SlimConfig
from ..utils import native

from .heuristic import prune_all, prune_batch, prune_batch_guarded
from .types import ChalGraph, LevelGraph


def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def degree_thresholds(adj_np: list[np.ndarray], levels: np.ndarray,
                      maxM0: int, cfg: SlimConfig,
                      count_level0_hubs: bool = False) -> np.ndarray:
    """Per-level degree thresholds via the reference's histogram walk:
    descend from the top degree, accumulate counts, stop when >=
    round(level_count * alpha)."""
    lmax = len(adj_np) - 1
    thr = np.zeros(lmax + 1, np.int64)
    for l in range(lmax + 1):
        act = levels >= l
        deg = (adj_np[l][act] >= 0).sum(axis=1)
        hist = np.bincount(deg, minlength=maxM0 + 2)
        if l == 0:
            cnt = int(act.sum()) if count_level0_hubs else 0  # reference quirk
            pct = cfg.top_degree_percent0
        else:
            cnt = int(act.sum())
            pct = cfg.top_degree_percent
        top_n = int(cnt * pct + 0.5)
        acc = 0
        for d in range(maxM0 + 1, 0, -1):
            acc += int(hist[d]) if d < len(hist) else 0
            if acc >= top_n:
                thr[l] = d
                break
    return thr


def _group_rows(src: np.ndarray, tgt: np.ndarray, act: np.ndarray, n: int):
    """Group sorted (src, tgt) pairs into left-aligned padded rows over `act`
    (ascending) node ids. Returns rows i32[len(act), W] (-1 padded)."""
    counts = np.bincount(src, minlength=n)[act]
    width = _next_pow2(int(counts.max(initial=1)))
    rows = np.full((len(act), width), -1, np.int32)
    row_idx = np.searchsorted(act, src)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    col = np.arange(len(src)) - np.repeat(starts, counts)
    rows[row_idx, col] = tgt
    return rows, counts


def _sort_row_ids(rows: np.ndarray) -> np.ndarray:
    """Ascending-id canonical order with -1 padding pushed right."""
    big = np.where(rows < 0, np.iinfo(np.int32).max, rows)
    out = np.sort(big, axis=1)
    return np.where(out == np.iinfo(np.int32).max, -1, out).astype(np.int32)


def convert_to_slim(lg: LevelGraph, vectors: torch.Tensor, vn: torch.Tensor,
                    cfg: SlimConfig, metric: str = "l2",
                    count_level0_hubs: bool = False,
                    verbose: bool = False) -> ChalGraph:
    """convertFromHNSW: the two-stage Slim conversion, on the device of
    ``vectors`` for the prunes and on the host for the rest."""
    from .build import repair_connectivity

    dev = vectors.device
    levels = lg.level.cpu().numpy()
    n = len(levels)
    lmax = lg.max_level
    adj_np = [a.cpu().numpy() for a in lg.adjs]
    maxM0 = adj_np[0].shape[1]
    maxM = adj_np[1].shape[1] if lmax >= 1 else maxM0 // 2
    thr = degree_thresholds(adj_np, levels, maxM0, cfg, count_level0_hubs)

    final_rows: list[np.ndarray] = []
    for l in range(lmax + 1):
        act = np.nonzero(levels >= l)[0]
        a = adj_np[l][act]
        deg = (a >= 0).sum(axis=1)
        if l == 0:
            budget = np.where(deg > thr[l], cfg.top_M0, cfg.low_m0)
            out_w, cap_l = cfg.top_M0, maxM0
        else:
            budget = np.where(deg > thr[l], cfg.top_M, cfg.low_m)
            out_w, cap_l = cfg.top_M, maxM
        act_t = torch.as_tensor(act.astype(np.int32), device=dev)

        # stage 2: per-(node,level) budget prune, no early-out
        pruned = prune_all(
            vectors, vn, act_t, torch.as_tensor(a, device=dev),
            torch.as_tensor(budget.astype(np.int32), device=dev),
            M=out_w, keep_all_under_m=False, metric=metric, out_width=out_w,
        ).cpu().numpy()

        # stage 3: reverse union + dedup (sorted by id), shift-packed keys;
        # the sort-based unique runs on the device (numpy's hash-based
        # unique took 22 s of a 31 s conversion at 1M)
        s_ids = np.repeat(act, out_w)
        t_ids = pruned.ravel()
        m = t_ids >= 0
        s_ids, t_ids = s_ids[m], t_ids[m]
        key = torch.unique(torch.as_tensor(np.concatenate([
            (s_ids.astype(np.int64) << np.int64(31)) | t_ids,
            (t_ids.astype(np.int64) << np.int64(31)) | s_ids,
        ]), device=dev)).cpu().numpy()
        u_src = (key >> np.int64(31)).astype(np.int64)
        u_tgt = (key & np.int64((1 << 31) - 1)).astype(np.int32)
        rows, counts = _group_rows(u_src, u_tgt, act, n)

        # stage 4: re-prune rows overflowing the level cap (hub rows reach
        # widths of 1024+; the kernel walks them without a C x C tile)
        over = np.nonzero(counts > cap_l)[0]
        if len(over):
            cand = torch.as_tensor(rows[over], device=dev)
            sel, _ = prune_batch(
                vectors, vn, torch.as_tensor(act[over].astype(np.int32),
                                             device=dev),
                cand, cand >= 0, M=cap_l, keep_all_under_m=False,
                metric=metric, out_width=cap_l,
            )
            out = np.full((len(over), rows.shape[1]), -1, np.int32)
            out[:, :cap_l] = sel.cpu().numpy()
            rows[over] = _sort_row_ids(out)
        if rows.shape[1] > cap_l:
            if (rows[:, cap_l:] >= 0).any():
                raise AssertionError("stage-4 rows over the level cap")
            rows = rows[:, :cap_l]

        # stage 5: hierarchical level filter
        if l != cfg.threshold_level:
            keep = (rows >= 0) & (levels[np.maximum(rows, 0)] == l)
            rows = _sort_row_ids(np.where(keep, rows, -1))

        full = np.full((n, rows.shape[1]), -1, np.int32)
        full[act] = rows
        if l == cfg.threshold_level:
            # pruning may sever thin bridges: re-guarantee one component at
            # the beam-entry level
            full[act] = repair_connectivity(full[act], act.astype(np.int32),
                                            vectors, metric)
        final_rows.append(full)
        if verbose:
            print(f"  slim level {l}: thr={thr[l]} "
                  f"edges={(final_rows[l] >= 0).sum()}")

    return pack_chal_arrays(
        final_rows, levels, entry=int(lg.entry), max_level=lmax,
        threshold_level=cfg.threshold_level, cap0=maxM0, cap=maxM,
        device=dev,
    )


def level_indegrees(adj_np: list[np.ndarray],
                    levels: np.ndarray) -> list[np.ndarray]:
    """Per-(node, level) in-degree of the donor graph."""
    n = len(levels)
    out = []
    for l, a in enumerate(adj_np):
        vals = a[levels >= l].reshape(-1)
        out.append(np.bincount(vals[vals >= 0], minlength=n).astype(np.int64))
    return out


GUARD_CHUNK = 8192  # rows per guarded-prune call; the result depends on it


def _guarded_rows(vectors, vn, act, a, budget, indeg, m_rev, metric):
    """SlimZero's adaptive guarded prune of one level: rows ``a`` of nodes
    ``act`` in sequential chunks of GUARD_CHUNK. A neighbor is guarded while
    its live in-degree is <= m_rev; each chunk's discards lower the live
    count before the next chunk runs (the reference decrements a shared
    counter as it prunes; a snapshot guard collapses at scale). The count
    lives on the device of ``vectors``, so no chunk waits for the host."""
    dev = vectors.device
    n = len(indeg)
    w = int(a.shape[1])
    live = torch.as_tensor(indeg, device=dev)
    a_t = torch.as_tensor(a, device=dev)
    act_t = torch.as_tensor(act.astype(np.int32), device=dev)
    m_t = torch.as_tensor(budget.astype(np.int32), device=dev)
    rows = []
    for s in range(0, len(act), GUARD_CHUNK):
        ack = a_t[s:s + GUARD_CHUNK]
        valid = ack >= 0
        guard = live[ack.clamp(min=0).long()] <= m_rev
        sel, _ = prune_batch_guarded(
            vectors, vn, act_t[s:s + GUARD_CHUNK], ack, valid, guard, M=w,
            metric=metric, out_width=w, m_per_row=m_t[s:s + GUARD_CHUNK])
        rows.append(sel)
        live -= (torch.bincount(ack[valid].long(), minlength=n)
                 - torch.bincount(sel[sel >= 0].long(), minlength=n))
    if not rows:
        return np.full((0, w), -1, np.int32)
    return torch.cat(rows).cpu().numpy()


def _restore_indegree_floor(rows: np.ndarray, donor: np.ndarray, n: int,
                            starved: np.ndarray, post: np.ndarray,
                            m_rev: int) -> None:
    """Re-add donor in-edges (from the unpruned rows ``donor`` that held the
    node, lowest row first) to every ``starved`` node until its in-degree
    reaches m_rev or the donors run out; writes into free slots of ``rows``
    in place. ``post`` is the in-degree after the prune."""
    m2 = donor >= 0
    tgts = donor[m2]
    src_rows = np.repeat(np.arange(len(donor)), m2.sum(axis=1)).astype(np.int64)
    order = np.argsort(tgts, kind="stable")  # stable: lowest row first
    ts, rs = tgts[order].astype(np.int64), src_rows[order]
    lo = np.searchsorted(ts, starved)
    hi = np.searchsorted(ts, starved, side="right")
    need = np.minimum((m_rev - post[starved]).clip(min=0),
                      hi - lo).astype(np.int64)
    # oversample donors by the per-node kept count, then drop the donors
    # that already kept the edge (they count in post)
    over_need = np.minimum(need + post[starved], hi - lo).astype(np.int64)
    total = int(over_need.sum())
    if not total:
        return
    off = np.concatenate([[0], np.cumsum(over_need)[:-1]])
    flat = (np.arange(total) - np.repeat(off, over_need)
            + np.repeat(lo, over_need))
    r_list = rs[flat]
    u_list = np.repeat(starved.astype(np.int64), over_need)
    mk = rows >= 0
    kept_keys = np.sort(np.repeat(np.arange(len(rows)), mk.sum(axis=1))
                        * np.int64(n) + rows[mk])
    cand_keys = r_list * np.int64(n) + u_list
    pos2 = np.searchsorted(kept_keys, cand_keys)
    dup = np.zeros(len(cand_keys), bool)
    inb = pos2 < len(kept_keys)
    dup[inb] = kept_keys[pos2[inb]] == cand_keys[inb]
    r_list, u_list = r_list[~dup], u_list[~dup]
    # cap restores per node at its need
    need_of = np.zeros(n, np.int64)
    need_of[starved] = need
    order_u = np.argsort(u_list, kind="stable")
    uu, rr = u_list[order_u], r_list[order_u]
    keep2 = np.arange(len(uu)) - np.searchsorted(uu, uu) < need_of[uu]
    uu, rr = uu[keep2], rr[keep2]
    # scatter into free slots, grouped per donor row
    order_r = np.argsort(rr, kind="stable")
    rr, uu = rr[order_r], uu[order_r]
    slot = (rows >= 0).sum(axis=1)[rr] + np.arange(len(rr)) \
        - np.searchsorted(rr, rr)
    okslot = slot < rows.shape[1]
    rows[rr[okslot], slot[okslot]] = uu[okslot]


def convert_to_slimzero(lg: LevelGraph, vectors: torch.Tensor,
                        vn: torch.Tensor, cfg: SlimConfig, metric: str = "l2",
                        count_level0_hubs: bool = False,
                        verbose: bool = False,
                        state: dict | None = None) -> ChalGraph:
    """SlimZero conversion: the Slim hub/low budgets but no reverse-edge
    union; connectivity is kept by an in-degree guard (any neighbor whose
    live in-degree is <= min_indegree stays), then one repair pass restores
    the floor from donor edges, rows over the level cap are re-pruned, and
    the hierarchical filter and connectivity repair run as in Slim.

    ``state``, if given, captures what an incremental conversion needs:
    final rows, budgets, thresholds, caps, levels, entry, lmax."""
    from .build import repair_connectivity

    dev = vectors.device
    levels = lg.level.cpu().numpy()
    n = len(levels)
    lmax = lg.max_level
    adj_np = [a.cpu().numpy() for a in lg.adjs]
    maxM0 = adj_np[0].shape[1]
    maxM = adj_np[1].shape[1] if lmax >= 1 else maxM0 // 2
    thr = degree_thresholds(adj_np, levels, maxM0, cfg, count_level0_hubs)
    indeg = level_indegrees(adj_np, levels)

    final_rows: list[np.ndarray] = []
    for l in range(lmax + 1):
        act = np.nonzero(levels >= l)[0]
        a = adj_np[l][act]
        deg = (a >= 0).sum(axis=1)
        if l == 0:
            budget = np.where(deg > thr[l], cfg.top_M0, cfg.low_m0)
            cap_l, m_rev = maxM0, cfg.min_indegree0
        else:
            budget = np.where(deg > thr[l], cfg.top_M, cfg.low_m)
            cap_l, m_rev = maxM, cfg.min_indegree
        rows = _guarded_rows(vectors, vn, act, a, budget, indeg[l], m_rev,
                             metric)

        # in-degree floor repair
        post = np.bincount(rows[rows >= 0], minlength=n)
        starved = np.nonzero((post < m_rev) & (levels >= l))[0]
        if len(starved) and (a >= 0).any():
            _restore_indegree_floor(rows, a, n, starved, post, m_rev)

        # cap re-prune where over (plain RNG prune)
        counts = (rows >= 0).sum(axis=1)
        over = np.nonzero(counts > cap_l)[0]
        out_rows = np.full((len(act), cap_l), -1, np.int32)
        under = counts <= cap_l
        w = min(cap_l, rows.shape[1])
        out_rows[under, :w] = _sort_row_ids(rows[under])[:, :w]
        if len(over):
            cand = torch.as_tensor(rows[over], device=dev)
            sel, _ = prune_batch(
                vectors, vn,
                torch.as_tensor(act[over].astype(np.int32), device=dev),
                cand, cand >= 0, M=cap_l, keep_all_under_m=False,
                metric=metric, out_width=cap_l)
            out_rows[over] = _sort_row_ids(sel.cpu().numpy())
        rows = out_rows

        # hierarchical filter (same as Slim)
        if l != cfg.threshold_level:
            keep = (rows >= 0) & (levels[np.maximum(rows, 0)] == l)
            rows = _sort_row_ids(np.where(keep, rows, -1))

        full = np.full((n, rows.shape[1]), -1, np.int32)
        full[act] = rows
        if l == cfg.threshold_level:
            full[act] = repair_connectivity(full[act], act.astype(np.int32),
                                            vectors, metric)
        final_rows.append(full)
        if state is not None:
            b_full = np.zeros(n, np.int32)
            b_full[act] = budget
            state.setdefault("budgets", []).append(b_full)
        if verbose:
            print(f"  slimzero level {l}: thr={thr[l]} "
                  f"edges={(full >= 0).sum()}")

    if state is not None:
        state["final"] = final_rows
        state["thr"] = thr
        state["caps"] = [maxM0] + [maxM] * lmax
        state["levels"] = levels.copy()
        state["entry"] = int(lg.entry)
        state["lmax"] = lmax
    return pack_chal_arrays(
        final_rows, levels, entry=int(lg.entry), max_level=lmax,
        threshold_level=cfg.threshold_level, cap0=maxM0, cap=maxM,
        device=dev,
    )


def _pad_to_len(a: np.ndarray, size: int, fill: int) -> np.ndarray:
    """``a`` extended along axis 0 to ``size`` rows of ``fill``."""
    if a.shape[0] >= size:
        return a
    pad = np.full((size - a.shape[0],) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, pad])


def pack_chal_arrays(per_level_rows: list[np.ndarray], levels: np.ndarray,
                     entry: int, max_level: int, threshold_level: int,
                     cap0: int, cap: int, device, return_host: bool = False):
    """CHAL packing: flat neighbor ids grouped per node, per level, with
    absolute prefix offsets (native single pass, numpy fallback).

    ``device=None`` uploads nothing: the ChalGraph then holds CPU tensors
    over the host arrays, for a serving stack that reads only the dense
    layouts and keeps the flat CHAL for patches and persistence.
    ``return_host=True`` also returns the host numpy dict {nbr, lvl_off,
    level}, so that patch and persist consumers never pull the arrays back."""
    n = len(levels)
    lcnt = max_level + 1
    packed = native.chal_pack(per_level_rows, levels)
    if packed is not None:
        lvl_off, nbr = packed
        total = len(nbr)
    else:
        counts = np.zeros((n, lcnt), np.int64)
        for l in range(lcnt):
            counts[:, l] = ((per_level_rows[l] >= 0)
                            & (levels >= l)[:, None]).sum(axis=1)
        node_total = counts.sum(axis=1)
        lvl_off = np.zeros((n, lcnt + 1), np.int64)
        lvl_off[:, 0] = np.concatenate([[0], np.cumsum(node_total)[:-1]])
        for l in range(lcnt):
            lvl_off[:, l + 1] = lvl_off[:, l] + counts[:, l]
        total = int(node_total.sum())
        nbr = np.full(total, -1, np.int32)
        for l in range(lcnt):
            rows = per_level_rows[l]
            mask = (rows >= 0) & (levels >= l)[:, None]
            rank = np.cumsum(mask, axis=1) - 1
            nbr[(lvl_off[:, l][:, None] + rank)[mask]] = rows[mask]
    e_pad = max(1024, _next_pow2(total))
    flat = np.full(e_pad, -1, np.int32)
    flat[:total] = nbr[:total]
    host = dict(nbr=flat, lvl_off=np.ascontiguousarray(lvl_off, np.int32),
                level=np.ascontiguousarray(levels, np.int32))
    graph = ChalGraph.from_numpy(
        host["nbr"], host["lvl_off"], host["level"], entry=entry,
        max_level=max_level, threshold_level=threshold_level, cap0=cap0,
        cap=cap, device="cpu" if device is None else device,
        # level -1 marks capacity-padding rows: the logical count has none
        n_real=int((levels >= 0).sum()),
    )
    return (graph, host) if return_host else graph
