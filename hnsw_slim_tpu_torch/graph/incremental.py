"""Incremental Slim conversion: re-prune only what an update touched (port
of hnsw_slim_tpu/graph/incremental.py).

The reference re-prunes the whole graph on every update. Here the conversion
keeps its intermediate state, so that an update only recomputes:

  stage 2 (budget prune)      nodes whose vanilla adjacency or hub budget
                              changed
  stage 3 (reverse union)     the edge-key delta from those rows
  stage 4/5 (cap + filter)    nodes whose union membership changed

The output of ``IncrementalSlim`` is identical to a full ``convert_to_slim``
over the updated vanilla graph: same stages, same kernel (Kγ prunes each row
in a block of its own, so a row's result does not depend on the rows beside
it), only the node set shrinks. The degree-threshold walk is recomputed
every update from the full histogram; a threshold shift re-prunes exactly the
nodes whose budget flipped.

One deliberate exception: connectivity-repair edges. ``full`` runs
``repair_connectivity`` at the threshold level and records the edges it
added; ``update`` re-applies those to any recomputed row, so bridges survive
any number of updates. When the repair was a no-op (insertion-built bases)
the recorded set is empty and the identical-to-full contract holds exactly;
otherwise ``update`` keeps the original bridges. Deletes can cut the Slim
graph where a full pass would bridge it again: ``repair_updates=True``
re-runs the components pass in ``update`` and restores the equality.

Union edges are one sorted int64 key array per level, key = src << 31 | tgt;
a directed key exists iff either direction is a stage-2 edge.

All state is host numpy; the prunes run on the device of the vectors they
are given. ``last_stats`` holds the last call's set sizes and, for
``IncrementalSlim``, its seconds by stage and level (``utils/trace.phase``:
each stage is also a ``reprune.*`` span).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SlimConfig
from ..utils import trace
from .heuristic import prune_all, prune_batch, prune_batch_guarded
from .prune import (_pad_to_len, _sort_row_ids, convert_to_slimzero,
                    degree_thresholds, pack_chal_arrays)
from .types import ChalGraph, LevelGraph

_SHIFT = np.int64(31)
_LOW = (np.int64(1) << _SHIFT) - 1


def _keys_of(src: np.ndarray, tgt: np.ndarray) -> np.ndarray:
    return (src.astype(np.int64) << _SHIFT) | tgt.astype(np.int64)


def _row_edges(rows: np.ndarray, ids: np.ndarray):
    """(src, tgt) arrays over valid entries of rows (ids aligned)."""
    m = rows >= 0
    return np.repeat(ids, m.sum(axis=1)), rows[m]


def _added_keys(pre: np.ndarray, post: np.ndarray,
                ids: np.ndarray) -> np.ndarray:
    """Directed (src, tgt) keys present in `post` rows but not `pre` rows."""
    s1, t1 = _row_edges(post, ids)
    s0, t0 = _row_edges(pre, ids)
    return np.setdiff1d(_keys_of(s1, t1), _keys_of(s0, t0))


def _sorted_merge(keys: np.ndarray, add: np.ndarray, rem: np.ndarray):
    """keys sorted; remove `rem` then insert `add` (both deduped). Linear in
    len(keys): the delta is tiny beside the array, which a union would sort
    again."""
    if len(rem):
        pos = np.searchsorted(keys, rem)
        ok = keys[np.minimum(pos, len(keys) - 1)] == rem
        keep = np.ones(len(keys), bool)
        keep[pos[ok]] = False
        keys = keys[keep]
    if len(add):
        add = np.unique(add)
        keys = np.insert(keys, np.searchsorted(keys, add), add)
    return keys


def _dev(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), device=like.device)


def _pack(obj, device) -> ChalGraph:
    """Pack obj.final into a ChalGraph on ``device`` (None: host arrays
    only) and keep the host mirror in obj.host_chal for the patch and
    persist paths."""
    graph, obj.host_chal = pack_chal_arrays(
        obj.final, obj.levels, entry=obj.entry, max_level=obj.lmax,
        threshold_level=obj.cfg.threshold_level, cap0=obj.caps[0],
        cap=obj.caps[1] if obj.lmax >= 1 else obj.caps[0] // 2,
        device=device, return_host=True)
    return graph


class IncrementalSlim:
    """Stateful convertFromHNSW: full() once, then update(touched) per batch.

    State per level: thr (degree threshold), budgets, stage-2 pruned rows,
    the union key array, and the final (post-filter) rows the CHAL packer
    consumes.
    """

    def __init__(self, cfg: SlimConfig, metric: str = "l2",
                 count_level0_hubs: bool = False,
                 repair_updates: bool = False):
        self.cfg = cfg
        self.metric = metric
        self.count_level0_hubs = count_level0_hubs
        # Whether update() re-runs the whole-graph connectivity repair.
        # full() always repairs (an NN-descent build needs it); updates of an
        # insertion-maintained graph keep connectivity by construction, and
        # the reference repairs nothing either.
        self.repair_updates = repair_updates
        self.thr: np.ndarray | None = None
        self.budgets: list[np.ndarray] = []
        self.stage2: list[np.ndarray] = []
        self.keys: list[np.ndarray] = []
        self.final: list[np.ndarray] = []
        self.levels: np.ndarray | None = None
        self.entry = 0
        self.lmax = 0
        self.caps: list[int] = []
        self.out_ws: list[int] = []
        # directed (src, tgt) keys repair_connectivity added at the threshold
        # level; re-applied to recomputed rows so bridges survive updates
        self.repair_keys = np.zeros(0, np.int64)
        self.host_chal: dict | None = None
        self.last_stats: dict = {}

    # ---- shared kernels ------------------------------------------------

    def _stage2_prune(self, vectors, vn, ids: np.ndarray, cand: np.ndarray,
                      budget: np.ndarray, out_w: int) -> np.ndarray:
        """Budget prune of rows ``cand`` of nodes ``ids`` (Kγ)."""
        if len(ids) == 0:
            return np.zeros((0, out_w), np.int32)
        return prune_all(
            vectors, vn, _dev(ids.astype(np.int32), vectors),
            _dev(cand, vectors), _dev(budget.astype(np.int32), vectors),
            M=out_w, keep_all_under_m=False, metric=self.metric,
            out_width=out_w).cpu().numpy()

    def _cap_reprune(self, vectors, vn, ids: np.ndarray, rows: np.ndarray,
                     cap_l: int) -> np.ndarray:
        """Stage-4 re-prune of over-cap union rows (Kγ), ids ascending."""
        cand = _dev(rows, vectors)
        sel, _ = prune_batch(
            vectors, vn, _dev(ids.astype(np.int32), vectors), cand,
            cand >= 0, M=cap_l, keep_all_under_m=False, metric=self.metric,
            out_width=cap_l)
        return _sort_row_ids(sel.cpu().numpy())

    def _union_rows(self, l: int, ids: np.ndarray, lo: np.ndarray,
                    hi: np.ndarray, width: int) -> np.ndarray:
        """Union rows i32[len(ids), width] (-1 padded, ascending) from the
        key ranges [lo, hi) of the sorted key array."""
        keys = self.keys[l]
        if len(keys) == 0:
            return np.full((len(ids), width), -1, np.int32)
        idx = lo[:, None] + np.arange(width)[None, :]
        valid = idx < hi[:, None]
        return np.where(
            valid, keys[np.minimum(idx, len(keys) - 1)] & _LOW, -1
        ).astype(np.int32)

    def _stages45(self, l: int, ids: np.ndarray, vectors, vn) -> np.ndarray:
        """Union rows -> cap re-prune -> hierarchical level filter; returns
        final rows [len(ids), cap_l] (canonical ascending, -1 padded). Only
        the rows over the cap are gathered at their full width (hub rows
        hold hundreds of ids)."""
        cap_l = self.caps[l]
        keys = self.keys[l]
        lo = np.searchsorted(keys, _keys_of(ids, np.zeros_like(ids)))
        hi = np.searchsorted(keys, _keys_of(ids + 1, np.zeros_like(ids)))
        counts = hi - lo
        out = self._union_rows(l, ids, lo, np.minimum(hi, lo + cap_l), cap_l)
        over = np.nonzero(counts > cap_l)[0]
        if len(over):
            rows = self._union_rows(l, ids[over], lo[over], hi[over],
                                    int(counts[over].max()))
            out[over] = self._cap_reprune(vectors, vn, ids[over], rows,
                                          cap_l)
        if l != self.cfg.threshold_level:
            keep = (out >= 0) & (self.levels[np.maximum(out, 0)] == l)
            out = _sort_row_ids(np.where(keep, out, -1))
        return out

    # ---- full conversion -------------------------------------------------

    def full(self, adj_np: list[np.ndarray], levels: np.ndarray, entry: int,
             vectors: torch.Tensor, vn: torch.Tensor,
             verbose: bool = False) -> ChalGraph:
        """Initial convertFromHNSW, capturing the per-level state the update
        path needs. The graph lands on the device of ``vectors``."""
        marks: dict = {}
        self.levels = np.asarray(levels, np.int32).copy()
        n = len(self.levels)
        self.entry = int(entry)
        self.lmax = len(adj_np) - 1
        maxM0 = adj_np[0].shape[1]
        maxM = adj_np[1].shape[1] if self.lmax >= 1 else maxM0 // 2
        self.caps = [maxM0] + [maxM] * self.lmax
        self.out_ws = [self.cfg.top_M0] + [self.cfg.top_M] * self.lmax
        self.thr = degree_thresholds(
            adj_np, self.levels, maxM0, self.cfg, self.count_level0_hubs)
        self.budgets, self.stage2, self.keys, self.final = [], [], [], []
        self.repair_keys = np.zeros(0, np.int64)

        for l in range(self.lmax + 1):
            with trace.phase("reprune.stage2", marks, f"L{l}.stage2",
                             level=l):
                act = np.nonzero(self.levels >= l)[0]
                a = adj_np[l][act]
                deg = (a >= 0).sum(axis=1)
                hi, lo = ((self.cfg.top_M0, self.cfg.low_m0) if l == 0
                          else (self.cfg.top_M, self.cfg.low_m))
                out_w = self.out_ws[l]
                budget_act = np.where(deg > self.thr[l], hi, lo)
                budgets = np.zeros(n, np.int32)
                budgets[act] = budget_act
                self.budgets.append(budgets)

                pruned = self._stage2_prune(vectors, vn, act, a, budget_act,
                                            out_w)
            with trace.phase("reprune.keys", marks, f"L{l}.keys", level=l):
                s2 = np.full((n, out_w), -1, np.int32)
                s2[act] = pruned
                self.stage2.append(s2)

                # sort-based unique on the device, as convert_to_slim does
                src, tgt = _row_edges(pruned, act)
                self.keys.append(torch.unique(_dev(np.concatenate(
                    [_keys_of(src, tgt), _keys_of(tgt, src)]), vectors)
                ).cpu().numpy())
            with trace.phase("reprune.stages45", marks, f"L{l}.stages45",
                             level=l):
                fin = np.full((n, self.caps[l]), -1, np.int32)
                fin[act] = self._stages45(l, act, vectors, vn)
            if l == self.cfg.threshold_level:
                with trace.phase("reprune.repair", marks, f"L{l}.repair",
                                 level=l):
                    pre = fin[act]
                    post = self._repair(pre, act, vectors)
                    # key sets of the rows the repair changed only: the set
                    # difference over all of a level's edges costs tens of
                    # seconds at 1M, and an untouched row adds no key
                    hit = (pre != post).any(axis=1)
                    self.repair_keys = _added_keys(pre[hit], post[hit],
                                                   act[hit])
                    fin[act] = post
            self.final.append(fin)
            if verbose:
                print(f"  inc level {l}: thr={self.thr[l]} "
                      f"edges={(fin >= 0).sum()}")

        with trace.phase("reprune.pack", marks, "pack"):
            graph = _pack(self, vectors.device)
        self.last_stats = {"seconds": marks}
        return graph

    # ---- incremental update ----------------------------------------------

    def update(self, adj_np: list[np.ndarray], levels: np.ndarray, entry: int,
               vectors: torch.Tensor, vn: torch.Tensor, touched: np.ndarray,
               level_changed: np.ndarray | None = None,
               verbose: bool = False, device_pack: bool = True):
        """Re-prune after `touched` vanilla rows changed (inserted nodes and
        reverse-connect targets). `level_changed`: nodes whose element level
        changed (slot reuse draws new levels): their in-neighbors' stage-5
        membership filters are re-evaluated. ``device_pack=False`` packs to
        host arrays only. Returns (graph, changed_node_ids): the ids whose
        final CHAL content differs, the patch membership set."""
        marks: dict = {}
        sizes: dict = {}

        n_old = len(self.levels)
        levels = np.asarray(levels, np.int32)
        n = len(levels)
        self.entry = int(entry)
        lmax_new = len(adj_np) - 1
        if lmax_new > self.lmax:  # a new top level appeared (rare)
            for l in range(self.lmax + 1, lmax_new + 1):
                self.caps.append(adj_np[l].shape[1])
                self.out_ws.append(self.cfg.top_M)
                self.budgets.append(np.zeros(n_old, np.int32))
                self.stage2.append(
                    np.full((n_old, self.cfg.top_M), -1, np.int32))
                self.keys.append(np.zeros(0, np.int64))
                self.final.append(
                    np.full((n_old, self.caps[l]), -1, np.int32))
            self.lmax = lmax_new
        if n > n_old:  # once per capacity bucket, not per batch
            self.budgets = [_pad_to_len(b, n, 0) for b in self.budgets]
            self.stage2 = [_pad_to_len(s, n, -1) for s in self.stage2]
            self.final = [_pad_to_len(f, n, -1) for f in self.final]
        self.levels = levels.copy()

        touched = np.unique(np.asarray(touched, np.int64))
        maxM0 = adj_np[0].shape[1]
        thr = degree_thresholds(
            adj_np, levels, maxM0, self.cfg, self.count_level0_hubs)
        self.thr = thr
        changed_all: list[np.ndarray] = []

        for l in range(self.lmax + 1):
            with trace.phase("reprune.stage2", marks, f"L{l}.stage2",
                             level=l):
                act_mask = levels >= l
                hi, lo = ((self.cfg.top_M0, self.cfg.low_m0) if l == 0
                          else (self.cfg.top_M, self.cfg.low_m))
                deg_all = (adj_np[l] >= 0).sum(axis=1)
                budgets_new = np.where(
                    act_mask, np.where(deg_all > thr[l], hi, lo), 0
                ).astype(np.int32)

                # stage-2 set: touched rows + budget flips (threshold drift,
                # level deactivation via slot reuse -> budget 0)
                c2_mask = np.zeros(n, bool)
                c2_mask[touched] = True
                c2_mask |= budgets_new != self.budgets[l]
                c2 = np.nonzero(c2_mask)[0]
                self.budgets[l] = budgets_new

                act_c2 = c2[act_mask[c2]]
                old_rows = self.stage2[l][c2]
                new_rows = np.full((len(c2), self.out_ws[l]), -1, np.int32)
                new_rows[act_mask[c2]] = self._stage2_prune(
                    vectors, vn, act_c2, adj_np[l][act_c2],
                    budgets_new[act_c2], self.out_ws[l])
                self.stage2[l][c2] = new_rows
            with trace.phase("reprune.keys", marks, f"L{l}.keys", level=l):
                # stage-3 delta: every pair whose directed membership may flip
                os_, ot = _row_edges(old_rows, c2)
                ns, nt = _row_edges(new_rows, c2)
                pair_u = np.concatenate([os_, ot, ns, nt])
                pair_v = np.concatenate([ot, os_, nt, ns])
                n_flip = 0
                if len(pair_u):
                    cand = np.unique(_keys_of(pair_u, pair_v))
                    cu = (cand >> _SHIFT).astype(np.int64)
                    cv = (cand & _LOW).astype(np.int64)
                    # key (u,v) exists iff v in stage2[u] or u in stage2[v]
                    want = (
                        (self.stage2[l][cu] == cv[:, None]).any(axis=1)
                        | (self.stage2[l][cv] == cu[:, None]).any(axis=1)
                    )
                    pos = np.searchsorted(self.keys[l], cand)
                    have = np.zeros(len(cand), bool)
                    inb = pos < len(self.keys[l])
                    have[inb] = self.keys[l][pos[inb]] == cand[inb]
                    flip = want != have
                    n_flip = int(flip.sum())
                    self.keys[l] = _sorted_merge(
                        self.keys[l], cand[flip & want], cand[flip & ~want])
                    affected_src = cu[flip]
                else:
                    affected_src = np.zeros(0, np.int64)

                # stage-5 membership depends on neighbor LEVELS: in-neighbors
                # of level-changed nodes must re-filter even if their union
                # is intact
                lvl_extra = np.zeros(0, np.int64)
                if (level_changed is not None and len(level_changed)
                        and l != self.cfg.threshold_level
                        and len(self.keys[l])):
                    moved = np.zeros(n, bool)
                    moved[np.asarray(level_changed, np.int64)] = True
                    hitk = moved[self.keys[l] & _LOW]
                    lvl_extra = (self.keys[l][hitk]
                                 >> _SHIFT).astype(np.int64)
            with trace.phase("reprune.stages45", marks, f"L{l}.stages45",
                             level=l) as ph:
                # repair-edge bookkeeping: drop bridges with a deactivated
                # endpoint (their src rows must be rebuilt to shed the stale
                # id)
                rep_extra = np.zeros(0, np.int64)
                if l == self.cfg.threshold_level and len(self.repair_keys):
                    rs = (self.repair_keys >> _SHIFT).astype(np.int64)
                    rt = (self.repair_keys & _LOW).astype(np.int64)
                    alive = act_mask[rs] & act_mask[rt]
                    rep_extra = np.unique(rs[~alive])
                    self.repair_keys = self.repair_keys[alive]
                # stage-4/5 working set: rows whose UNION actually changed
                # (the key delta's flipped sources), not all of c2: a touched
                # row whose stage-2 output re-pruned to the same edges has an
                # intact union and an intact final row. Inactive c2 rows
                # still pass through for the clearing path: a node can
                # deactivate without any key flipping (its reverse membership
                # in others' stage-2 rows keeps the keys alive).
                c2_inact = c2[~act_mask[c2]]
                a_all = np.unique(np.concatenate(
                    [c2_inact, affected_src, lvl_extra, rep_extra]))
                a_ids = a_all[act_mask[a_all]]
                deact = a_all[~act_mask[a_all]]
                sizes[f"L{l}"] = {"stage2": len(act_c2), "flips": n_flip,
                                  "stages45": len(a_ids)}
                changed_l = []
                if len(deact):  # level dropped: clear rows, mark changed
                    had = (self.final[l][deact] >= 0).any(axis=1)
                    self.final[l][deact] = -1
                    changed_l.append(deact[had])
                if len(a_ids) == 0:
                    changed_all.append(
                        np.concatenate(changed_l) if changed_l
                        else np.zeros(0, np.int64))
                    ph.into = None  # no stage 4/5 at this level: no time
                    continue
                new_final = self._stages45(l, a_ids, vectors, vn)
                if l == self.cfg.threshold_level and len(self.repair_keys):
                    # stage 4/5 rebuilt these rows from the union, which never
                    # held the repair bridges: re-apply them
                    rs = (self.repair_keys >> _SHIFT).astype(np.int64)
                    rt = (self.repair_keys & _LOW).astype(np.int64)
                    lookup = np.full(n, -1, np.int64)
                    lookup[a_ids] = np.arange(len(a_ids))
                    li = lookup[rs]
                    hit = li >= 0
                    for i, t in zip(li[hit], rt[hit]):  # bridges are few
                        row = new_final[i]
                        if t in row:
                            continue
                        empty = np.nonzero(row < 0)[0]
                        row[empty[0] if len(empty) else -1] = t
                changed_rows = (self.final[l][a_ids] != new_final).any(axis=1)
                self.final[l][a_ids] = new_final

            changed_l.append(a_ids[changed_rows])
            if l == self.cfg.threshold_level and self.repair_updates:
                with trace.phase("reprune.repair", marks, f"L{l}.repair",
                                 level=l):
                    act = np.nonzero(act_mask)[0]
                    repaired = self._repair(self.final[l][act], act, vectors)
                    rep_changed = (repaired != self.final[l][act]).any(axis=1)
                    self.repair_keys = np.union1d(
                        self.repair_keys,
                        _added_keys(self.final[l][act][rep_changed],
                                    repaired[rep_changed], act[rep_changed]))
                    self.final[l][act] = repaired
                    changed_l.append(act[rep_changed])
            changed_all.append(np.unique(np.concatenate(changed_l)))
            if verbose:
                print(f"  inc-upd level {l}: c2={len(c2)} "
                      f"affected={len(a_ids)} changed={changed_rows.sum()}")

        changed = np.unique(np.concatenate(changed_all)) if changed_all else \
            np.zeros(0, np.int64)
        with trace.phase("reprune.pack", marks, "pack"):
            out = _pack(self, vectors.device if device_pack else None)
        self.last_stats = {"seconds": marks, "sizes": sizes,
                           "changed": len(changed)}
        return out, changed

    def _repair(self, rows: np.ndarray, act: np.ndarray, vectors):
        from .build import repair_connectivity

        return repair_connectivity(rows, act.astype(np.int32), vectors,
                                   self.metric)


class IncrementalSlimZero:
    """Stateful SlimZero conversion: full() once, then update(touched).

    Like the reference, whose shared in-degree counters carry across calls,
    the incremental pass re-prunes touched rows against the LIVE in-degrees
    of the current serving graph, so the result is invariant-equivalent
    (floor, cap and hierarchy hold after every update) rather than identical
    to a fresh full pass. Floor starvation brought in by a delta is repaired
    by re-adding donor in-edges, as the full pass does.
    """

    def __init__(self, cfg: SlimConfig, metric: str = "l2",
                 count_level0_hubs: bool = False):
        self.cfg = cfg
        self.metric = metric
        self.count_level0_hubs = count_level0_hubs
        self.final: list[np.ndarray] = []
        self.budgets: list[np.ndarray] = []
        self.thr: np.ndarray | None = None
        self.levels: np.ndarray | None = None
        self.entry = 0
        self.lmax = 0
        self.caps: list[int] = []
        self.host_chal: dict | None = None
        self.last_stats: dict = {}

    def full(self, adj_np: list[np.ndarray], levels: np.ndarray, entry: int,
             vectors: torch.Tensor, vn: torch.Tensor,
             verbose: bool = False) -> ChalGraph:
        lg = LevelGraph.from_numpy(adj_np, levels, entry=int(entry),
                                   max_level=len(adj_np) - 1,
                                   device=vectors.device)
        st: dict = {}
        convert_to_slimzero(
            lg, vectors, vn, self.cfg, metric=self.metric,
            count_level0_hubs=self.count_level0_hubs, verbose=verbose,
            state=st)
        self.final = st["final"]
        self.budgets = st["budgets"]
        self.thr = st["thr"]
        self.levels = np.asarray(levels, np.int32).copy()
        self.entry = int(entry)
        self.lmax = st["lmax"]
        self.caps = st["caps"]
        # packed here so that host_chal exists for the patch path
        return _pack(self, vectors.device)

    def update(self, adj_np: list[np.ndarray], levels: np.ndarray, entry: int,
               vectors: torch.Tensor, vn: torch.Tensor, touched: np.ndarray,
               level_changed: np.ndarray | None = None,
               verbose: bool = False, device_pack: bool = True):
        """Re-prune after `touched` vanilla rows changed. Returns (graph,
        changed_node_ids): ids whose final CHAL content differs."""
        sizes: dict = {}
        n_old = len(self.levels)
        levels = np.asarray(levels, np.int32)
        n = len(levels)
        self.entry = int(entry)
        lmax_new = len(adj_np) - 1
        if lmax_new > self.lmax:
            for l in range(self.lmax + 1, lmax_new + 1):
                self.caps.append(adj_np[l].shape[1])
                self.final.append(
                    np.full((n_old, self.caps[l]), -1, np.int32))
                self.budgets.append(np.zeros(n_old, np.int32))
            self.lmax = lmax_new
        if n > n_old:
            self.final = [_pad_to_len(f, n, -1) for f in self.final]
            self.budgets = [_pad_to_len(b, n, 0) for b in self.budgets]
        self.levels = levels.copy()

        touched = np.unique(np.asarray(touched, np.int64))
        maxM0 = adj_np[0].shape[1]
        self.thr = degree_thresholds(
            adj_np, levels, maxM0, self.cfg, self.count_level0_hubs)
        changed_all: list[np.ndarray] = []

        for l in range(self.lmax + 1):
            act_mask = levels >= l
            hi, lo = ((self.cfg.top_M0, self.cfg.low_m0) if l == 0
                      else (self.cfg.top_M, self.cfg.low_m))
            m_rev = (self.cfg.min_indegree0 if l == 0
                     else self.cfg.min_indegree)
            cap_l = self.caps[l]
            deg_all = (adj_np[l] >= 0).sum(axis=1)
            budgets_new = np.where(
                act_mask, np.where(deg_all > self.thr[l], hi, lo), 0
            ).astype(np.int32)

            r_mask = np.zeros(n, bool)
            r_mask[touched] = True
            r_mask |= budgets_new != self.budgets[l]
            if level_changed is not None and len(level_changed):
                r_mask[np.asarray(level_changed, np.int64)] = True
            r_all = np.nonzero(r_mask)[0]
            self.budgets[l] = budgets_new

            changed_l: list[np.ndarray] = []
            deact = r_all[~act_mask[r_all]]
            if len(deact):
                had = (self.final[l][deact] >= 0).any(axis=1)
                self.final[l][deact] = -1
                changed_l.append(deact[had])
            r = r_all[act_mask[r_all]]
            if len(r) == 0:
                changed_all.append(
                    np.concatenate(changed_l) if changed_l
                    else np.zeros(0, np.int64))
                continue

            fin = self.final[l]
            live = np.bincount(fin.reshape(-1)[fin.reshape(-1) >= 0],
                               minlength=n)
            old_rows = fin[r].copy()
            a_r = adj_np[l][r]
            guard = live[np.maximum(a_r, 0)] <= m_rev
            w_in = a_r.shape[1]
            # the guard is a snapshot, so one call prunes every row
            cand = _dev(a_r, vectors)
            sel, _ = prune_batch_guarded(
                vectors, vn, _dev(r.astype(np.int32), vectors), cand,
                cand >= 0, _dev(guard, vectors), M=w_in, metric=self.metric,
                out_width=w_in, m_per_row=_dev(budgets_new[r], vectors))
            rows = self._cap_filter(l, r, sel.cpu().numpy(), vectors, vn,
                                    cap_l, levels)
            diff = (old_rows != rows).any(axis=1)
            self.final[l][r] = rows
            changed_l.append(r[diff])

            # delta in-degree -> floor repair: active nodes keep in-degree
            # >= m_rev where donors exist. At non-threshold levels only
            # exactly-level-l nodes can survive the hierarchy filter in a
            # donor row, so only those repair.
            live2 = live.copy()
            for arr, sign in ((old_rows, -1), (rows, +1)):
                v = arr.reshape(-1)
                v = v[v >= 0]
                if len(v):
                    live2 += sign * np.bincount(v, minlength=n)
            s_mask = (live2 < m_rev) & act_mask
            if l != self.cfg.threshold_level:
                s_mask &= levels == l
            starved = np.nonzero(s_mask)[0]
            if len(starved):
                changed_l.append(self._floor_repair(
                    l, starved, live2, adj_np[l], act_mask, m_rev))
            changed_all.append(np.unique(np.concatenate(changed_l)))
            sizes[f"L{l}"] = {"repruned": len(r), "changed": int(diff.sum()),
                              "starved": len(starved)}
            if verbose:
                print(f"  zinc-upd level {l}: r={len(r)} "
                      f"changed={int(diff.sum())} starved={len(starved)}")

        changed = np.unique(np.concatenate(changed_all)) if changed_all else \
            np.zeros(0, np.int64)
        out = _pack(self, vectors.device if device_pack else None)
        self.last_stats = {"sizes": sizes, "changed": len(changed)}
        return out, changed

    def _cap_filter(self, l, ids, rows, vectors, vn, cap_l, levels):
        """Cap re-prune + hierarchical level filter (the full pass's stages
        on the recomputed subset)."""
        counts = (rows >= 0).sum(axis=1)
        out = np.full((len(ids), cap_l), -1, np.int32)
        under = counts <= cap_l
        w = min(cap_l, rows.shape[1])
        out[under, :w] = _sort_row_ids(rows[under])[:, :w]
        over = np.nonzero(~under)[0]
        if len(over):
            cand = _dev(rows[over], vectors)
            sel, _ = prune_batch(
                vectors, vn, _dev(ids[over].astype(np.int32), vectors), cand,
                cand >= 0, M=cap_l, keep_all_under_m=False,
                metric=self.metric, out_width=cap_l)
            out[over] = _sort_row_ids(sel.cpu().numpy())
        if l != self.cfg.threshold_level:
            keep = (out >= 0) & (levels[np.maximum(out, 0)] == l)
            out = _sort_row_ids(np.where(keep, out, -1))
        return out

    def _floor_repair(self, l, starved, live, adj_l, act_mask,
                      m_rev) -> np.ndarray:
        """Re-add donor in-edges for nodes whose in-degree fell below the
        floor; donors = vanilla rows containing the starved node (stable
        lowest-id order, free slots only). Returns modified donor ids."""
        fin = self.final[l]
        act = np.nonzero(act_mask)[0]
        a = adj_l[act]
        # restrict the donor scan to rows that mention a starved node
        hit = np.isin(a, starved) & (a >= 0)
        rsel = np.nonzero(hit.any(axis=1))[0]
        a, hit = a[rsel], hit[rsel]
        tgts = a[hit].astype(np.int64)
        srcs = np.repeat(act[rsel], hit.sum(axis=1)).astype(np.int64)
        order = np.argsort(tgts, kind="stable")
        ts, rs = tgts[order], srcs[order]
        modified: list[int] = []
        big = np.iinfo(np.int32).max
        for u in starved:
            lo = np.searchsorted(ts, u)
            hi = np.searchsorted(ts, u, side="right")
            need = int(m_rev - live[u])
            for d in rs[lo:hi]:
                if need <= 0:
                    break
                row = fin[d]
                if (row == u).any():
                    continue
                free = np.nonzero(row < 0)[0]
                if not len(free):
                    continue
                row[free[0]] = u
                fin[d] = np.sort(np.where(row < 0, big, row))
                fin[d][fin[d] == big] = -1
                live[u] += 1
                need -= 1
                modified.append(int(d))
        return np.asarray(sorted(set(modified)), np.int64)
