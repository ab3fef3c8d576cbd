"""Relative-neighborhood (RNG) heuristic pruning (port of
hnsw_slim_tpu/graph/heuristic.py: prune_batch, prune_all,
prune_batch_guarded) on kernel Kγ.

Walk a base node's candidates in ascending distance; keep a candidate iff no
already-kept one is closer to it than the base is, until m are kept. The
guarded form (SlimZero) first keeps every candidate whose guard is set,
whatever the budget, and tests the others against all of those too.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..ops import cuda
from ..ops.distance import gathered_dist_plain

INF = float("inf")


def _prune_rows_plain(vectors, vn, base_ids, cand_ids, m, keep_all_under_m,
                      keep_pruned, w, metric, guard=None):
    """One chunk of rows, step for step as the JAX code (C x C pairwise
    distances, a scan over sorted positions, backfill, pack). With ``guard``
    (bool[b, C]) the scan is JAX's ``_prune_one_guarded``."""
    b, c = cand_ids.shape
    dev = cand_ids.device
    safe = cand_ids.clamp(min=0).long()
    base = base_ids.long()
    cand_d = gathered_dist_plain(vectors[base], vectors[safe], metric,
                                 qn=vn[base], vn=vn[safe])
    valid = (cand_ids >= 0) & (cand_ids != base_ids[:, None])
    masked = torch.where(valid, cand_d, INF)
    perm = torch.sort(masked, dim=1, stable=True).indices
    d_s = torch.gather(cand_d, 1, perm)
    v_s = torch.gather(valid, 1, perm)
    ids_s = torch.gather(cand_ids, 1, perm)
    safe_s = ids_s.clamp(min=0).long()
    cvecs_s = vectors[safe_s].float()
    cn_s = vn[safe_s]
    dots = torch.bmm(cvecs_s, cvecs_s.transpose(1, 2))
    pd = 1.0 - dots if metric == "ip" else (
        cn_s[:, :, None] + cn_s[:, None, :] - 2.0 * dots)
    if guard is None:
        kept = torch.zeros((b, c), dtype=torch.bool, device=dev)
        free = v_s
    else:
        # pass 1: every valid guarded candidate is kept, whatever the budget
        kept = torch.gather(guard, 1, perm) & v_s
        free = v_s & ~kept
    cnt = kept.sum(dim=1, dtype=torch.int32)
    for i in range(c):
        conflict = (kept & (pd[:, i, :] < d_s[:, i:i + 1])).any(dim=1)
        good = free[:, i] & (cnt < m) & ~conflict
        kept[:, i] |= good
        cnt += good.int()
    if keep_all_under_m:
        nvalid = v_s.sum(dim=1, dtype=torch.int32)
        under = nvalid < m
        kept = torch.where(under[:, None], v_s, kept)
        cnt = torch.where(under, nvalid, cnt)
    if keep_pruned:
        # backfill RNG-rejected candidates (nearest first) up to the budget
        lt = torch.arange(c, device=dev)[:, None] < torch.arange(
            c, device=dev)[None, :]
        eq = ids_s[:, :, None] == ids_s[:, None, :]
        dup = (eq & v_s[:, :, None] & lt[None]).any(dim=1)
        dup_of_kept = (eq & kept[:, :, None]).any(dim=1)
        fill_ok = v_s & ~kept & ~dup & ~dup_of_kept
        rank2 = torch.cumsum(fill_ok.int(), dim=1) - 1
        extra = fill_ok & (rank2 < (m - cnt)[:, None])
        kept = kept | extra
        cnt = cnt + extra.sum(dim=1, dtype=torch.int32)
    key = torch.where(kept, d_s, INF)
    ids2 = torch.where(kept, ids_s, -1)
    order = torch.sort(key, dim=1, stable=True).indices
    sel = torch.gather(ids2, 1, order)[:, :w]
    pos = torch.arange(sel.shape[1], device=dev)[None, :]
    sel = torch.where(pos < cnt[:, None], sel, -1)
    if sel.shape[1] < w:
        sel = torch.nn.functional.pad(sel, (0, w - sel.shape[1]), value=-1)
    return sel.to(torch.int32), cnt


SMEM_LIMIT = 232448  # shared memory one block can have (227 KB)
SMEM_STATIC = 2048  # bound on the kernel's static shared memory
RING = 32  # candidate rows Kγ stages at a time
STAGE_ALL = 64  # up to this many candidates, all are staged at once


class PrunePlan(NamedTuple):
    ring: int  # candidate rows staged at a time (C: all, in step 1)
    smem: int  # dynamic shared-memory bytes of a block
    threads: int = 256  # a block's: 128 for staged rows (short: more rows
    # in flight at the same 64 registers a thread)


@functools.lru_cache(maxsize=256)
def prune_plan(c: int, d: int, m_slots: int) -> PrunePlan:
    """Kγ's launch shape for C candidates of d elements and up to m_slots
    kept rows (C in the guarded mode): every candidate row staged (fp32
    whatever the store's type; a kept row is its staged row) when C <=
    STAGE_ALL and they fit, else two rings of RING rows (fewer than C),
    one walked while the next loads, beside m_slots kept rows, the rings
    halved until the block's shared memory holds them. Raises where even one ring
    row does not fit. The byte counts follow csrc/rng_prune.cu's layout."""
    sd = -(-d // 32) * 32 + 8  # row stride in floats (8 mod 32)
    cp = 1 << (max(c, 32) - 1).bit_length()
    fixed = 12 * cp + 12 * m_slots + cp
    if c <= STAGE_ALL:  # a kept row is a staged row: one row beside
        smem = 4 * sd * (c + 1) + fixed
        if smem + SMEM_STATIC <= SMEM_LIMIT:
            return PrunePlan(c, smem, 128)
    ring = min(RING, c - 1)  # fewer rows than C: two rings
    while ring >= 1:
        smem = 4 * sd * (2 * ring + m_slots) + fixed
        if smem + SMEM_STATIC <= SMEM_LIMIT:
            return PrunePlan(ring, smem)
        ring //= 2
    raise ValueError(f"rng_prune: C={c}, D={d} with {m_slots} kept rows "
                     f"needs more than {SMEM_LIMIT - SMEM_STATIC} B of "
                     "shared memory")


def rng_prune_plain(vectors, vn, base_ids, cand_ids, m_per_row, *,
                    keep_all_under_m: bool, keep_pruned: bool,
                    out_width: int, metric: str = "l2", guard=None):
    """Plain PyTorch Kγ: (sel i32[B, out_width], cnt i32[B]). Rows are
    processed in chunks that bound the [chunk, C, C] pairwise tensor."""
    b, c = cand_ids.shape
    chunk = max(1, (1 << 24) // max(1, c * c))
    sels, cnts = [], []
    for s in range(0, b, chunk):
        e = min(s + chunk, b)
        sel, cnt = _prune_rows_plain(
            vectors, vn, base_ids[s:e], cand_ids[s:e], m_per_row[s:e],
            keep_all_under_m, keep_pruned, out_width, metric,
            None if guard is None else guard[s:e])
        sels.append(sel)
        cnts.append(cnt)
    if not sels:
        return (torch.full((0, out_width), -1, dtype=torch.int32,
                           device=cand_ids.device),
                torch.zeros(0, dtype=torch.int32, device=cand_ids.device))
    return torch.cat(sels), torch.cat(cnts)


def rng_prune(vectors, vn, base_ids, cand_ids, m_per_row, *,
              keep_all_under_m: bool, keep_pruned: bool, out_width: int,
              metric: str = "l2", m_max: int | None = None, guard=None):
    """Kγ: RNG prune of cand_ids i32[B, C] (-1 = no candidate) around
    base_ids i32[B] with budgets m_per_row i32[B]. Returns (sel
    i32[B, out_width] in ascending distance, -1 padded; cnt i32[B]).
    CUDA tensors run csrc/rng_prune.cu, CPU tensors the plain version.
    ``m_max``, a bound on m_per_row known to the caller, sizes the kernel's
    shared memory without reading m_per_row back from the card. ``guard``
    (bool[B, C]) selects the guarded mode: guarded candidates are kept
    first and past the budget, so the kept rows are staged for up to C and
    cnt may exceed m_per_row; it excludes the early-out and the backfill."""
    if guard is not None and (keep_all_under_m or keep_pruned):
        raise ValueError("rng_prune: the guarded mode has no early-out and "
                         "no backfill")
    if not cand_ids.is_cuda:
        return rng_prune_plain(
            vectors, vn, base_ids, cand_ids, m_per_row,
            keep_all_under_m=keep_all_under_m, keep_pruned=keep_pruned,
            out_width=out_width, metric=metric, guard=guard)
    b, c = cand_ids.shape
    d = vectors.shape[1]
    cuda.require(vectors, cuda.ROW_TYPES, "vectors", (-1, d))
    cuda.require(vn, torch.float32, "vn", (vectors.shape[0],))
    cuda.require(base_ids, torch.int32, "base_ids", (b,))
    cuda.require(cand_ids, torch.int32, "cand_ids", (b, c))
    cuda.require(m_per_row, torch.int32, "m_per_row", (b,))
    sel = torch.empty((b, out_width), dtype=torch.int32, device=cand_ids.device)
    cnt = torch.empty((b,), dtype=torch.int32, device=cand_ids.device)
    if b == 0:
        return sel, cnt
    if c == 0:
        return sel.fill_(-1), cnt.zero_()
    if guard is not None:
        cuda.require(guard, torch.bool, "guard", (b, c))
        m_slots = c
    else:
        m_slots = max(1, int(min(
            int(m_per_row.max()) if m_max is None else m_max, c)))
    plan = prune_plan(c, d, m_slots)
    entry, modes = cuda.row_type(vectors, "rng_prune",
                                 () if guard is None else ("guarded",))
    cuda.launch(
        "rng_prune", vectors.data_ptr(), vn.data_ptr(), d, base_ids.data_ptr(),
        cand_ids.data_ptr(), m_per_row.data_ptr(), b, c, m_slots,
        int(keep_all_under_m), int(keep_pruned), out_width,
        int(metric == "ip"), None if guard is None else guard.data_ptr(),
        plan.ring, plan.threads, plan.smem, sel.data_ptr(),
        cnt.data_ptr(), entry=entry, modes=modes,
        shape=("guarded" if guard is not None else "keep_all"
               if keep_all_under_m else "budget")
        + ("+backfill" if keep_pruned else "") + f" C{c}",
    )
    return sel, cnt


def prune_batch(vectors, vn, base_ids, cand_ids, valid, *, M: int,
                keep_all_under_m: bool, metric: str = "l2",
                out_width: int = 0, m_per_row=None, keep_pruned: bool = False):
    """Heuristic-prune candidate lists for a batch of base nodes. Returns
    (sel i32[B, out_width or M], cnt i32[B])."""
    cand = torch.where(valid, cand_ids, -1).to(torch.int32).contiguous()
    if m_per_row is None:
        m_per_row = torch.full((cand.shape[0],), M, dtype=torch.int32,
                               device=cand.device)
    return rng_prune(
        vectors, vn, base_ids.to(torch.int32).contiguous(), cand,
        m_per_row.to(torch.int32).contiguous(),
        keep_all_under_m=keep_all_under_m, keep_pruned=keep_pruned,
        out_width=out_width or M, metric=metric)


def prune_batch_guarded(vectors, vn, base_ids, cand_ids, valid, guard, *,
                        M: int, metric: str = "l2", out_width: int = 0,
                        m_per_row=None):
    """SlimZero's guarded prune: candidates whose ``guard`` (bool[B, C]: the
    candidate's in-degree is at the floor) is set are always kept; the RNG
    rule fills the rest up to the budget. Returns (sel i32[B, out_width or
    M], cnt i32[B])."""
    cand = torch.where(valid, cand_ids, -1).to(torch.int32).contiguous()
    if m_per_row is None:
        m_per_row = torch.full((cand.shape[0],), M, dtype=torch.int32,
                               device=cand.device)
    return rng_prune(
        vectors, vn, base_ids.to(torch.int32).contiguous(), cand,
        m_per_row.to(torch.int32).contiguous(), keep_all_under_m=False,
        keep_pruned=False, out_width=out_width or M, metric=metric,
        guard=guard.contiguous())


def prune_all(vectors, vn, base_ids, cand_ids, m_per_row, *, M: int,
              keep_all_under_m: bool, metric: str = "l2", out_width: int = 0,
              keep_pruned: bool = False):
    """Whole-array heuristic prune (candidates -1 padded). Returns sel."""
    return prune_batch(
        vectors, vn, base_ids, cand_ids, cand_ids >= 0, M=M,
        keep_all_under_m=keep_all_under_m, metric=metric,
        out_width=out_width, m_per_row=m_per_row, keep_pruned=keep_pruned,
    )[0]
