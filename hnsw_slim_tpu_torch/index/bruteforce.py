"""Exact k-NN (port of hnsw_slim_tpu/index/bruteforce.py) on kernel Kα.

``topk_dist`` is the fused distance + running top-k that replaces the JAX
programs ``_bf_topk`` / ``exact_topk`` (a chunked distance matmul feeding a
running ``lax.top_k``), the exact seed block of ``chal_search`` and the
subset kNN of the NND build. Results are ordered by (distance, position):
equal distances put the lower row first, as ``lax.top_k`` does.
``topk_dist_strata`` is its stratified form, the seed block of
``chal_search`` with ``seed_strata`` > 1. Both take fp32 or bfloat16 rows
(a bfloat16 store, or the seed table gathered from one). ``topk_estimate``
is its estimate mode, the seed block of the SlimQ search: the same scan and
running top-k over the 1-bit RaBitQ estimates of a table of packed code
rows. ``scan_plan`` picks each launch's tile shape, row splits and shared
memory from the call's shape (a pure function, tested on the CPU). On the
card k is at most MAX_K = 128, the longest top-k list a scan keeps; a
launch whose lists take 128 slots (k > 64) is counted as the ``k128`` mode.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import cuda
from ..ops.distance import pairwise_dist, sq_norms
from ..quant.estimator import QuantScorer, unpack_bits, unpack_fields

INF = float("inf")


def topk_dist_plain(q, x, xn, k: int, metric: str = "l2", n_valid: int = -1,
                    row_ids=None, self_offset: int = -1, chunk: int = 65536,
                    qn=None):
    """Plain PyTorch Kα: (d f32[B, k], pos i32[B, k]) over rows of x.

    Rows at or past n_valid (-1 = all rows valid), rows whose ``row_ids``
    entry is negative, and (self_offset >= 0) row self_offset + i for query i
    are masked. Missing results are (inf, -1). ``qn``: the queries' squared
    norms where the caller has them (else ``sq_norms(q)``)."""
    b, n = q.shape[0], x.shape[0]
    nv = n if n_valid < 0 else n_valid
    if qn is None:
        qn = sq_norms(q)
    best_d = torch.full((b, k), INF, device=q.device)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=q.device)
    qi = torch.arange(b, device=q.device)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        d = pairwise_dist(q, x[s:e], metric, qn=qn, xn=xn[s:e])
        pos = torch.arange(s, e, dtype=torch.int32, device=q.device)
        mask = pos >= nv
        if row_ids is not None:
            mask = mask | (row_ids[s:e] < 0)
        d = torch.where(mask[None, :], INF, d)
        if self_offset >= 0:
            col = self_offset + qi - s
            hit = (col >= 0) & (col < e - s)
            d[qi[hit], col[hit]] = INF
        cat_d = torch.cat([best_d, d], dim=1)
        cat_i = torch.cat([best_i, pos[None, :].expand(b, -1)], dim=1)
        sd, order = torch.sort(cat_d, dim=1, stable=True)
        best_d = sd[:, :k]
        best_i = torch.gather(cat_i, 1, order[:, :k])
    return best_d, best_i


SMEM_MAX = 232448  # dynamic shared bytes one block may take (H100)
SM_SMEM = 233472  # shared bytes of one SM
# the scan's tile shapes (csrc/topk_dist.cu): name -> (C id, queries, rows)
SCAN_TILES = {"L": (0, 128, 128), "M": (1, 64, 128), "U": (2, 16, 128),
              "T": (3, 64, 32)}
MAX_SPLITS = 256
MAX_K = 128  # the longest top-k list a scan keeps (csrc/topk_dist.cu)


def list_slots(k: int) -> int:
    """Slots of a query's top-k list in the scan's shared memory."""
    return 32 if k <= 32 else 64 if k <= 64 else 128


def _check_k(k: int, what: str) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"{what}: k={k} outside [1, {MAX_K}]: a scan "
                         f"keeps top-k lists of at most {MAX_K}")


class ScanPlan(NamedTuple):
    """One Kα launch: tile shape, row splits (grid.y), dynamic shared
    bytes a block, blocks that fit on one SM at those bytes, and the dims
    of the query tile a block holds at once (d padded to a multiple of 32
    when it is resident; fewer: staged in chunks of that many)."""

    tile: str
    splits: int
    smem: int
    blocks_per_sm: int
    qdims: int


def scan_smem(tile: str, d: int, k: int, c: int = 0,
              qdims: int | None = None) -> int:
    """Shared bytes of one scan block: the query tile (``qdims`` dims; by
    default all d, padded to a multiple of 32), the two slab buffers or the
    distance tile over them, the top-k lists (32, 64 or 128 slots a query:
    ``list_slots``), the thresholds and pass flags, and in estimate mode
    the tile's g_add rows (c centroids). The kernel holds as many whole
    32-dim slabs of the query tile as these bytes leave room for."""
    _, bq, bn = SCAN_TILES[tile]
    dq = -(-d // 32) * 32 if qdims is None else qdims
    kl = list_slots(k)
    u = -(-max(2 * 32 * bn, bq * (bn + 1)) // 4) * 4
    return 4 * (dq * bq + u + 2 * bq * kl + 3 * bq + bq * c)


def scan_plan(b: int, n: int, d: int, k: int, sms: int, *, strata: int = 0,
              c: int = 0) -> ScanPlan:
    """The launch plan of a Kα scan of b queries over n rows of d dims (k
    results a query; ``strata`` segments, one split each; ``c`` centroids
    in estimate mode) on a card of ``sms`` SMs.

    Tile: T (64 queries x 32 rows) for tables of at most 32 rows, large
    batches and k <= 64 (the KMeans assignment); above 64 queries L (128 x
    128, one block an SM, the most FMAs a shared load) for k <= 16, else M
    (64 x 128, two blocks an SM, so one block's top-k fold overlaps the
    other's FMAs; one with 128-slot lists); U (16 x 128) for at most 64
    queries. Only M and U take 128-slot lists. A tile whose resident
    query tile does not fit gives way to the next one; where none fits
    (wide rows), U stages its query tile in chunks of ``qdims`` dims, as
    many as leave two blocks an SM (the only tile compiled to do so).
    Splits: the count
    with the least modelled time, the busiest SM's work (its blocks times
    the row tiles a split holds) over its throughput (0.6 of the FMA rate
    with one block resident, all of it with two), plus the merge of the
    per-split lists; batches of at most 64 queries get a block on every SM
    where the rows allow. k above MAX_K raises."""
    _check_k(k, "scan_plan")
    big = "L" if k <= 16 else "M"
    if n <= 32 and b >= 1024 and k <= 64:
        order = "T" + big + "U"
    else:
        order = big + "U" if b > 64 else "U"
    qdims = -(-d // 32) * 32
    for tile in order:
        smem = scan_smem(tile, d, k, c)
        if smem <= SMEM_MAX:
            break
    else:  # tile is U: chunks that leave two blocks an SM
        rest = scan_smem(tile, 0, k, c)
        qdims = (SM_SMEM // 2 - 1024 - rest) // (4 * 16 * 32) * 32
        if qdims < 32:
            raise ValueError(f"topk_dist: the scan's lists and g_add rows "
                             f"(k={k}, {c} centroids) leave no shared "
                             f"memory for the queries")
        smem = scan_smem(tile, d, k, c, qdims)
    _, bq, bn = SCAN_TILES[tile]
    bps = max(1, min(8, SM_SMEM // (smem + 1024)))
    if strata:
        return ScanPlan(tile, strata, smem, bps, qdims)
    qt = -(-b // bq)
    tiles = max(1, -(-n // bn))
    tile_clk = bq * bn * (-(-d // 32) * 32) / 128
    hi = min(tiles, MAX_SPLITS)
    lo = min(-(-sms // qt), hi) if b <= 64 and qt * tiles >= sms else 1
    best = None
    for s in range(lo, hi + 1):
        per = -(-(-(-n // s)) // bn)
        nb = -(-qt * s // sms)
        work = nb * per * tile_clk / min(1.0, 0.6 * min(nb, bps))
        merge = 0 if s == 1 else s * -(-k // 32) * 60 * -(-b // (sms * 16))
        cost = work + merge
        if best is None or cost < 0.98 * best[0]:
            best = (cost, s)
    return ScanPlan(tile, best[1], smem, bps, qdims)


def _plan(q: torch.Tensor, n: int, k: int, **kw) -> ScanPlan:
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    return scan_plan(q.shape[0], n, q.shape[1], k, sms, **kw)


def _query_norms(q, qn):
    """The queries' squared norms for a scan launch: the caller's, checked,
    or Kξ's."""
    if qn is None:
        return sq_norms(q)
    cuda.require(qn, torch.float32, "qn", (q.shape[0],))
    return qn


def topk_dist(q, x, xn, k: int, metric: str = "l2", n_valid: int = -1,
              row_ids=None, self_offset: int = -1, qn=None):
    """Kα: fused distance + top-k (see topk_dist_plain for the semantics;
    ``qn`` as there: a caller that holds the queries' norms saves Kξ's
    launch). CUDA tensors run the kernel (csrc/topk_dist.cu), CPU tensors
    the plain version."""
    if not q.is_cuda:
        return topk_dist_plain(q, x, xn, k, metric, n_valid, row_ids,
                               self_offset, qn=qn)
    b, d = q.shape
    n = x.shape[0]
    _check_k(k, "topk_dist")
    cuda.require(q, torch.float32, "q", (-1, -1))
    cuda.require(x, cuda.ROW_TYPES, "x", (-1, d))
    cuda.require(xn, torch.float32, "xn", (n,))
    if row_ids is not None:
        cuda.require(row_ids, torch.int32, "row_ids", (n,))
    qn = _query_norms(q, qn)
    out_d = torch.empty((b, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=q.device)
    if b == 0:
        return out_d, out_i
    plan = _plan(q, n, k)
    part_d = torch.empty((plan.splits, b, k), dtype=torch.float32,
                         device=q.device)
    part_i = torch.empty((plan.splits, b, k), dtype=torch.int32,
                         device=q.device)
    kth = torch.empty((b,), dtype=torch.int64, device=q.device)
    entry, modes = cuda.row_type(x, "topk_dist",
                                 ("k128",) if k > 64 else ())
    cuda.launch(
        "topk_dist", q.data_ptr(), qn.data_ptr(), x.data_ptr(), xn.data_ptr(),
        None if row_ids is None else row_ids.data_ptr(), b, n, d,
        n if n_valid < 0 else n_valid, self_offset, k, int(metric == "ip"),
        SCAN_TILES[plan.tile][0], plan.splits, plan.smem, part_d.data_ptr(),
        part_i.data_ptr(), kth.data_ptr(), out_d.data_ptr(),
        out_i.data_ptr(), entry=entry, modes=modes,
        shape=f"{plan.tile} k{k}",
    )
    return out_d, out_i


def strata_shape(n: int, seed_width: int, strata: int) -> tuple[int, int]:
    """(rows per segment, seeds per segment) of a stratified seed scan over
    an n-row table."""
    if strata < 1 or n % strata:
        raise ValueError(f"seed table of {n} rows does not split into "
                         f"{strata} equal segments")
    return n // strata, max(1, seed_width // strata)


def topk_dist_strata_plain(q, x, xn, row_ids, seed_width: int, strata: int,
                           metric: str = "l2", qn=None):
    """Plain PyTorch stratified seeds, as the JAX code takes them: the table
    is cut into ``strata`` equal segments, each gives its
    seed_width // strata nearest rows (repeated argmin, lowest row first on
    equal distance; rows with a negative ``row_ids`` entry masked), and the
    picks are sorted by distance, stably in segment-major order. Returns
    (d f32[B, S], ids i32[B, S]) with S = strata * (seed_width // strata);
    ids come from ``row_ids``, -1 where the distance is inf. ``qn`` as in
    topk_dist_plain."""
    b, n = q.shape[0], x.shape[0]
    u, sps = strata_shape(n, seed_width, strata)
    dmat = pairwise_dist(q, x, metric, qn=sq_norms(q) if qn is None else qn,
                         xn=xn)
    d3 = torch.where((row_ids >= 0)[None, :], dmat, INF).reshape(b, strata, u)
    sds, poss = [], []
    for _ in range(sps):
        sd = d3.min(dim=2).values
        # the lowest position among equal minima
        am = torch.where(d3 == sd[:, :, None],
                         torch.arange(u, device=q.device), u).min(dim=2).values
        sds.append(sd)
        poss.append(am)
        d3 = d3.scatter(2, am[:, :, None], INF)
    sd = torch.stack(sds, dim=2).reshape(b, strata * sps)
    pos = torch.stack(poss, dim=2) + (
        torch.arange(strata, device=q.device) * u)[None, :, None]
    si = row_ids[pos.reshape(b, strata * sps)]
    sd, order = torch.sort(sd, dim=1, stable=True)
    si = torch.gather(si, 1, order)
    return sd, torch.where(torch.isinf(sd), -1, si).to(torch.int32)


def topk_dist_strata(q, x, xn, row_ids, seed_width: int, strata: int,
                     metric: str = "l2", qn=None):
    """Kα in strata mode (see topk_dist_strata_plain): one scan split per
    segment, then an in-kernel stable sort of the picks. CUDA tensors run
    the kernel (csrc/topk_dist.cu), CPU tensors the plain version."""
    if not q.is_cuda:
        return topk_dist_strata_plain(q, x, xn, row_ids, seed_width, strata,
                                      metric, qn=qn)
    b, d = q.shape
    n = x.shape[0]
    _, sps = strata_shape(n, seed_width, strata)
    if sps > 64 or strata * sps > 1024:
        raise ValueError(f"topk_dist_strata: {sps} seeds per segment (max "
                         f"64), {strata * sps} in all (max 1024)")
    cuda.require(q, torch.float32, "q", (-1, -1))
    cuda.require(x, cuda.ROW_TYPES, "x", (-1, d))
    cuda.require(xn, torch.float32, "xn", (n,))
    cuda.require(row_ids, torch.int32, "row_ids", (n,))
    qn = _query_norms(q, qn)
    out_d = torch.empty((b, strata * sps), dtype=torch.float32,
                        device=q.device)
    out_i = torch.empty((b, strata * sps), dtype=torch.int32, device=q.device)
    if b == 0:
        return out_d, out_i
    plan = _plan(q, n, sps, strata=strata)
    part_d = torch.empty((strata, b, sps), dtype=torch.float32,
                         device=q.device)
    part_i = torch.empty((strata, b, sps), dtype=torch.int32, device=q.device)
    entry, modes = cuda.row_type(x, "topk_strata", ("strata",))
    cuda.launch(
        "topk_dist", q.data_ptr(), qn.data_ptr(), x.data_ptr(), xn.data_ptr(),
        row_ids.data_ptr(), b, n, d, sps, strata, int(metric == "ip"),
        SCAN_TILES[plan.tile][0], plan.smem, part_d.data_ptr(),
        part_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), entry=entry,
        modes=modes, shape=f"strata {plan.tile} k{sps}",
    )
    return out_d, out_i


def topk_estimate_plain(sc: QuantScorer, row_ids, k: int):
    """Plain PyTorch Kα in estimate mode: (est f32[B, k], pos i32[B, k]),
    the k table rows (``sc.rows``, packed code rows) with the smallest 1-bit
    estimate f_add + g_add[query, cluster] + f_rescale * (<q_rot, bits> -
    sumq / 2) — always the 1-bit factors, whatever ``sc.use_ex`` — lower row
    first on equal estimates; rows whose ``row_ids`` entry is negative are
    masked. Missing results are (inf, -1)."""
    bc, _, fa, fr, _, _, cid = unpack_fields(sc.rows, sc.nb, sc.ex_bits)
    ip = sc.q_rot @ unpack_bits(bc).T
    est = fa[None, :] + sc.g_add[:, cid.long()] + fr[None, :] * (
        ip - 0.5 * sc.sumq[:, None])
    est = torch.where((row_ids >= 0)[None, :], est, INF)
    sd, order = torch.sort(est, dim=1, stable=True)
    k_have = min(k, est.shape[1])
    out_d = torch.full((est.shape[0], k), INF, device=est.device)
    out_i = torch.full((est.shape[0], k), -1, dtype=torch.int32,
                       device=est.device)
    out_d[:, :k_have] = sd[:, :k_have]
    out_i[:, :k_have] = order[:, :k_have].to(torch.int32)
    return out_d, torch.where(torch.isinf(out_d), -1, out_i)


def topk_estimate(sc: QuantScorer, row_ids, k: int):
    """Kα in estimate mode (see topk_estimate_plain): CUDA tensors run the
    kernel (csrc/topk_dist.cu), CPU tensors the plain version. Neither the
    unpacked bit planes nor the [B, rows] estimates are materialised on the
    card."""
    if not sc.q_rot.is_cuda:
        return topk_estimate_plain(sc, row_ids, k)
    b = sc.q_rot.shape[0]
    n = sc.rows.shape[0]
    _check_k(k, "topk_estimate")
    sargs = sc.args()
    cuda.require(row_ids, torch.int32, "row_ids", (n,))
    dev = sc.q_rot.device
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return out_d, out_i
    plan = _plan(sc.q_rot, n, k, c=int(sc.g_add.shape[1]))
    part_d = torch.empty((plan.splits, b, k), dtype=torch.float32,
                         device=dev)
    part_i = torch.empty((plan.splits, b, k), dtype=torch.int32, device=dev)
    kth = torch.empty((b,), dtype=torch.int64, device=dev)
    cuda.launch(
        "topk_dist", *sargs[:4], *sargs[5:], row_ids.data_ptr(), b, n, k,
        SCAN_TILES[plan.tile][0], plan.splits, plan.smem, part_d.data_ptr(),
        part_i.data_ptr(), kth.data_ptr(), out_d.data_ptr(),
        out_i.data_ptr(), entry="topk_estimate",
        modes=("estimate",) + (("k128",) if k > 64 else ()),
        shape=f"estimate {plan.tile} k{k}")
    return out_d, out_i


class BruteForceIndex:
    """Exact search over a flat vector array held on ``device``.

    ``chunk`` keeps the JAX signature (its row chunk of the scan); here the
    scan is one Kα launch over all rows, so it changes no pass and no
    result. k is at most MAX_K on the card."""

    def __init__(self, vectors: np.ndarray, metric: str = "l2",
                 chunk: int = 65536, device=None):
        self.metric = metric
        self.device = cuda.resolve_device(device)
        self.x = torch.as_tensor(np.asarray(vectors, np.float32),
                                 device=self.device)
        self.n, self.dim = self.x.shape
        self.xn = sq_norms(self.x)

    def search(self, queries: np.ndarray, k: int, batch: int = 8192):
        """(dists f32[B, k], ids i32[B, k]) exact top-k as numpy arrays."""
        q = np.asarray(queries, np.float32)
        if q.shape[0] == 0:
            return np.zeros((0, k), np.float32), np.zeros((0, k), np.int32)
        outs_d, outs_i = [], []
        for s in range(0, q.shape[0], batch):
            d, i = exact_topk(self.x, self.xn,
                              torch.as_tensor(q[s:s + batch], device=self.device),
                              k, self.metric)
            outs_d.append(d.cpu().numpy())
            outs_i.append(i.cpu().numpy())
        return np.concatenate(outs_d), np.concatenate(outs_i)


def exact_topk(x, xn, q, k: int, metric: str = "l2", n_valid: int = 0):
    """Exact top-k against an already-resident vector table; n_valid > 0
    masks trailing padded rows. Returns (dists f32[B, k], ids i32[B, k])."""
    return topk_dist(q, x, xn, k, metric, n_valid=n_valid or -1)
