"""HNSW-SlimQ (port of hnsw_slim_tpu/index/slimq.py): the pruned CHAL graph
over RaBitQ codes, no raw vectors stored.

* build: KMeans-16 centroids and cluster ids (Kα with k = 1), a graph built
  from raw distances and pruned exactly like Slim, then per node a quantized
  payload [1-bit code, ex code, factors, cluster id] of the FHT-rotated
  vector (Kη) — no raw vector.
* search (``slimq_search``): rotate the queries (Kη), build the per-centroid
  g_add table, take seeds from the 1-bit estimates to every level>=1 node
  (Kα in estimate mode) or descend greedily on estimates (Kε), beam on 1-bit
  or full-code estimates over one packed code row per candidate (Kβ), and
  rerank every popped node against the external dataset during the
  traversal (Kβ's rerank track): with a dataset the results are the track's
  first k with exact distances, without one (or ``rerank=False``) the
  estimate-ranked buffer's.

Not ported, as for the Slim index: straggler compaction
(``straggler_stages``) and ``dynamic_ef``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import HnswConfig, QuantConfig, SearchConfig, SlimConfig
from ..graph import search as gs
from ..graph.prune import convert_to_slim
from ..graph.types import ChalGraph
from ..ops import cuda
from ..quant.estimator import QuantScorer
from ..quant.estimator import unpack_fields as _unpack_fields  # noqa: F401
from ..quant.kmeans import kmeans
from ..quant.rabitq import QuantizedCodes, quantize_batch
from ..quant.rotator import FhtKacRotator, g_tables, pad_dim
from ..utils import trace
from . import replay
from .bruteforce import MAX_K, scan_plan, topk_estimate
from .hnsw import HnswIndex, LastStats
from .slim import HnswSlimIndex


def pack_code_rows(codes: QuantizedCodes, cluster_ids) -> torch.Tensor:
    """One row of u32 words per node, held as i32[N, R]: [bin (P/32 w) | ex
    (ex_bits*P/32 w) | f_add | f_rescale | f_add_ex | f_rescale_ex (f32
    bits) | cluster_id]. Everything the estimator needs for a candidate
    comes with one row gather (84 B at P = 128 and 4 bits)."""
    n = codes.bin_code.shape[0]
    parts = [codes.bin_code]
    if codes.ex_bits:
        parts.append(codes.ex_planes.reshape(n, -1))
    parts.append(torch.stack(
        [codes.f_add, codes.f_rescale, codes.f_add_ex, codes.f_rescale_ex],
        dim=1).view(torch.int32))
    parts.append(cluster_ids.to(torch.int32)[:, None])
    return torch.cat(parts, dim=1).contiguous()


def check_centroids(n_clusters: int, dim: int, k: int) -> None:
    """Raise ValueError when the SlimQ seed scan (Kα's estimate mode: k
    seeds over ``dim`` rotated dims) cannot place the g_add rows of
    ``n_clusters`` centroids in a block's shared memory (``scan_plan``);
    the message names the most centroids that fit. The index calls it on
    a CUDA device before any work."""
    def fits(c: int) -> bool:
        try:
            scan_plan(1, 1, dim, k, 1, c=c)
        except ValueError:
            return False
        return True

    if fits(n_clusters):
        return
    lo, hi = 0, n_clusters - 1  # the most that fit lies in [lo, hi]
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid - 1)
    raise ValueError(
        f"SlimQ: {n_clusters} centroids do not fit the seed scan's shared "
        f"memory at {dim} rotated dims and k={k}: at most {lo}")


def slimq_search(nbr, lvl_off, entry, q_rot, packed, centroids_rot, dataset,
                 q_raw, *, nb: int, ex_bits: int, max_level: int,
                 threshold_level: int, cap0: int, cap: int, ef: int, k: int,
                 max_iters: int, metric: str, use_ex: bool,
                 pop_width: int = 1, dense0=None, dense_up=None, rank_up=None,
                 scan_width: int = 0, seed_width: int = 0, up_rows=None,
                 up_ids=None, up_count: int = 0):
    """The SlimQ query path (JAX ``_slimq_search_jit``).

    ``q_rot`` f32[B, P] rotated queries, ``packed`` the packed code rows,
    ``dataset`` / ``q_raw`` the raw vectors and queries of the rerank track
    (None, None: estimate-only). Seeds: with ``seed_width`` > 1 at threshold
    level 0 and a seed table (``up_rows`` the packed rows of all level>=1
    nodes, ``up_ids`` their ids, -1 padded, ``up_count`` of them real), the
    min(seed_width, ef) lowest 1-bit estimates over the table; else greedy
    descent on estimates over levels max_level..threshold_level+1. Then
    ``gs.base_beam``, the rerank track carried beside the buffer. Returns
    (dists, ids, hops i32[B], dcomp i32[B]): with a dataset the track
    (kk = max(k, 16) wide, exact distances), else the buffer (estimates);
    callers keep the first k.
    dcomp counts the estimates of the beams and of the seed scan, not the
    rerank distances. The track computes one exact distance a pop, so the
    rerank distances are the beams' hops: the counter
    ``index.rerank_dcomp``."""
    P = gs.buffer_width(ef)
    b = q_rot.shape[0]
    dev = q_rot.device
    fetch = gs.slim_fetch(nbr, lvl_off, cap0, cap, dense0, dense_up, rank_up)
    seed_width = min(seed_width, P)
    table = (seed_width > 1 and threshold_level == 0 and max_level >= 1
             and up_rows is not None)
    trace.count("index.queries", b)
    # up to the base beam: the Kα estimate scan, or the Kε descent
    with trace.span("index.seed" if table else "index.descent"):
        sumq, g_add = g_tables(q_rot, centroids_rot, metric)
        scorer = QuantScorer(packed, nb, ex_bits, use_ex, q_rot, sumq, g_add)
        # the seed scan estimates a distance to every real row of the table
        hops, dcomp = 0, up_count if table else 0
        if table:
            sd, pos = topk_estimate(
                scorer._replace(rows=up_rows, use_ex=False), up_ids,
                seed_width)
            buf_id = torch.where(pos >= 0, up_ids[pos.clamp(min=0).long()],
                                 -1)
            buf_d = sd.contiguous()
            buf_id = buf_id.to(torch.int32).contiguous()
        else:
            cur = torch.full((b,), int(entry), dtype=torch.int32, device=dev)
            # one Kε launch scores the entry point, then descends (no level:
            # the entry's estimate only)
            cur, curdist, _, _ = gs.greedy_descent_levels(
                None, None, None,
                [fetch(l) for l in range(max_level, threshold_level, -1)],
                max_level, cur, None, scorer=scorer)
            buf_d = curdist[:, None].contiguous()
            buf_id = cur[:, None].contiguous()
        beam = dict(scorer=scorer)
        if dataset is not None:
            beam["pop_track"] = gs.pop_track_init(dataset, q_raw, max(k, 16),
                                                  metric)
    buf_d, buf_id, hops, dcomp, beam = gs.base_beam(
        fetch, None, None, None, buf_d, buf_id, hops, dcomp,
        threshold_level=threshold_level, max_level=max_level, P=P, ef=ef, k=P,
        pop_width=pop_width, scan_width=scan_width, max_iters=max_iters,
        metric=metric, **beam)
    if dataset is None:
        return buf_d, buf_id, hops, dcomp
    trace.count("index.rerank_dcomp", hops)
    return beam["pop_track"].d, beam["pop_track"].ids, hops, dcomp


class HnswSlimQIndex:
    """Quantized Slim index whose graph and codes live on ``device``. Raw
    vectors are not stored; the exact rerank uses the dataset given to
    ``set_dataset`` (or kept by ``build``)."""

    last_stats = LastStats()

    def __init__(self, metric: str = "l2",
                 search_cfg: SearchConfig | None = None, device=None):
        self.metric = metric
        self.scfg = search_cfg or SearchConfig()
        self.device = cuda.resolve_device(device)
        self.graph: ChalGraph | None = None
        self.codes: QuantizedCodes | None = None
        self.rotator: FhtKacRotator | None = None
        self.cluster_ids = None  # i32[N]
        self.centroids_rot = None  # f32[C, P]
        self.dataset = None  # external raw vectors for the rerank (host)
        self._dataset_dev = None
        self._packed = None  # pack_code_rows, made at the first search
        # seed table over level>=1 nodes (scfg.seed_width > 1): their packed
        # rows and ids, keyed by the graph object it was built for
        self.up_rows = self.up_ids = None
        self.up_count = 0
        self._up_for = None
        self.use_ex = False
        # dense serving layouts: SlimQ's graph is a plain ChalGraph, so
        # HnswSlimIndex's densify methods serve it (borrowed below)
        self.dense0 = None
        self.dense_up: tuple | None = None
        self.rank_up = None
        self._rank_np = None
        self._n_up = 0
        self.host_chal: dict | None = None
        self._replay = replay.Replay()
        self.last_stats: dict = {}
        self.build_stats: dict = {}

    def _check_centroids(self, n_clusters: int, dim: int) -> None:
        """check_centroids at this index's seed width (at least one seed),
        on a CUDA device."""
        if self.device.type == "cuda":
            check_centroids(n_clusters, pad_dim(dim),
                            min(max(1, self.scfg.seed_width), MAX_K))

    densify_level0 = HnswSlimIndex.densify_level0
    densify_upper = HnswSlimIndex.densify_upper
    _host_chal = HnswSlimIndex._host_chal
    _dev = HnswSlimIndex._dev
    # the seed table's ids and the reads both Slim chains share
    _seed_ids = HnswSlimIndex._seed_ids
    _seeded = HnswSlimIndex._seeded
    _serving = HnswSlimIndex._serving

    @classmethod
    def build(cls, vectors: np.ndarray, hnsw_cfg: HnswConfig | None = None,
              slim_cfg: SlimConfig | None = None,
              quant_cfg: QuantConfig | None = None, keep_dataset: bool = True,
              verbose: bool = False, strategy: str = "auto",
              max_batch: int = 4096, device=None) -> "HnswSlimQIndex":
        """KMeans -> HNSW build -> Slim conversion -> rotation -> RaBitQ
        quantization. ``build_stats`` holds the seconds of each step, each
        also a span (``slimq.hnsw``, ``.convert``, ``.kmeans``, ``.rotate``,
        ``.quantize``).

        KMeans, the rotation and the rerank's device rows read the vector
        store the graph was built on: with ``store_dtype="bfloat16"`` its
        rows widened to fp32 (the kernels take fp32 rows there), so the
        codes and the reranked distances are those of the rounded
        vectors."""
        hnsw_cfg = hnsw_cfg or HnswConfig()
        slim_cfg = slim_cfg or SlimConfig.from_ratios()
        quant_cfg = quant_cfg or QuantConfig()
        vectors = np.asarray(vectors, np.float32)
        idx = cls(metric=hnsw_cfg.metric, device=device)
        idx._check_centroids(quant_cfg.num_clusters, vectors.shape[1])
        sync = torch.cuda.synchronize if idx.device.type == "cuda" \
            else (lambda: None)
        split = {}
        # graph from raw distances, pruned exactly like Slim
        with trace.phase("slimq.hnsw", split, "hnsw_s"):
            hnsw = HnswIndex(hnsw_cfg, strategy=strategy,
                             max_batch=max_batch, device=idx.device)
            hnsw.build(vectors, verbose=verbose)
            sync()
        with trace.phase("slimq.convert", split, "convert_s"):
            idx.graph = convert_to_slim(
                hnsw.graph, hnsw.vectors, hnsw.vn, slim_cfg,
                metric=hnsw_cfg.metric, verbose=verbose)
            sync()
        store = hnsw.vectors.float()  # the resident store (no copy in fp32)
        # KMeans-16 centroids + assignment
        with trace.phase("slimq.kmeans", split, "kmeans_s"):
            centroids, asn = kmeans(store, k=quant_cfg.num_clusters,
                                    iters=quant_cfg.kmeans_iters)
            sync()
        with trace.phase("slimq.rotate", split, "rotate_s"):
            idx.rotator = FhtKacRotator(vectors.shape[1], seed=hnsw_cfg.seed,
                                        device=idx.device)
            rotated = idx.rotator.rotate(store).cpu().numpy()
            cent_rot = idx.rotator.rotate(centroids)
            sync()
        with trace.phase("slimq.quantize", split, "quantize_s"):
            idx.codes = quantize_batch(
                rotated, cent_rot.cpu().numpy(), asn, quant_cfg.ex_bits,
                metric=hnsw_cfg.metric, device=idx.device)
            idx.cluster_ids = idx._dev(asn.astype(np.int32))
            idx.centroids_rot = cent_rot.contiguous()
            sync()
        idx.build_stats = split
        if keep_dataset:
            idx.dataset = vectors
            idx._dataset_dev = store
        return idx

    @classmethod
    def from_numpy(cls, *, nbr, lvl_off, level, entry: int, max_level: int,
                   threshold_level: int, cap0: int, cap: int, codes: dict,
                   ex_bits: int, cluster_ids, centroids_rot, flip_bits,
                   dim: int, metric: str = "l2",
                   search_cfg: SearchConfig | None = None,
                   device=None) -> "HnswSlimQIndex":
        """An index from host arrays: the CHAL graph, ``codes`` (a dict of
        the QuantizedCodes fields, code words u32 or i32), cluster ids,
        rotated centroids and the rotator's flip bits — the arrays of the
        checkpoint layout, or those of a JAX-built index."""
        idx = cls(metric=metric, search_cfg=search_cfg, device=device)
        idx._check_centroids(len(centroids_rot), dim)
        idx.graph = ChalGraph.from_numpy(
            nbr, lvl_off, level, entry=entry, max_level=max_level,
            threshold_level=threshold_level, cap0=cap0, cap=cap,
            device=idx.device)
        idx.codes = QuantizedCodes.from_numpy(codes, ex_bits, idx.device)
        idx.cluster_ids = idx._dev(np.asarray(cluster_ids, np.int32))
        idx.centroids_rot = idx._dev(np.asarray(centroids_rot, np.float32))
        idx.rotator = FhtKacRotator.from_state(dim, np.asarray(flip_bits),
                                               device=idx.device)
        return idx

    def set_dataset(self, vectors: np.ndarray) -> None:
        """External raw vectors for the exact rerank."""
        self.dataset = np.asarray(vectors, np.float32)
        self._dataset_dev = None

    def set_ef(self, ef: int) -> None:
        self.scfg = dataclasses.replace(self.scfg, ef=ef)

    def autotune(self, ef: int, **kw) -> dict:
        """Per-graph serve-time knob calibration (shared with Slim; probes
        and ground truth come from the external rerank dataset)."""
        from .slim import autotune_index

        return autotune_index(self, ef, **kw)

    def _packed_rows(self) -> torch.Tensor:
        if self._packed is None:
            self._packed = pack_code_rows(self.codes, self.cluster_ids)
        return self._packed

    def _seed_table(self):
        """(up_rows i32[n_up_pad, R], up_ids i32[n_up_pad]): the packed code
        rows and ids of all level>=1 nodes (``_seed_ids``); rebuilt when the
        graph object changes. The seed scan reads the 1-bit plane, the 1-bit
        factors and the cluster id of each row."""
        if self._seed_ids():
            self.up_rows = self._packed_rows()[
                self.up_ids.clamp(min=0).long()].contiguous()
        return self.up_rows, self.up_ids

    def _plan(self, k: int, rerank: bool):
        """(reads, chain) of ``replay.batch_search``: slimq_search's
        arguments besides the queries and the rotator's tensors, and Kη,
        then slimq_search, on uploaded raw queries."""
        g, c, kw = self.graph, self.codes, self._serving(k)
        use_track = rerank and self.dataset is not None
        if self._dataset_dev is None and use_track:
            self._dataset_dev = self._dev(self.dataset)
        up_rows, up_ids = self._seed_table() if self._seeded() \
            else (None, None)
        kw.update(
            nbr=g.nbr, lvl_off=g.lvl_off, entry=g.entry,
            packed=self._packed_rows(), centroids_rot=self.centroids_rot,
            dataset=self._dataset_dev if use_track else None,
            nb=int(c.bin_code.shape[1]), ex_bits=int(c.ex_bits),
            up_rows=up_rows, up_ids=up_ids, up_count=self.up_count,
            use_ex=self.use_ex or self.scfg.use_ex)

        def chain(q_raw):
            with trace.span("index.rotate"):
                q_rot = self.rotator.rotate(q_raw)
            return slimq_search(
                q_rot=q_rot, q_raw=q_raw.contiguous() if use_track else None,
                **kw)

        return (kw, self.rotator.signs, self.rotator.fac), chain

    def search_async(self, queries, k: int, rerank: bool = True):
        """Enqueue one search — exactly what ``search`` runs eagerly — and
        return the device tensors (d, ids, hops i32[B], dcomp i32[B])
        without waiting for the card; d and ids are at least k wide."""
        return replay.enqueue(queries, self.device, self._plan(k, rerank)[1])

    def search(self, queries: np.ndarray, k: int, rerank: bool = True):
        """(dists f32[B, k], ids i32[B, k]) as numpy: exact distances to the
        rerank dataset when there is one and ``rerank`` is set, else
        estimates. Sets ``last_stats`` (hops, distance_computations, summed
        when first read). A repeated call on the card replays one CUDA
        graph of the whole search (``replay``), with the same results."""
        return replay.batch_search(self, queries, k,
                                   lambda: self._plan(k, rerank),
                                   graphs=self._replay)

    def index_size(self) -> int:
        """Graph + quantized payload bytes (no raw vectors)."""
        return self.graph.chal_bytes() + self.codes.bytes() + 4 * self.graph.n

    def runtime_memory(self) -> int:
        """Index + the externally held vectors."""
        ds = 0 if self.dataset is None else self.dataset.nbytes
        return self.index_size() + ds
