"""One-device serving of independently built shards: the flat union graph
(port of hnsw_slim_tpu/parallel/flat_union.py).

The disjoint shard graphs are concatenated into one ChalGraph (shard i's
local ids shifted by i * n_per), and every search runs the Slim query path
(``chal_search``: Kα, Kε, Kβ) on it. Two modes, as in the JAX package:

* ``seed_width > 1``: each query runs once, seeded by the exact top
  seed_width / S upper-level nodes of every shard (Kα strata mode over a
  table of S equal segments): a union of disconnected components is only
  reachable through seeds. Ids map to global ids; distances come back as the
  search returns them.
* ``seed_width == 0``: each query runs once per shard, from that shard's
  entry point, and the S lists merge by K19 (``parallel/merge.py``): global
  ids, +inf where the id is padded or missing, a stable sort by distance.

``store_dtype="bfloat16"`` stores the union's vectors as bfloat16 (half the
bytes), cast from the shards' rows with round-to-nearest-even; every kernel
then reads bf16 rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import SearchConfig
from ..graph.types import ChalGraph
from ..index.hnsw import STORE_DTYPES
from ..ops import cuda
from ..ops.distance import sq_norms
from .merge import merge_topk


class FlatUnionIndex:
    """Union-of-shards Slim index served from one device."""

    def __init__(self, metric: str = "l2",
                 search_cfg: SearchConfig | None = None, device=None):
        self.metric = metric
        self.scfg = search_cfg or SearchConfig()
        self.device = cuda.resolve_device(device)
        self.graph: ChalGraph | None = None
        self.entries: np.ndarray | None = None  # i32[S] flat entry ids
        self.gids: np.ndarray | None = None  # i32[S*n_per] flat -> global id
        self.vectors = None
        self.vn = None
        self._slim = None
        self._gids_dev = None
        self.last_stats: dict = {}

    @classmethod
    def from_indexes(cls, shard_indexes, metric: str = "l2",
                     search_cfg: SearchConfig | None = None,
                     store_dtype: str = "float32",
                     device=None) -> "FlatUnionIndex":
        """shard_indexes: list of (HnswSlimIndex, global_ids i32[n_per]),
        all with n_per nodes (pad a short shard and give its padding gid
        -1)."""
        out = cls(metric=metric, search_cfg=search_cfg, device=device)
        dev = out.device
        if store_dtype not in STORE_DTYPES:
            raise ValueError(f"store_dtype={store_dtype!r}: expected one of "
                             f"{sorted(STORE_DTYPES)}")
        store = STORE_DTYPES[store_dtype]
        s = len(shard_indexes)
        graphs = [g.graph for g, _ in shard_indexes]
        n_per = graphs[0].n
        if any(g.n != n_per for g in graphs):
            raise ValueError("FlatUnionIndex: equal shard sizes required")
        lmax = max(g.max_level for g in graphs)

        nbr_parts, off_parts, lvl_parts, vec_parts = [], [], [], []
        entries = np.zeros(s, np.int32)
        gid = np.zeros((s, n_per), np.int32)
        edge_base = 0
        for i, (g, gids) in enumerate(shard_indexes):
            gr = g.graph
            o = gr.lvl_off[:n_per].to(dev, torch.int64)
            n_edges = int(o[-1, -1])
            ids = gr.nbr[:n_edges].to(dev, torch.int64)
            # local ids into the flat space (shard i's base = i * n_per)
            nbr_parts.append(torch.where(ids >= 0, ids + i * n_per, -1))
            # missing levels saturate at the row's last offset
            off = torch.empty((n_per, lmax + 2), dtype=torch.int64,
                              device=dev)
            off[:, :o.shape[1]] = o + edge_base
            off[:, o.shape[1]:] = o[:, -1:] + edge_base
            off_parts.append(off)
            lvl_parts.append(gr.level[:n_per].to(dev, torch.int32))
            entries[i] = int(gr.entry) + i * n_per
            gid[i] = np.asarray(gids, np.int32)
            # each shard cast on its own: no fp32 copy of the whole union
            vec_parts.append(g.vectors[:n_per].to(dev).to(store))
            edge_base += n_edges

        flat = torch.cat(nbr_parts)
        e_pad = max(1024, 1 << (len(flat) - 1).bit_length())
        nbr = torch.full((e_pad,), -1, dtype=torch.int32, device=dev)
        nbr[:len(flat)] = flat.to(torch.int32)
        g0 = graphs[0]
        out.graph = ChalGraph(
            nbr=nbr, lvl_off=torch.cat(off_parts).to(torch.int32),
            level=torch.cat(lvl_parts), entry=int(entries[0]),
            max_level=lmax, threshold_level=g0.threshold_level, cap0=g0.cap0,
            cap=g0.cap)
        out.entries = entries
        out.gids = gid.reshape(-1)
        out.vectors = torch.cat(vec_parts)
        del vec_parts
        out.vn = sq_norms(out.vectors)
        out._wrap()
        return out

    def _wrap(self):
        """The Slim index that serves the union graph, and its seed table:
        per-shard segments of one padded width U of the shard's level>=1
        nodes, so Kα's strata mode takes seed_width / S seeds per shard. The
        table's rows are a gather of the store (bf16 for a bf16 store)."""
        from ..index.slim import HnswSlimIndex, seed_rows

        slim = HnswSlimIndex(metric=self.metric, search_cfg=self.scfg,
                             device=self.device)
        slim.graph = self.graph
        slim.vectors = self.vectors
        slim.vn = self.vn
        self._slim = slim
        lv = self.graph.level.cpu().numpy()
        s = len(self.entries)
        n_per = len(lv) // s
        per = [np.nonzero(lv[i * n_per:(i + 1) * n_per] >= 1)[0] + i * n_per
               for i in range(s)]
        u = seed_rows(max(len(p) for p in per))
        idp = np.full((s, u), -1, np.int32)
        for i, p in enumerate(per):
            idp[i, :len(p)] = p
        slim.up_ids = torch.as_tensor(idp.reshape(-1), device=self.device)
        slim.up_count = sum(len(p) for p in per)
        slim.up_vecs = self.vectors[slim.up_ids.clamp(min=0).long()]
        slim.up_vn = sq_norms(slim.up_vecs)
        slim._up_for = self.graph
        self._gids_dev = torch.as_tensor(self.gids, device=self.device)

    def densify_level0(self) -> int:
        self._slim.scfg = self.scfg
        return self._slim.densify_level0()

    def densify_upper(self) -> int:
        self._slim.scfg = self.scfg
        return self._slim.densify_upper()

    def set_ef(self, ef: int) -> None:
        self.scfg = dataclasses.replace(self.scfg, ef=ef)

    def autotune(self, ef: int, k: int = 10, sample: int = 256,
                 queries=None, gt=None, **kw) -> dict:
        """Serve-time knob calibration on the union graph itself
        (index/slim.autotune_index): it reads the graph, the vectors and
        ``_dev`` of this object and searches through ``search``. The union
        returns global ids, so the default ground truth (exact top-k over
        the union's rows) is mapped to global ids first; the JAX package
        compares them with flat row ids instead, which scores every
        configuration near recall 0."""
        from ..index.bruteforce import exact_topk
        from ..index.slim import autotune_index, probe_queries

        if queries is None:
            queries = probe_queries(self, self.vectors, self.graph.n, sample)
        if gt is None:
            _, pos = exact_topk(self.vectors, self.vn,
                                self._dev(np.asarray(queries, np.float32)),
                                k=k, metric=self.metric)
            pos = pos.cpu().numpy()
            gt = np.where(pos >= 0, self.gids[np.maximum(pos, 0)], -1)
        return autotune_index(self, ef, k=k, sample=sample, queries=queries,
                              gt=gt, **kw)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def hbm_bytes(self) -> int:
        """Device bytes of the vectors, graph, norms and dense layouts."""
        t = (self.vectors.nbytes + self.graph.nbr.nbytes
             + self.graph.lvl_off.nbytes + self.vn.nbytes)
        if self._slim.dense0 is not None:
            t += self._slim.dense0.nbytes
        if self._slim.dense_up is not None:
            t += self._slim.rank_up.nbytes
            t += sum(d.nbytes for d in self._slim.dense_up)
        return int(t)

    def index_size(self) -> int:
        return self.graph.chal_bytes()

    def search(self, queries: np.ndarray, k: int):
        """(dists f32[B, k], global ids i32[B, k]) as numpy. With
        scfg.seed_width > 1 each query runs once with seed_strata = S; with
        seed_width == 0 each runs once per shard from its entry point and
        K19 merges the S lists. Sets ``last_stats``."""
        q = np.asarray(queries, np.float32)
        b = q.shape[0]
        s = len(self.entries)
        self._slim.scfg = self.scfg
        if self.scfg.seed_width > 1:
            self._slim.scfg = dataclasses.replace(self.scfg,
                                                  seed_strata=s)
            d, i = self._slim.search(q, k=k)
            self.last_stats = self._slim.last_stats
            gi = np.where(i >= 0, self.gids[np.maximum(i, 0)], -1)
            return d, gi.astype(np.int32)
        # [b*S] query-major, shard-minor: row r*S + i is query r on shard i
        qr = np.repeat(q, s, axis=0)
        entry = self._dev(np.tile(self.entries, b))
        d, i, hops, dcomp = self._slim.search_async(qr, k, entry=entry)
        md, mi, mh, mc = merge_topk(
            d.reshape(b, s, k).permute(1, 0, 2),
            i.reshape(b, s, k).permute(1, 0, 2), self._gids_dev,
            hops.reshape(b, s).T, dcomp.reshape(b, s).T)
        self.last_stats = {"hops": int(mh.sum()),
                           "distance_computations": int(mc.sum())}
        return md.cpu().numpy(), mi.cpu().numpy()
