"""Sharded Slim search (port of hnsw_slim_tpu/parallel/sharded.py).

Nodes are round-robin sharded (global node g lives on shard g % S as local
node g // S), each shard holds its own subgraph and vectors, a query runs on
every shard, and the per-shard top-k merge by K19 (``parallel/merge.py``).
The JAX package lays shards and queries over a device mesh ("dp", "shard");
here ``make_mesh`` gives the same (dp, shard) layout over the ranks of the
default ``torch.distributed`` process group, or over one process:

* one process (no process group): every shard is local. ``search`` runs one
  ``chal_search`` per shard over views of the stacked arrays (no copies),
  then K19 over the stacked results;
* R ranks with dp query groups: rank r serves query group r // (R / dp) and
  holds the shards of its place in that group; queries split over the dp
  groups as the JAX batch padding does. Every rank all_gathers d, local ids,
  hops and dcomp and runs the same merge, so every rank returns the whole
  batch's result.

As in the JAX package each shard descends greedily from its own entry point
(no exact seeds, whatever ``seed_width`` says), ``max_level`` is the largest
over shards with missing levels' offsets saturated (empty slices), the
stacked vectors are fp32 even from bfloat16 shard indexes, and ``save``
writes one ``.npz`` that either engine loads.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..config import HnswConfig, SearchConfig, SlimConfig
from ..graph import search as gs
from ..ops import cuda
from .merge import merge_topk


def _dist():
    """torch.distributed when a process group is up, else None."""
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """(dp, shard) layout: ``n_shards`` shards, queries split over ``dp``
    groups of ranks; rank ``rank`` of ``ranks`` holds the shards
    ``local_shards``."""

    dp: int
    n_shards: int
    ranks: int = 1
    rank: int = 0

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "shard": self.n_shards}

    @property
    def shard_ranks(self) -> int:
        return self.ranks // self.dp

    @property
    def dp_index(self) -> int:
        return self.rank // self.shard_ranks

    @property
    def local_shards(self) -> range:
        per = self.n_shards // self.shard_ranks
        first = (self.rank % self.shard_ranks) * per
        return range(first, first + per)


def make_mesh(n_shards: int, dp: int = 1) -> Mesh:
    """The (dp, shard) layout of ``n_shards`` shards over the ranks of the
    default process group (one rank without one): dp must divide the ranks,
    and the ranks of a dp group must divide the shards."""
    dist = _dist()
    ranks = dist.get_world_size() if dist else 1
    rank = dist.get_rank() if dist else 0
    if dp < 1 or ranks % dp:
        raise ValueError(f"make_mesh: dp={dp} does not divide {ranks} ranks")
    if n_shards < 1 or n_shards % (ranks // dp):
        raise ValueError(f"make_mesh: {n_shards} shards over {ranks // dp} "
                         "ranks per query group")
    return Mesh(dp=dp, n_shards=n_shards, ranks=ranks, rank=rank)


class ShardedSlimIndex:
    """Round-robin sharded Slim index over a (dp, shard) layout."""

    def __init__(self, mesh: Mesh, metric: str = "l2",
                 search_cfg: SearchConfig | None = None, device=None):
        self.mesh = mesh
        self.metric = metric
        self.scfg = search_cfg or SearchConfig()
        self.device = cuda.resolve_device(device)
        self.arrays = None  # stacked [S_local, ...] tensors of local shards
        self.meta = None  # static search params
        self._ent: list = []  # local shards' entry points, on the host
        self._gid_all = None  # i32[S, n_per] of every shard (the merge)
        self.last_stats: dict = {}

    @property
    def n_shards(self) -> int:
        return self.mesh.shape["shard"]

    def _all_reduce(self, vals, op: str):
        """vals (ints) reduced over the ranks ("max" or "sum")."""
        dist = _dist()
        if self.mesh.ranks == 1 or dist is None:
            return [int(v) for v in vals]
        t = torch.tensor(vals, dtype=torch.int64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM)
        return [int(v) for v in t.tolist()]

    def build(self, vectors: np.ndarray, hnsw_cfg: HnswConfig | None = None,
              slim_cfg: SlimConfig | None = None, verbose: bool = False):
        """Build this rank's shards: shard si holds global ids si, si + S,
        ...; a short shard is padded with copies of its row 0 whose gid is
        -1."""
        from ..index.slim import HnswSlimIndex

        hnsw_cfg = hnsw_cfg or HnswConfig()
        slim_cfg = slim_cfg or SlimConfig.from_ratios()
        s = self.n_shards
        vectors = np.asarray(vectors, np.float32)
        n = vectors.shape[0]
        n_per = -(-n // s)
        gid_all = np.full((s, n_per), -1, np.int32)
        graphs = {}
        for si in range(s):
            gids = np.arange(si, n, s, dtype=np.int32)
            gid_all[si, :len(gids)] = gids
            if si not in self.mesh.local_shards:
                continue
            local = vectors[gids]
            if len(gids) < n_per:  # pad a short shard
                local = np.concatenate(
                    [local, np.repeat(local[:1], n_per - len(gids), 0)])
            idx = HnswSlimIndex.build(local, hnsw_cfg, slim_cfg,
                                      device=self.device)
            graphs[si] = (idx, gid_all[si])
            if verbose:
                print(f"  shard {si}: {idx.index_size()} graph bytes")
        lmax, e_pad = self._all_reduce(
            [max(g.graph.max_level for g, _ in graphs.values()),
             max(int(g.graph.nbr.shape[0]) for g, _ in graphs.values())],
            "max")
        self._stack(graphs, gid_all, lmax, e_pad)
        return self

    @classmethod
    def from_indexes(cls, mesh: Mesh, shard_indexes, metric: str = "l2",
                     search_cfg: SearchConfig | None = None, device=None):
        """Assemble from pre-built per-shard slim indexes: shard_indexes is
        a list of (HnswSlimIndex, global_ids i32[n_per]), one per shard, all
        of n_per nodes (pad a short shard and give its padding gid -1).
        Each rank keeps its own shards."""
        s = mesh.shape["shard"]
        if len(shard_indexes) != s:
            raise ValueError(f"{len(shard_indexes)} shard indexes for {s} "
                             "shards")
        idx = cls(mesh, metric=metric, search_cfg=search_cfg, device=device)
        gid_all = np.stack([np.asarray(g, np.int32) for _, g in shard_indexes])
        idx._stack(
            {si: shard_indexes[si] for si in mesh.local_shards}, gid_all,
            max(g.graph.max_level for g, _ in shard_indexes),
            max(int(g.graph.nbr.shape[0]) for g, _ in shard_indexes))
        return idx

    def _stack(self, graphs: dict, gid_all: np.ndarray, lmax: int,
               e_pad: int) -> None:
        """Stack the local shards' graphs ({shard: (index, gids)}) into
        [S_local, ...] tensors: neighbor arrays padded to e_pad, offsets to
        lmax + 2 columns (missing levels saturated), fp32 vectors."""
        dev = self.device
        local = list(self.mesh.local_shards)
        g0 = graphs[local[0]][0].graph
        n_per = g0.n
        dim = int(graphs[local[0]][0].vectors.shape[1])
        sl = len(local)
        nbr = torch.full((sl, e_pad), -1, dtype=torch.int32, device=dev)
        off = torch.zeros((sl, n_per, lmax + 2), dtype=torch.int32,
                          device=dev)
        lvl = torch.zeros((sl, n_per), dtype=torch.int32, device=dev)
        vecs = torch.zeros((sl, n_per, dim), dtype=torch.float32, device=dev)
        ent = []
        for j, si in enumerate(local):
            g, _ = graphs[si]
            gr = g.graph
            nbr[j, :gr.nbr.shape[0]] = gr.nbr.to(dev)
            o = gr.lvl_off[:n_per].to(dev)
            off[j, :, :o.shape[1]] = o
            off[j, :, o.shape[1]:] = o[:, -1:]  # saturate missing levels
            lvl[j] = gr.level[:n_per].to(dev)
            ent.append(int(gr.entry))
            vecs[j] = g.vectors[:n_per].to(dev).float()
        self._ent = ent
        self._gid_all = torch.as_tensor(gid_all, device=dev)
        self.arrays = dict(
            nbr=nbr, off=off,
            ent=torch.tensor(ent, dtype=torch.int32, device=dev), vecs=vecs,
            vn=(vecs * vecs).sum(-1),
            gid=self._gid_all[local[0]:local[-1] + 1].contiguous(), lvl=lvl)
        self.meta = dict(max_level=int(lmax),
                         threshold_level=int(g0.threshold_level),
                         cap0=int(g0.cap0), cap=int(g0.cap))

    def densify_level0(self) -> int:
        """Stacked dense level-0 rows i32[S_local, n_per, cap0] (the same
        serving layout as HnswSlimIndex.densify_level0, per shard). Returns
        their bytes."""
        nbr, off = self.arrays["nbr"], self.arrays["off"]
        cap0 = self.meta["cap0"]
        lanes = torch.arange(cap0, device=nbr.device)
        rows = []
        for j in range(nbr.shape[0]):
            start = off[j, :, 0].long()
            idx = start[:, None] + lanes
            valid = idx < off[j, :, 1].long()[:, None]
            ids = nbr[j][idx.clamp(max=nbr.shape[1] - 1)]
            rows.append(torch.where(valid, ids, -1))
        self.arrays["dense0"] = torch.stack(rows)
        return int(self.arrays["dense0"].numel() * 4)

    def densify_upper(self, bucket: int = 1024) -> int:
        """Stacked dense upper-level layout per shard: rank indirection
        i32[S_local, n_per] (-1 for level-0-only nodes) and dense rows
        i32[S_local, L, R_pad, cap], R_pad a multiple of ``bucket``; the
        layout HnswSlimIndex.densify_upper builds. Returns their bytes."""
        nbr, off, lvl = (self.arrays["nbr"], self.arrays["off"],
                         self.arrays["lvl"])
        cap, lmax = self.meta["cap"], self.meta["max_level"]
        if lmax < 1:
            return 0
        sl, n_per = lvl.shape
        dev = lvl.device
        rank = torch.full((sl, n_per), -1, dtype=torch.int32, device=dev)
        ups = []
        for j in range(sl):
            up = torch.nonzero(lvl[j] >= 1)[:, 0]
            rank[j, up] = torch.arange(len(up), dtype=torch.int32, device=dev)
            ups.append(up)
        r_max = max([1] + [len(u) for u in ups])
        r_pad = -(-r_max // bucket) * bucket
        dense = torch.full((sl, lmax, r_pad, cap), -1, dtype=torch.int32,
                           device=dev)
        lanes = torch.arange(cap, device=dev)
        for j, up in enumerate(ups):
            for l in range(1, lmax + 1):
                sel = up[lvl[j, up] >= l]
                if not len(sel):
                    continue
                idx = off[j, sel, l].long()[:, None] + lanes
                valid = idx < off[j, sel, l + 1].long()[:, None]
                ids = nbr[j][idx.clamp(max=nbr.shape[1] - 1)]
                dense[j, l - 1, rank[j, sel].long()] = torch.where(valid, ids,
                                                                   -1)
        self.arrays["rank_up"] = rank
        self.arrays["dense_up"] = dense
        return int(rank.numel() + dense.numel()) * 4

    def _local_search(self, q: torch.Tensor, k: int):
        """chal_search on every local shard over views of the stacked
        arrays. Returns stacked (d f32, local ids i32) [S_local, b, k] and
        (hops, dcomp) i32[S_local, b]."""
        a, m = self.arrays, self.meta
        dense0, rank_up, dense_up = (a.get("dense0"), a.get("rank_up"),
                                     a.get("dense_up"))
        outs = []
        for j, entry in enumerate(self._ent):
            outs.append(gs.chal_search(
                a["nbr"][j], a["off"][j], entry, a["vecs"][j], a["vn"][j], q,
                max_level=m["max_level"],
                threshold_level=m["threshold_level"], cap0=m["cap0"],
                cap=m["cap"], ef=max(self.scfg.ef, k), k=k,
                max_iters=self.scfg.iters(), metric=self.metric,
                pop_width=self.scfg.pop_width,
                scan_width=self.scfg.scan_width,
                dense0=None if dense0 is None else dense0[j],
                dense_up=None if dense_up is None else tuple(dense_up[j]),
                rank_up=None if rank_up is None else rank_up[j]))
        return tuple(torch.stack([o[f] for o in outs]) for f in range(4))

    def search(self, queries: np.ndarray, k: int):
        """(dists f32[B, k], global ids i32[B, k]) as numpy, ascending;
        every rank returns the whole batch. Sets ``last_stats`` (hops and
        distance computations summed over shards and queries)."""
        q = np.asarray(queries, np.float32)
        b = q.shape[0]
        mesh = self.mesh
        bpad = -(-b // mesh.dp) * mesh.dp
        if bpad != b:
            q = np.concatenate([q, np.repeat(q[:1], bpad - b, 0)])
        b_loc = bpad // mesh.dp
        p = mesh.dp_index
        q_loc = torch.as_tensor(q[p * b_loc:(p + 1) * b_loc],
                                device=self.device)
        parts = self._local_search(q_loc, k)
        if mesh.ranks > 1:
            parts = self._gather(parts)
        d, i, hops, dcomp = merge_topk(parts[0], parts[1], self._gid_all,
                                       parts[2], parts[3])
        self.last_stats = {
            "hops": int(hops[:b].sum()),
            "distance_computations": int(dcomp[:b].sum()),
        }
        return d[:b].cpu().numpy(), i[:b].cpu().numpy()

    def _gather(self, parts):
        """All ranks' [S_local, b_loc, ...] results as [S, dp * b_loc, ...]:
        the shards of query group p come from its ranks in shard order."""
        dist = _dist()
        mesh = self.mesh
        out = []
        for t in parts:
            got = [torch.empty_like(t) for _ in range(mesh.ranks)]
            dist.all_gather(got, t.contiguous())
            sr = mesh.shard_ranks
            groups = [torch.cat(got[p * sr:(p + 1) * sr]) for p in
                      range(mesh.dp)]
            out.append(torch.cat(groups, dim=1))
        return out

    def save(self, path) -> None:
        """Persist the stacked shard arrays and metadata in one ``.npz``:
        the arrays under the JAX package's names and dtypes, with
        ``meta_json`` (meta, metric, mesh_shape). Needs every shard local."""
        if len(self.mesh.local_shards) != self.n_shards:
            raise ValueError("save: this rank holds shards "
                             f"{list(self.mesh.local_shards)} of "
                             f"{self.n_shards}; save from one process")
        meta = dict(meta=self.meta, metric=self.metric,
                    mesh_shape=self.mesh.shape)
        np.savez(
            path,
            meta_json=np.frombuffer(json.dumps(meta).encode(), np.uint8),
            **{k: v.cpu().numpy() for k, v in self.arrays.items()},
        )

    @classmethod
    def load(cls, path, mesh: Mesh, search_cfg: SearchConfig | None = None,
             device=None):
        """Load a file of ``save`` (of either engine); each rank keeps its
        own shards."""
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta_json"].tobytes()).decode())
            idx = cls(mesh, metric=meta["metric"], search_cfg=search_cfg,
                      device=device)
            s = int(z["nbr"].shape[0])
            if s != idx.n_shards:
                raise ValueError(f"{path}: {s} shards, the mesh has "
                                 f"{idx.n_shards}")
            local = mesh.local_shards
            sl = slice(local[0], local[-1] + 1)
            idx.arrays = {k: torch.as_tensor(np.ascontiguousarray(z[k][sl]),
                                             device=idx.device)
                          for k in z.files if k != "meta_json"}
            idx._gid_all = torch.as_tensor(z["gid"], device=idx.device)
            idx._ent = [int(e) for e in z["ent"][sl]]
            idx.meta = {k: int(v) for k, v in meta["meta"].items()}
        return idx

    def index_size(self) -> int:
        """Graph bytes in the JAX package's accounting: 24 B per node and
        4 B per neighbor id, over all shards."""
        off = self.arrays["off"]
        n_total = self.n_shards * off.shape[1]
        local_nbrs = int((off[:, :, -1] - off[:, :, 0]).long().sum())
        # each query group's ranks hold every shard once
        (total_nbrs,) = self._all_reduce([local_nbrs], "sum")
        return 24 * n_total + 4 * (total_nbrs // self.mesh.dp)
