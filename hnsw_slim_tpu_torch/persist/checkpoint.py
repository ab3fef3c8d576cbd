"""Index persistence (port of hnsw_slim_tpu/persist/checkpoint.py).

The file format is the JAX package's: one ``.npz`` of arrays plus a JSON
metadata header, read and written with numpy alone. A graph either engine
saved loads into the other unchanged. A bfloat16 store is written as the
JAX package writes it (its raw 2-byte words, numpy dtype V2) and loads back
bit for bit; the JAX package's own loaders cannot read such a file back.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from ..config import HnswConfig, SearchConfig, SlimConfig

from ..graph.types import ChalGraph, LevelGraph
from ..ops.distance import sq_norms

FORMAT_VERSION = 1


def vectors_to_np(t: torch.Tensor) -> np.ndarray:
    """A vector store as the file holds it: fp32 as is; bfloat16 as its raw
    2-byte words (numpy dtype V2), the bytes the JAX package's ``np.savez``
    writes for its ml_dtypes bfloat16 store."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def vectors_from_np(a: np.ndarray, device) -> torch.Tensor:
    """The inverse of vectors_to_np, onto ``device``: 2-byte void words are
    bfloat16 rows."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        words = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(words).view(torch.bfloat16).to(device)
    return torch.as_tensor(a, device=device)


def _meta(z) -> dict:
    meta = json.loads(bytes(z["meta"].tobytes()).decode())
    if meta["version"] > FORMAT_VERSION:
        raise ValueError(f"unsupported index version {meta['version']}")
    return meta


def save_slim(path: str | Path, index) -> None:
    """Save an HnswSlimIndex or HnswSlimZeroIndex (graph + vectors +
    metadata; the kind is the class name)."""
    g = index.graph
    meta = dict(
        version=FORMAT_VERSION,
        kind=type(index).__name__,
        metric=index.metric,
        max_level=g.max_level,
        threshold_level=g.threshold_level,
        cap0=g.cap0,
        cap=g.cap,
        entry=int(g.entry),
    )
    n = g.n  # files hold the logical index, without capacity padding
    np.savez(
        path,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        nbr=g.nbr.cpu().numpy(),
        lvl_off=g.lvl_off[:n].cpu().numpy(),
        level=g.level[:n].cpu().numpy(),
        vectors=vectors_to_np(index.vectors[:n]),
    )


def load_slim(path: str | Path, search_cfg: SearchConfig | None = None,
              device=None):
    """Load an HnswSlimIndex or HnswSlimZeroIndex, as the file's kind says,
    onto ``device``."""
    from ..index.slim import HnswSlimIndex
    from ..index.slimzero import HnswSlimZeroIndex

    with np.load(path) as z:
        meta = _meta(z)
        cls = {"HnswSlimIndex": HnswSlimIndex,
               "HnswSlimZeroIndex": HnswSlimZeroIndex}[meta["kind"]]
        idx = cls(metric=meta["metric"], search_cfg=search_cfg,
                  device=device)
        idx.graph = ChalGraph.from_numpy(
            z["nbr"], z["lvl_off"], z["level"], entry=meta["entry"],
            max_level=meta["max_level"],
            threshold_level=meta["threshold_level"], cap0=meta["cap0"],
            cap=meta["cap"], device=idx.device,
        )
        idx.vectors = vectors_from_np(z["vectors"], idx.device)
        idx.vn = sq_norms(idx.vectors)
    return idx


def save_slimq(path: str | Path, index) -> None:
    """Save an HnswSlimQIndex: graph, quantized payload, the rotator's flip
    bits and the rotated centroids; no raw vectors — the dataset stays
    external. Code words are written as u32, as the JAX package writes
    them."""
    g = index.graph
    c = index.codes
    meta = dict(
        version=FORMAT_VERSION,
        kind="HnswSlimQIndex",
        metric=index.metric,
        max_level=g.max_level,
        threshold_level=g.threshold_level,
        cap0=g.cap0,
        cap=g.cap,
        entry=int(g.entry),
        ex_bits=c.ex_bits,
        dim=index.rotator.dim,
    )
    np.savez(
        path,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        nbr=g.nbr.cpu().numpy(),
        lvl_off=g.lvl_off[: g.n].cpu().numpy(),
        level=g.level[: g.n].cpu().numpy(),
        **c.to_numpy(),
        cluster_ids=index.cluster_ids.cpu().numpy(),
        centroids_rot=index.centroids_rot.cpu().numpy(),
        flip_bits=index.rotator.state(),
    )


def load_slimq(path: str | Path, search_cfg: SearchConfig | None = None,
               device=None):
    """Load an HnswSlimQIndex onto ``device``; the rerank dataset is not in
    the file (``set_dataset``)."""
    from ..index.slimq import HnswSlimQIndex
    from ..quant.rabitq import FIELDS

    with np.load(path) as z:
        meta = _meta(z)
        return HnswSlimQIndex.from_numpy(
            nbr=z["nbr"], lvl_off=z["lvl_off"], level=z["level"],
            entry=meta["entry"], max_level=meta["max_level"],
            threshold_level=meta["threshold_level"], cap0=meta["cap0"],
            cap=meta["cap"], codes={f: z[f] for f in FIELDS},
            ex_bits=meta["ex_bits"], cluster_ids=z["cluster_ids"],
            centroids_rot=z["centroids_rot"], flip_bits=z["flip_bits"],
            dim=meta["dim"], metric=meta["metric"], search_cfg=search_cfg,
            device=device)


def load_hnsw(path: str | Path, device=None):
    """Load a vanilla HnswIndex (the build side's LevelGraph) onto ``device``."""
    from ..index.hnsw import HnswIndex

    with np.load(path) as z:
        meta = _meta(z)
        idx = HnswIndex(HnswConfig(**meta["cfg"]), device=device)
        adjs = [z[f"adj{l}"] for l in range(meta["max_level"] + 1)]
        idx.graph = LevelGraph.from_numpy(
            adjs, z["level"], entry=meta["entry"],
            max_level=meta["max_level"], device=idx.device,
        )
        idx.levels = np.asarray(z["level"])
        # the host adjacency mirror comes from the file, not from the device
        idx._adj_np = [np.array(a, np.int32) for a in adjs]
        idx.vectors = vectors_from_np(z["vectors"], idx.device)
        idx.vn = sq_norms(idx.vectors)
    return idx


def incremental_from_state(state: dict, cfg: SlimConfig, *, zero: bool = False,
                           metric: str = "l2",
                           count_level0_hubs: bool = False, device=None):
    """An ``IncrementalSlim`` (``zero=True``: ``IncrementalSlimZero``) over
    the state arrays of another engine's object, given as numpy: ``thr``,
    ``budgets``, ``final``, ``levels``, ``entry``, ``lmax``, ``caps`` and,
    for Slim, ``stage2``, ``keys``, ``out_ws``, ``repair_keys`` (lists by
    level where the state is per level). Everything is copied. Returns
    (object, its ChalGraph packed onto ``device``), so that ``full`` can run
    in one engine and ``update`` in the other."""
    from ..graph import incremental as inc
    from ..ops.cuda import resolve_device

    cls = inc.IncrementalSlimZero if zero else inc.IncrementalSlim
    obj = cls(cfg, metric=metric, count_level0_hubs=count_level0_hubs)
    obj.thr = np.array(state["thr"], np.int64)
    obj.levels = np.array(state["levels"], np.int32)
    obj.entry, obj.lmax = int(state["entry"]), int(state["lmax"])
    obj.caps = [int(c) for c in state["caps"]]
    obj.budgets = [np.array(b, np.int32) for b in state["budgets"]]
    obj.final = [np.array(f, np.int32) for f in state["final"]]
    if not zero:
        obj.stage2 = [np.array(a, np.int32) for a in state["stage2"]]
        obj.keys = [np.array(k, np.int64) for k in state["keys"]]
        obj.out_ws = [int(w) for w in state["out_ws"]]
        obj.repair_keys = np.array(state["repair_keys"], np.int64)
    return obj, inc._pack(obj, resolve_device(device))


def save_hnsw(path: str | Path, index) -> None:
    g = index.graph
    meta = dict(
        version=FORMAT_VERSION,
        kind="HnswIndex",
        metric=index.cfg.metric,
        max_level=g.max_level,
        entry=int(g.entry),
        cfg=dataclasses.asdict(index.cfg),
    )
    n = g.n
    arrays = {f"adj{l}": a[:n].cpu().numpy() for l, a in enumerate(g.adjs)}
    np.savez(
        path,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        level=g.level[:n].cpu().numpy(),
        vectors=vectors_to_np(index.vectors[:n]),
        **arrays,
    )
