"""Import a reference-built graph (port of hnsw_slim_tpu/graph/import_ref.py).

Serves the EXACT graph the reference C++ engine built (the dumps of
parity/ref_harness.cc), which isolates the search kernels from the build
pipeline and lets reference-speed CPU builds feed serving on the card.

Slim dump format (parity/ref_harness.cc dump_slim_graph):
    u32 magic 'HSLG' | u32 n | i32 maxlevel | u32 entry | i32 Lt |
    u32 maxM | u32 maxM0 | per node: i32 level | u32 total |
    u32 end_off[level+1] | i32 ids[total]

HNSW dump format (dump_hnsw_graph):
    u32 magic 'HNSG' | u32 n | i32 maxlevel | u32 entry | u32 maxM |
    u32 maxM0 | per node: i32 level | per level l <= level: u32 cnt |
    i32 ids[cnt]

Both are parsed on the host (the native mmap scan of ``utils/native.py``
where it is built, else Python) and the arrays go to ``device`` once.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..ops.cuda import resolve_device
from .types import ChalGraph, LevelGraph

MAGIC = 0x48534C47
HNSW_MAGIC = 0x484E5347


def load_ref_slim_graph(path: str, return_host: bool = False, device=None):
    """The dump as a ChalGraph on ``device``; return_host=True also returns
    the host {nbr, lvl_off, level} dict, so densify / patch consumers need
    not pull the graph back from the card."""
    with open(path, "rb") as f:
        data = f.read()
    magic, n, maxlevel, entry, lt, maxm, maxm0 = struct.unpack_from(
        "<IIiIiII", data, 0
    )
    if magic != MAGIC:
        raise ValueError("bad slim graph dump")
    pos = 28

    from ..utils import native

    parsed = native.slim_graph_parse(path, n, maxlevel)
    if parsed is not None:  # mmap C scan: ~1 s at 1M vs ~2 min in Python
        levels, lvl_off, flat = parsed
        total_edges = len(flat)
    else:
        levels = np.zeros(n, np.int32)
        off = np.zeros((n, maxlevel + 2), np.int64)
        chunks = []
        total_edges = 0
        for v in range(n):
            lv, total = struct.unpack_from("<iI", data, pos)
            pos += 8
            ends = np.frombuffer(data, np.uint32, lv + 1, pos)
            pos += 4 * (lv + 1)
            ids = np.frombuffer(data, np.int32, total, pos)
            pos += 4 * total
            levels[v] = lv
            off[v, 0] = total_edges
            for l in range(maxlevel + 1):
                off[v, l + 1] = total_edges + int(ends[min(l, lv)])
            chunks.append(ids)
            total_edges += total
        flat = np.concatenate(chunks) if chunks else np.zeros(0, np.int32)
        lvl_off = off.astype(np.int32)
    e_pad = max(1024, 1 << max(0, total_edges - 1).bit_length())
    nbr = np.full(e_pad, -1, np.int32)
    nbr[:total_edges] = flat
    graph = ChalGraph.from_numpy(
        nbr, lvl_off, levels, entry=entry, max_level=maxlevel,
        threshold_level=lt, cap0=maxm0, cap=maxm,
        device=resolve_device(device))
    if return_host:
        return graph, dict(nbr=nbr, lvl_off=lvl_off, level=levels)
    return graph


def load_ref_hnsw_graph(path: str, return_host: bool = False, device=None):
    """An UNPRUNED reference HNSW adjacency as a LevelGraph on ``device``:
    the mutable serving state updates operate on. return_host=True also
    returns the per-level host arrays."""
    with open(path, "rb") as f:
        data = f.read()
    magic, n, maxlevel, entry, maxm, maxm0 = struct.unpack_from(
        "<IIiIII", data, 0
    )
    if magic != HNSW_MAGIC:
        raise ValueError("bad hnsw graph dump")
    pos = 24

    from ..utils import native

    parsed = native.hnsw_graph_parse(path, n, maxlevel, maxm, maxm0)
    if parsed is not None:  # mmap C scan: ~1 s at 1M vs ~17 min in Python
        levels, adjs = parsed
    else:
        levels = np.zeros(n, np.int32)
        adjs = [np.full((n, maxm0 if l == 0 else maxm), -1, np.int32)
                for l in range(maxlevel + 1)]
        for v in range(n):
            (lv,) = struct.unpack_from("<i", data, pos)
            pos += 4
            levels[v] = lv
            for l in range(lv + 1):
                (cnt,) = struct.unpack_from("<I", data, pos)
                pos += 4
                adjs[l][v, :cnt] = np.frombuffer(data, np.int32, cnt, pos)
                pos += 4 * cnt
    lg = LevelGraph.from_numpy(adjs, levels, entry=entry, max_level=maxlevel,
                               device=resolve_device(device))
    return (lg, adjs) if return_host else lg


def hnsw_index_from_ref(graph_path: str, vectors: np.ndarray, metric="l2",
                        M: int = 30, ef_construction: int = 128,
                        device=None):
    """HnswIndex serving / updating a reference-built vanilla graph."""
    from ..config import HnswConfig
    from ..index.hnsw import HnswIndex
    from ..ops.distance import sq_norms

    cfg = HnswConfig(M=M, ef_construction=ef_construction, metric=metric)
    idx = HnswIndex(cfg, device=device)
    idx.graph, host_adjs = load_ref_hnsw_graph(graph_path, return_host=True,
                                               device=idx.device)
    idx.levels = idx.graph.level.cpu().numpy()
    # the host mirror comes from the parse, not from the card
    idx._adj_np = [np.asarray(a, np.int32) for a in host_adjs]
    idx.vectors = torch.as_tensor(np.asarray(vectors, np.float32),
                                  device=idx.device)
    idx.vn = sq_norms(idx.vectors)
    return idx


def slim_index_from_ref(graph_path: str, vectors: np.ndarray, metric="l2",
                        store_dtype: str = "float32", upload: bool = True,
                        device=None):
    """HnswSlimIndex serving a reference-built Slim graph. upload=False
    keeps the vector store in host memory (a CPU tensor, norms summed in
    float64 on the host): for shards that only feed a union assembly
    (FlatUnionIndex / ShardedSlimIndex copy the vectors into their own
    layout), so that S per-shard uploads never coexist on the card."""
    from ..index.slim import HnswSlimIndex
    from ..ops.distance import sq_norms

    idx = HnswSlimIndex(metric=metric, device=device)
    idx.graph, idx.host_chal = load_ref_slim_graph(
        graph_path, return_host=True, device=idx.device)
    host = np.asarray(vectors, np.float32)
    if not upload:
        idx.vectors = torch.from_numpy(host)
        idx.vn = torch.from_numpy(
            (host.astype(np.float64) ** 2).sum(axis=1).astype(np.float32))
        return idx
    idx.vectors = torch.as_tensor(host, device=idx.device)
    if store_dtype == "bfloat16":
        idx.vectors = idx.vectors.to(torch.bfloat16)
    idx.vn = sq_norms(idx.vectors)
    return idx
