"""Patch chunks for the tests of apply_patch's two paths, without JAX (the
card's tests import this too): a record encoder, a random CHAL graph whose
rows are out of order, random chunks (changed records, new ids, reused
slots that ship their vectors), and the chunks that test a rule of the
apply: one id twice, a record above the graph's top level, no records."""

import dataclasses
import struct

import numpy as np
import torch

from hnsw_slim_tpu_torch.graph.prune import pack_chal_arrays
from hnsw_slim_tpu_torch.persist import patch as tpatch


def encode_chunk(records, cur_count: int, dim: int = 0) -> bytes:
    """One chunk of ``records``: (id, [ids of level 0, ..., level lv],
    vector or None); a record with a vector is flagged new. ``dim`` 0: a
    chunk without vectors."""
    body = []
    for v, rows, vec in records:
        ids = np.concatenate([np.asarray(r, np.int32) for r in rows])
        rel = np.cumsum([len(r) for r in rows]).astype(np.uint32)
        body.append(struct.pack("<Biii", vec is not None, v, len(rows) - 1,
                                len(ids)) + rel.tobytes() + ids.tobytes())
        if vec is not None and dim:
            body.append(np.asarray(vec, np.float32).tobytes())
    hdr = tpatch._HDR.pack(tpatch.MAGIC, tpatch.VERSION, cur_count,
                           len(records), 1 if dim else 0, 1, 0, dim)
    return hdr + b"".join(body)


def random_levels(rng, n: int, max_level: int) -> np.ndarray:
    lv = np.minimum(rng.geometric(0.7, n) - 1, max_level).astype(np.int32)
    lv[rng.integers(n)] = max_level
    return lv


def random_rows(rng, n: int, width: int) -> np.ndarray:
    """Rows of ``n`` nodes: up to ``width`` ids each, in no order, -1
    padded."""
    rows = rng.integers(0, n, (n, width), dtype=np.int32)
    rows[np.arange(width) >= rng.integers(0, width + 1, (n, 1))] = -1
    return rows


def random_graph(n: int, cap0: int, cap: int, max_level: int, seed: int):
    """A CHAL graph on the CPU whose rows hold random ids in no order."""
    rng = np.random.default_rng(seed)
    levels = random_levels(rng, n, max_level)
    per_level = [random_rows(rng, n, cap0 if l == 0 else cap)
                 for l in range(max_level + 1)]
    return pack_chal_arrays(per_level, levels, entry=int(np.argmax(levels)),
                            max_level=max_level, threshold_level=0,
                            cap0=cap0, cap=cap, device="cpu")


def shuffled_rows(graph, seed: int):
    """``graph`` (CPU) with the ids of every node's level rows in a random
    order."""
    off = graph.lvl_off[:graph.n].numpy()
    total = int(off[-1, -1]) if graph.n else 0
    seg = np.repeat(np.arange(off[:, :-1].size),
                    np.diff(off, axis=1).reshape(-1))
    key = np.random.default_rng(seed).random(total)
    nbr = graph.nbr.clone()
    nbr[:total] = graph.nbr[:total][np.lexsort((key, seg))]
    return dataclasses.replace(graph, nbr=nbr)


def random_record(rng, v: int, lv: int, n: int, cap0: int, cap: int,
                  vec=None):
    rows = [rng.integers(0, n, rng.integers(0, (cap0 if l == 0 else cap)
                                            + 1)) for l in range(lv + 1)]
    return v, rows, vec


def random_chunk(graph, seed: int, n_old: int, n_new: int, n_reused: int,
                 dim: int) -> bytes:
    """Changed records of ``n_old`` nodes, ``n_reused`` slots below the
    node count and ``n_new`` ids past it, both with vectors (when ``dim``)
    and new levels."""
    rng = np.random.default_rng(seed)
    prev = graph.n
    n_total = prev + n_new
    old = rng.choice(prev, n_old + n_reused, replace=False)
    lv_old = graph.level[:prev].numpy()
    recs = []
    for v in old[:n_old]:
        recs.append(random_record(rng, int(v), int(lv_old[v]), n_total,
                                  graph.cap0, graph.cap))
    fresh = np.concatenate([old[n_old:], np.arange(prev, n_total)])
    for v, lv in zip(fresh, random_levels(rng, len(fresh), graph.max_level)):
        vec = rng.standard_normal(dim).astype(np.float32) if dim else None
        recs.append(random_record(rng, int(v), int(lv), n_total, graph.cap0,
                                  graph.cap, vec))
    return encode_chunk(recs, n_total, dim)


def rule_chunks(graph, seed: int, dim: int) -> dict:
    """name -> chunks testing one rule of the apply on ``graph``."""
    rng = np.random.default_rng(seed)
    n, top = graph.n, graph.max_level
    c0, c = graph.cap0, graph.cap

    def vec():
        return rng.standard_normal(dim).astype(np.float32) if dim else None

    a, b = (int(v) for v in rng.choice(n, 2, replace=False))
    twice = [random_record(rng, a, top + 3, n + 2, c0, c, vec()),
             random_record(rng, b, 1, n + 2, c0, c, vec()),
             random_record(rng, n + 1, 0, n + 2, c0, c, vec()),
             random_record(rng, a, 0, n + 2, c0, c, vec()),
             random_record(rng, b, 2, n + 2, c0, c),  # its vector stays
             random_record(rng, n + 1, 1, n + 2, c0, c, vec())]
    above = [random_record(rng, a, top + 2, n, c0, c),
             random_record(rng, b, top + 1, n, c0, c, vec())]
    return {"one id twice": [encode_chunk(twice, n + 2, dim)],
            "above the top level": [encode_chunk(above, n, dim)],
            "empty chunk": [encode_chunk([], n, dim),
                            encode_chunk([], n + 3, dim)]}


def store_of(vectors, like) -> object:
    """``vectors`` as the path's store: a host array for the host path, an
    fp32 tensor on ``like``'s device for the device path."""
    if like is None:
        return np.array(vectors, np.float32, copy=True)
    return torch.as_tensor(np.asarray(vectors, np.float32), device=like)


def assert_same(got, want):
    """Two (graph, store) results equal: every array of the graph (nbr with
    its padding), its scalars, and the store's rows."""
    (ga, va), (gb, vb) = got, want
    for name in ("nbr", "lvl_off", "level"):
        ta, tb = getattr(ga, name).cpu(), getattr(gb, name).cpu()
        assert ta.dtype == tb.dtype == torch.int32, name
        assert torch.equal(ta, tb), name
    for name in ("n_real", "entry", "max_level", "threshold_level", "cap0",
                 "cap"):
        assert getattr(ga, name) == getattr(gb, name), name
    assert (va is None) == (vb is None)
    if va is not None:
        va = va.cpu().numpy() if isinstance(va, torch.Tensor) else va
        vb = vb.cpu().numpy() if isinstance(vb, torch.Tensor) else vb
        assert va.dtype == vb.dtype == np.float32
        np.testing.assert_array_equal(va, vb)


def apply_all(fn, graph, chunks, vectors):
    """``fn`` over the chunks in turn; the result after each."""
    out = []
    for blob in chunks:
        graph, vectors = fn(graph, blob, vectors)
        out.append((graph, vectors))
    return out
