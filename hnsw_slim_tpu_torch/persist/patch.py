"""Incremental-update patch protocol: diff, chunked encode, apply (port of
hnsw_slim_tpu/persist/patch.py; diff and encode in host numpy, bytes
identical to the JAX package's).

The reference detects changed nodes by comparing each node's CHAL block with
the previous one, streams them in size-limited chunks with a `finished`
flag, and applies records in place. Here the comparison is logical
(per-level neighbor id sets in canonical sorted order) and application
rebuilds the flat CHAL arrays on the graph's device: by Kπ
(csrc/patch_apply.cu) on the card, by its plain version on the CPU.

Record wire format (little-endian), preserving the reference's
[id][header][offsets][neighbor ids][optional vector] field order:
    u32 id | i32 level | u32 total | u32 rel_end[level+1] | i32 nbr[total]
    | (f32 vec[dim] if has_vectors)
Chunk header: u32 magic 'HSLP' | u32 version | u64 cur_count | u32 n_records
    | u8 has_vectors | u8 finished | u16 pad | u32 dim
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..graph.build import _to_dev
from ..graph.prune import _next_pow2
from ..graph.types import ChalGraph
from ..ops import cuda
from ..utils import trace

MAGIC = 0x48534C50  # 'HSLP'
VERSION = 1
_HDR = struct.Struct("<IIQIBBHI")
LEVEL_CAP = 16  # the highest record level the decoder takes
MAX_WIDTH = 1024  # the widest level row (max(cap0, cap)) Kπ sorts
SCAN_TILE = 1024  # nodes a tile of Kπ's scan launch


def node_slices(chal_np: dict, v: int) -> list[np.ndarray]:
    """Per-level neighbor arrays of node v (canonical: sorted ascending)."""
    off = chal_np["lvl_off"][v]
    lv = int(chal_np["level"][v])
    nbr = chal_np["nbr"]
    return [np.sort(nbr[off[l] : off[l + 1]]) for l in range(lv + 1)]


def to_np(chal: ChalGraph) -> dict:
    return dict(
        nbr=chal.nbr.cpu().numpy(),
        lvl_off=chal.lvl_off.cpu().numpy(),
        level=chal.level.cpu().numpy(),
    )


def _rows_for(c: dict, l: int, off: np.ndarray, width: int) -> np.ndarray:
    """Canonical (sorted, -1-padded) level-l rows for the given lvl_off
    slice — vectorized gather over the flat CHAL arrays."""
    start = off[:, l].astype(np.int64)
    end = off[:, l + 1].astype(np.int64)
    idx = start[:, None] + np.arange(width)[None, :]
    valid = idx < end[:, None]
    rows = np.where(valid, c["nbr"][np.minimum(idx, len(c["nbr"]) - 1)], -1)
    big = np.where(rows < 0, np.iinfo(np.int32).max, rows)
    out = np.sort(big, axis=1)
    return np.where(out == np.iinfo(np.int32).max, -1, out)


def _level_rows(c: dict, l: int, count: int, width: int) -> np.ndarray:
    """Canonical level-l neighbor rows for nodes [0, count)."""
    return _rows_for(c, l, c["lvl_off"][:count], width)


def _subset_rows(c: dict, l: int, ids: np.ndarray, width: int) -> np.ndarray:
    """Canonical level-l neighbor rows for an arbitrary id subset (the
    dense-layout refresh gathers only changed nodes)."""
    return _rows_for(c, l, c["lvl_off"][ids], width)


def compute_diff(old: ChalGraph, new: ChalGraph) -> tuple[list[int], list[int]]:
    """(changed_old, changed_new) node ids: new = ids beyond the old element
    count; old = ids whose logical CHAL content changed."""
    o, n = to_np(old), to_np(new)
    prev_count = old.n  # logical count (either graph may be node-padded)
    changed = o["level"][:prev_count] != n["level"][:prev_count]
    lmax = min(old.max_level, new.max_level)
    for l in range(lmax + 1):
        width = max(
            int(np.diff(o["lvl_off"][:prev_count, l : l + 2], axis=1).max(initial=1)),
            int(np.diff(n["lvl_off"][:prev_count, l : l + 2], axis=1).max(initial=1)),
            1,
        )
        a = _level_rows(o, l, prev_count, width)
        b = _level_rows(n, l, prev_count, width)
        changed |= (a != b).any(axis=1)
    changed_old = np.nonzero(changed)[0].tolist()
    changed_new = list(range(prev_count, new.n))
    return changed_old, changed_new


class PatchWriter:
    """Chunked patch generator (the reference's genPatch): call next_chunk
    until finished=True."""

    def __init__(self, chal: ChalGraph, changed_old, changed_new,
                 vectors: np.ndarray | None = None,
                 host_chal: dict | None = None):
        # host_chal: an existing host mirror (IncrementalSlim.host_chal), so
        # that the device arrays are not pulled back
        self.chal_np = host_chal if host_chal is not None else to_np(chal)
        self.cur_count = chal.n  # logical count
        self.old = list(changed_old)
        self.new = list(changed_new)
        self.vectors = vectors
        self.ind_old = 0
        self.ind_new = 0

    def _record(self, v: int, with_vec: bool) -> bytes:
        c = self.chal_np
        lv = int(c["level"][v])
        off = c["lvl_off"][v]
        start = int(off[0])
        rel = (off[1 : lv + 2] - start).astype(np.uint32)
        ids = c["nbr"][start : int(off[lv + 1])].astype(np.int32)
        out = struct.pack("<iii", v, lv, len(ids))
        out += rel.tobytes() + ids.tobytes()
        if with_vec and self.vectors is not None:
            out += np.asarray(self.vectors[v], np.float32).tobytes()
        return out

    def next_chunk(self, limit: int = 200 * 1024 * 1024) -> tuple[bytes, bool]:
        has_vec = self.vectors is not None
        dim = self.vectors.shape[1] if has_vec else 0
        rem_old = np.asarray(self.old[self.ind_old :], np.int32)
        rem_new = np.asarray(self.new[self.ind_new :], np.int32)
        node_ids = np.concatenate([rem_old, rem_new]).astype(np.int32)
        flags = np.concatenate(
            [np.zeros(len(rem_old), np.uint8), np.ones(len(rem_new), np.uint8)]
        )
        c = self.chal_np
        if len(node_ids):
            lv = c["level"][node_ids]
            off = c["lvl_off"][node_ids]
            totals = off[np.arange(len(node_ids)), lv + 1] - off[:, 0]
            sizes = 13 + 4 * (lv + 1) + 4 * totals
            if has_vec:
                sizes = sizes + np.where(flags > 0, 4 * dim, 0)
            # include the record that crosses the limit, as genPatch does
            n_take = int(np.searchsorted(np.cumsum(sizes), limit) + 1)
            n_take = min(n_take, len(node_ids))
        else:
            n_take = 0
        take_ids = node_ids[:n_take]
        take_flags = flags[:n_take]

        from ..utils import native

        body = native.patch_encode(
            take_ids, c["level"], c["lvl_off"], c["nbr"],
            self.vectors if has_vec else None, take_flags,
        ) if n_take else b""
        if body is None:  # numpy fallback
            parts = []
            for v, isn in zip(take_ids, take_flags):
                parts.append(struct.pack("<B", int(isn)))
                parts.append(self._record(int(v), with_vec=bool(isn) and has_vec))
            body = b"".join(parts)

        n_old_taken = int((take_flags == 0).sum())
        self.ind_old += n_old_taken
        self.ind_new += n_take - n_old_taken
        finished = self.ind_old >= len(self.old) and self.ind_new >= len(self.new)
        hdr = _HDR.pack(MAGIC, VERSION, self.cur_count, n_take,
                        1 if has_vec else 0, 1 if finished else 0, 0, dim)
        return hdr + body, finished


def decode_records(patch: bytes) -> dict:
    """A chunk's records as arrays: ids, levels, is_new (per record), rel
    i32[R, LEVEL_CAP + 2] (each level's end among the record's ids, levels
    past its own repeating its last), nbr (the ids, concatenated), nbr_off
    i64[R + 1] and vecs f32[R, dim] (rows of is_new records when the chunk
    has vectors). Native decoder, else a struct loop giving the same
    arrays. ValueError if ``patch`` is not a chunk."""
    magic, ver, cur_count, n, has_vec, _fin, _, dim = _HDR.unpack_from(patch,
                                                                      0)
    if magic != MAGIC or ver != VERSION:
        raise ValueError("bad patch header")
    has_vec = bool(has_vec)
    body = memoryview(patch)[_HDR.size:]
    from ..utils import native

    dec = native.patch_decode(body, has_vec, dim,
                              max_level_cap=LEVEL_CAP,
                              max_records=n) if n else None
    if dec is None:
        dec = dict(ids=np.empty(n, np.int32), levels=np.empty(n, np.int32),
                   rel=np.empty((n, LEVEL_CAP + 2), np.int32),
                   nbr_off=np.zeros(n + 1, np.int64),
                   vecs=np.empty((n, dim if has_vec else 1), np.float32),
                   is_new=np.empty(n, np.uint8))
        parts, pos = [], 0
        for r in range(n):
            isn, v, lv, total = struct.unpack_from("<Biii", body, pos)
            pos += 13
            if not 0 <= lv <= LEVEL_CAP or total < 0:
                raise RuntimeError(f"patch_decode failed: record {r}")
            dec["rel"][r, :lv + 1] = np.frombuffer(body, np.int32, lv + 1,
                                                   pos)
            dec["rel"][r, lv + 1:] = dec["rel"][r, lv]
            pos += 4 * (lv + 1)
            parts.append(np.frombuffer(body, np.int32, total, pos))
            pos += 4 * total
            dec["nbr_off"][r + 1] = dec["nbr_off"][r] + total
            dec["ids"][r], dec["levels"][r], dec["is_new"][r] = v, lv, isn
            if isn and has_vec:
                dec["vecs"][r] = np.frombuffer(body, np.float32, dim, pos)
                pos += 4 * dim
        dec["nbr"] = np.concatenate(parts) if parts else np.zeros(0,
                                                                  np.int32)
    dec.update(cur_count=cur_count, has_vec=has_vec, dim=dim)
    return dec


def apply_patch(chal: ChalGraph, patch: bytes, vectors=None):
    """The reference's patchFromStream: overwrite or extend node records.
    Idempotent: re-applying gives the same graph. Returns (graph, vectors):
    the store grows by the records that carry a vector.

    Nothing leaves the graph's device: the chunk is decoded on the host (no
    per-record Python), its records staged in one upload, the CHAL arrays
    repacked by ``repack`` (Kπ on the card, counted as
    ``client.apply_device``; ``repack_plain`` for CPU tensors) and the store
    (f32[N, d]: a host array or a tensor) grown where it lives, the shipped
    rows scattered by id. The one read-back is the new id total, inside
    ``repack``."""
    with trace.span("apply.decode"):
        dec = decode_records(patch)
        ids, levels = dec["ids"], dec["levels"]
        n_total = max(dec["cur_count"], chal.n)
        if len(ids) and (ids.min() < 0 or ids.max() >= n_total):
            raise ValueError("patch record id out of range")
        win = _last_of_each(ids)  # the record applied to each id
        lmax_new = max(chal.max_level, int(levels[win].max(initial=-1)))
        rel = dec["rel"][:, :lmax_new + 1]
        seg = np.diff(rel, axis=1, prepend=0)
        if (seg < 0).any() or (rel[:, -1] > np.diff(dec["nbr_off"])).any():
            raise ValueError("malformed patch record")
        if (seg[win] > max(chal.cap0, chal.cap)).any():
            raise ValueError("a patched row is wider than the graph's")
        if chal.nbr.shape[0] + int(dec["nbr_off"][-1]) >= 1 << 31:
            raise ValueError("patched graph too large for int32 offsets")
        grow = None
        if vectors is not None and dec["has_vec"]:
            new = np.nonzero(dec["is_new"])[0]
            if len(new):  # an id's row comes from its last new record
                take = new[_last_of_each(ids[new])]
                grow = ids[take], dec["vecs"][take]
    if chal.level.is_cuda:
        trace.count("client.apply_device", 1)
    with trace.span("apply.stage"):
        rec = stage_records(dec, lmax_new, chal.level.device)
    with trace.span("apply.pack"):
        graph = repack(chal, rec, n_total, lmax_new)
    if grow is not None:
        with trace.span("apply.grow"):
            vectors = _grow_store(vectors, n_total, *grow)
    return graph, vectors


def _last_of_each(ids: np.ndarray) -> np.ndarray:
    """The position of the last occurrence of each distinct id."""
    _, last = np.unique(ids[::-1], return_index=True)
    return len(ids) - 1 - last


def stage_records(dec: dict, lmax_new: int, dev) -> dict:
    """The decoded records on ``dev`` in one upload, as int32 views: ids,
    lv, start (i32[R + 1]), rel (levels [0, lmax_new]) and nbr."""
    n_rec = len(dec["ids"])
    rel = dec["rel"][:, :lmax_new + 1]
    host = np.concatenate([dec["ids"], dec["levels"],
                           dec["nbr_off"].astype(np.int32), rel.reshape(-1),
                           dec["nbr"][:int(dec["nbr_off"][-1])]])
    staged = _to_dev(host.astype(np.int32, copy=False), dev)
    cut = np.cumsum([n_rec, n_rec, n_rec + 1, rel.size])
    return dict(ids=staged[:cut[0]], lv=staged[cut[0]:cut[1]],
                start=staged[cut[1]:cut[2]],
                rel=staged[cut[2]:cut[3]].view(n_rec, lmax_new + 1),
                nbr=staged[cut[3]:])


def _grow_store(vectors, n_total: int, ids: np.ndarray, rows: np.ndarray):
    """The store f32[n_total, d] where ``vectors`` lives (a host array or a
    tensor): the old rows, zeros past them, then the shipped rows at their
    ids."""
    n, d = vectors.shape
    if rows.shape[1] != d or n > n_total:
        raise ValueError(f"cannot grow a store of {tuple(vectors.shape)} to "
                         f"{n_total} rows of {rows.shape[1]}")
    if not isinstance(vectors, torch.Tensor):
        grown = np.zeros((n_total, d), np.float32)
        grown[:n] = vectors
        grown[ids] = rows
        return grown
    dev = vectors.device
    grown = torch.empty((n_total, d), dtype=torch.float32, device=dev)
    grown[:n].copy_(vectors)
    grown[n:].zero_()
    grown.index_copy_(0, _to_dev(ids.astype(np.int64), dev),
                      _to_dev(rows, dev))
    return grown


def repack(chal: ChalGraph, rec: dict, n_total: int,
           lmax_new: int) -> ChalGraph:
    """Kπ (csrc/patch_apply.cu, three launches): the CHAL arrays of
    ``chal`` with the staged records ``rec`` (ids, lv, start, rel, nbr:
    int32 tensors on its device) applied, for nodes [0, n_total) and levels
    [0, lmax_new]. CPU tensors run ``repack_plain``; on the card, rows
    wider than ``MAX_WIDTH`` raise. The host reads back one pair of scalars
    (the new id total, the nodes with a level) to size ``nbr``."""
    if not chal.level.is_cuda:
        return repack_plain(chal, rec, n_total, lmax_new)
    dev = chal.level.device
    width = max(chal.cap0, chal.cap)
    if width > MAX_WIDTH:
        raise ValueError(f"Kπ sorts rows of up to {MAX_WIDTH} ids, not "
                         f"{width}")
    old = (chal.nbr, chal.lvl_off, chal.level)
    for t, name in zip(old, ("nbr", "lvl_off", "level")):
        cuda.require(t, torch.int32, name)
    n_rec = rec["ids"].shape[0]
    tiles = max(1, -(-n_total // SCAN_TILE))
    rec_of = torch.empty(n_total, dtype=torch.int32, device=dev)
    status = torch.empty(tiles + 1, dtype=torch.int64, device=dev)
    counters = torch.empty(2, dtype=torch.int32, device=dev)
    level = torch.empty(n_total, dtype=torch.int32, device=dev)
    lvl_off = torch.empty((n_total, lmax_new + 2), dtype=torch.int32,
                          device=dev)
    recs = (rec["lv"].data_ptr(), rec["rel"].data_ptr(), lmax_new + 1,
            rec["start"].data_ptr(), rec["nbr"].data_ptr())
    olds = (chal.nbr.data_ptr(), chal.lvl_off.data_ptr(),
            chal.lvl_off.shape[1], chal.level.data_ptr(), chal.n,
            chal.max_level, width, n_total)
    cuda.launch("patch_apply", rec["ids"].data_ptr(), n_rec,
                rec_of.data_ptr(), n_total, status.data_ptr(), tiles,
                entry="patch_map")
    cuda.launch("patch_apply", rec_of.data_ptr(), *recs, *olds,
                level.data_ptr(), lvl_off.data_ptr(), lmax_new + 2,
                status.data_ptr(), tiles, counters.data_ptr(),
                entry="patch_scan")
    total, n_real = counters.tolist()
    e_pad = max(1024, _next_pow2(total))
    nbr = torch.empty(e_pad, dtype=torch.int32, device=dev)
    cuda.launch("patch_apply", rec_of.data_ptr(), *recs, *olds,
                level.data_ptr(), lvl_off.data_ptr(), lmax_new + 2, lmax_new,
                nbr.data_ptr(), total, e_pad, entry="patch_copy")
    return _graph_like(chal, nbr, lvl_off, level, lmax_new, n_real)


def _graph_like(chal, nbr, lvl_off, level, max_level, n_real) -> ChalGraph:
    return ChalGraph(nbr, lvl_off, level, int(chal.entry), int(max_level),
                     int(chal.threshold_level), int(chal.cap0),
                     int(chal.cap), int(n_real))


def repack_plain(chal: ChalGraph, rec: dict, n_total: int,
                 lmax_new: int) -> ChalGraph:
    """Kπ's plain version, its three phases in PyTorch: (a) each node's
    last record (a max over record positions) and its new level; its rows
    per level: the shipped ones as shipped, an untouched node's first
    ``width`` old ids ascending (negative ones dropped), (b) the scan of
    the nodes' id counts into offsets, (c) the ids compacted in node and
    level order, ``-1`` past the total up to max(1024, next_pow2(total)).
    Runs on any device (the wrapper takes it for CPU tensors)."""
    prev, width = chal.n, max(chal.cap0, chal.cap)
    dev = chal.level.device
    big = torch.iinfo(torch.int32).max
    ids = rec["ids"].long()
    n_rec = ids.shape[0]
    rec_of = torch.full((n_total,), -1, dtype=torch.int64, device=dev)
    rec_of.scatter_reduce_(0, ids, torch.arange(n_rec, device=dev), "amax")
    hit = rec_of >= 0
    r_hit = rec_of[hit]
    level = torch.zeros(n_total, dtype=torch.int32, device=dev)
    level[:prev] = chal.level[:prev]
    level[hit] = rec["lv"][r_hit]
    old_off = chal.lvl_off[:prev].long()
    kept_old = ~hit[:prev]
    cols = torch.arange(width, device=dev)
    r_start = rec["start"][r_hit].long()
    shipped = torch.nn.functional.pad(rec["nbr"], (0, 1), value=-1)
    rows = []
    for l in range(lmax_new + 1):
        row = torch.full((n_total, width), -1, dtype=torch.int32,
                         device=dev)
        if l <= chal.max_level:
            a, b = old_off[:, l], old_off[:, l + 1]
            at = a[:, None] + cols
            seg = chal.nbr[at.clamp(0, chal.nbr.shape[0] - 1)]
            seg = torch.where((at < b[:, None]) & (seg >= 0), seg, big)
            seg = seg.sort(dim=1).values
            seg = torch.where(seg == big, -1, seg)
            keep = kept_old & (chal.level[:prev] >= l)
            row[:prev][keep] = seg[keep]
        if n_rec:
            rel = rec["rel"][r_hit].long()
            s = rel[:, l - 1] if l else torch.zeros_like(r_start)
            e = rel[:, l]
            at = ((r_start + s)[:, None] + cols).clamp(max=len(shipped) - 1)
            row[hit] = torch.where(cols < (e - s)[:, None], shipped[at], -1)
        rows.append(row)
    # (b) counts and offsets; (c) the ids in node, level, slot order
    mask = [(r >= 0) & (level >= l)[:, None] for l, r in enumerate(rows)]
    counts = torch.stack([m.sum(1) for m in mask], 1)
    lvl_off = torch.zeros((n_total, lmax_new + 2), dtype=torch.int64,
                          device=dev)
    lvl_off[:, 1:] = counts.cumsum(1)
    lvl_off += (counts.sum(1).cumsum(0) - counts.sum(1))[:, None]
    total = int(counts.sum())
    nbr = torch.full((max(1024, _next_pow2(total)),), -1, dtype=torch.int32,
                     device=dev)
    for l, (r, m) in enumerate(zip(rows, mask)):
        slot = lvl_off[:, l:l + 1] + m.long().cumsum(1) - 1
        nbr[slot[m]] = r[m]
    return _graph_like(chal, nbr, lvl_off.to(torch.int32), level, lmax_new,
                       int((level >= 0).sum()))

