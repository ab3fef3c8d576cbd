"""Incremental-update patch protocol: diff, chunked encode, apply (port of
hnsw_slim_tpu/persist/patch.py; host numpy throughout, bytes identical to
the JAX package's).

The reference detects changed nodes by comparing each node's CHAL block with
the previous one, streams them in size-limited chunks with a `finished`
flag, and applies records in place. Here the comparison is logical
(per-level neighbor id sets in canonical sorted order) and application
rebuilds the flat CHAL arrays, on the device of the graph it is given.

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

from ..graph.types import ChalGraph

MAGIC = 0x48534C50  # 'HSLP'
VERSION = 1
_HDR = struct.Struct("<IIQIBBHI")


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


def apply_patch(
    chal: ChalGraph, patch: bytes, vectors: np.ndarray | None = None
) -> tuple[ChalGraph, np.ndarray | None]:
    """The reference's patchFromStream: overwrite or extend node records and
    rebuild the flat arrays on the device of ``chal``. Idempotent:
    re-applying gives the same graph. ``vectors`` (host f32[N, d]) grows by
    the records that carry one."""
    magic, ver, cur_count, n_records, has_vec, _fin, _, dim = _HDR.unpack_from(
        patch, 0
    )
    if magic != MAGIC or ver != VERSION:
        raise ValueError("bad patch header")
    pos = _HDR.size

    c = to_np(chal)
    prev_count = chal.n  # logical count (serving graphs may be node-padded)
    slices = {}  # v -> (level, [np arrays per level])
    new_vecs = {}
    from ..utils import native

    dec = native.patch_decode(
        patch[pos:], bool(has_vec), dim, max_level_cap=16,
        max_records=n_records,
    ) if n_records else None
    if dec is not None:
        for r in range(len(dec["ids"])):
            v, lv = int(dec["ids"][r]), int(dec["levels"][r])
            seg = dec["nbr"][dec["nbr_off"][r] : dec["nbr_off"][r + 1]]
            rel = dec["rel"][r, : lv + 1]
            starts = np.concatenate([[0], rel[:-1]]).astype(np.int64)
            slices[v] = (lv, [seg[s:e] for s, e in zip(starts, rel)])
            if dec["is_new"][r] and has_vec:
                new_vecs[v] = dec["vecs"][r]
    else:
        for _ in range(n_records):
            (is_new,) = struct.unpack_from("<B", patch, pos)
            pos += 1
            v, lv, total = struct.unpack_from("<iii", patch, pos)
            pos += 12
            rel = np.frombuffer(patch, np.uint32, lv + 1, pos)
            pos += 4 * (lv + 1)
            ids = np.frombuffer(patch, np.int32, total, pos)
            pos += 4 * total
            starts = np.concatenate([[0], rel[:-1]]).astype(np.int64)
            slices[v] = (lv, [ids[s:e] for s, e in zip(starts, rel)])
            if is_new and has_vec:
                new_vecs[v] = np.frombuffer(patch, np.float32, dim, pos)
                pos += 4 * dim

    n_total = max(int(cur_count), prev_count)
    lmax_new = max(
        [chal.max_level] + [lv for lv, _ in slices.values()]
    )
    width = max(chal.cap0, chal.cap)
    levels = np.zeros(n_total, np.int32)
    levels[:prev_count] = c["level"][:prev_count]
    # bulk-copy untouched nodes per level (vectorized; above level 0 only
    # the nodes that reach the level hold a row), then overwrite the patched
    # records
    per_level = []
    for l in range(lmax_new + 1):
        rows = np.full((n_total, width), -1, np.int32)
        if l == 0:
            rows[:prev_count] = _level_rows(c, l, prev_count, width)
        elif l <= chal.max_level:
            at = np.nonzero(c["level"][:prev_count] >= l)[0]
            rows[at] = _subset_rows(c, l, at, width)
        per_level.append(rows)
    for v, (lv, vrows) in slices.items():
        levels[v] = lv
        for l in range(lmax_new + 1):
            row = vrows[l] if l < len(vrows) else np.zeros(0, np.int32)
            per_level[l][v] = -1
            per_level[l][v, : len(row)] = row

    if vectors is not None and new_vecs:
        d = vectors.shape[1]
        grown = np.zeros((n_total, d), np.float32)
        grown[: len(vectors)] = vectors
        for v, vec in new_vecs.items():
            grown[v] = vec
        vectors = grown

    from ..graph.prune import pack_chal_arrays

    new_chal = pack_chal_arrays(
        per_level, levels,
        entry=int(chal.entry),
        max_level=lmax_new,
        threshold_level=chal.threshold_level,
        cap0=chal.cap0,
        cap=chal.cap,
        device=chal.level.device,
    )
    return new_chal, vectors
