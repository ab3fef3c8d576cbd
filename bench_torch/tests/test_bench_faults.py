"""The harness's look for a card skipped, each cell runs on the CPU at a
test size with its timed path broken underneath, and ``correct`` must come
out false; unbroken, it comes out true. The faults are the ones each cell
can have: an answer altered where it is produced, half of a batch left out
(the rest answered twice), a step that returns its state unchanged (stale
answers, an update the client never applies), and answers that are valid,
with exact distances, but not the neighbours: a beam stopped after one
step, inserted vectors never linked into the graph. No cell spans chips, so
no exchange between chips can be left out."""

import numpy as np
import pytest

import control
from hnsw_slim_tpu_torch.config import SearchConfig
from hnsw_slim_tpu_torch.graph.build import HnswBuilder
from hnsw_slim_tpu_torch.index.slim import HnswSlimIndex
from hnsw_slim_tpu_torch.persist import patch as patchlib
from hnsw_slim_tpu_torch.serve.client import SlimClient
from tiny import run_cell


def _altered(mp):
    plain = HnswSlimIndex.search

    def search(self, queries, k, *a, **kw):
        d, i = plain(self, queries, k, *a, **kw)
        i = i.copy()
        i[len(i) // 2, k // 2] = (i[len(i) // 2, k // 2] + 1) % self.graph.n
        return d, i
    mp.setattr(HnswSlimIndex, "search", search)


def _half(mp):
    plain = HnswSlimIndex.search

    def search(self, queries, k, *a, **kw):
        q = np.asarray(queries)
        h = max(1, (len(q) + 1) // 2)
        d, i = plain(self, q[:h], k, *a, **kw)
        rep = np.arange(len(q)) % h
        return d[rep], i[rep]
    mp.setattr(HnswSlimIndex, "search", search)


def _stale(mp):
    plain = HnswSlimIndex.search
    last = {}

    def search(self, queries, k, *a, **kw):
        out = plain(self, queries, k, *a, **kw)
        prev = last.get(len(queries))
        last[len(queries)] = out
        return prev if prev is not None else out
    mp.setattr(HnswSlimIndex, "search", search)


def _stops_early(mp):
    mp.setattr(SearchConfig, "iters", lambda self: 1)


def _sync_skipped(mp):
    mp.setattr(SlimClient, "sync_patches", lambda self, local, *a: local)


def _half_batch_sent(mp):
    plain = SlimClient.update_index

    def update_index(self, ids, vectors, compress=True):
        h = len(vectors) // 2
        return plain(self, list(ids)[:h], vectors[:h], compress)
    mp.setattr(SlimClient, "update_index", update_index)


def _unlinked(mp):
    mp.setattr(HnswBuilder, "_insert_range", HnswBuilder._insert_range)
    control.unlinked()  # monkeypatch puts the plain insert back


def _patch_altered(mp):
    plain = patchlib.apply_patch

    def apply_patch(graph, blob, vecs, *a, **kw):
        g, v = plain(graph, blob, vecs, *a, **kw)
        v = np.array(v, copy=True)
        v[-1, 0] += 0.5
        return g, v
    mp.setattr(patchlib, "apply_patch", apply_patch)


FAULTS = {
    "sift1m-slim.batch": {"altered": _altered, "half": _half,
                          "stale": _stale, "stops_early": _stops_early},
    "sift1m-server.update": {"unchanged": _sync_skipped,
                             "half": _half_batch_sent,
                             "altered": _patch_altered,
                             "unlinked": _unlinked,
                             "stops_early": _stops_early},
}
CASES = [(c, f) for c, fs in FAULTS.items() for f in fs]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_path_is_not_correct(cell, fault, monkeypatch):
    FAULTS[cell][fault](monkeypatch)
    res = run_cell(cell, seed=21)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", list(FAULTS))
def test_the_unbroken_path_is_correct(cell):
    res = run_cell(cell, seed=22)
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
