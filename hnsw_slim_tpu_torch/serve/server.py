"""HTTP serving daemon: query + incremental-update protocol (port of
hnsw_slim_tpu/serve/server.py).

The server owns the mutable vanilla HNSW (on the card) and its Slim mirror;
/updateIndex inserts a batch, re-prunes what it touched
(``graph/incremental.py``) and ships only the changed-node patch;
/getLastBatch streams size-limited patch chunks with a finished flag. Wire
messages are the protobuf messages of ``serve/query.proto``, written and
read by ``serve/wire.py``; patches are the binary record stream of
``persist/patch.py``.

Concurrent /query requests within a small window are fused into one search
call (``_Batcher``). The port updates the graph, the vector store and the
dense serving rows in place, so a search and an update exclude each other:
searches take a reader lock that ``update_index`` and ``mark_delete`` take
as writers, and a query sees the index either before or after an update,
never part of one. The batched search reads the card back before it
releases the lock.

The server takes no ``SearchConfig`` from its caller: it serves the index's
own config and changes only ``ef`` (``set_ef``). ``SearchConfig.dynamic_ef``
is not served by the port; a Slim index whose config sets it raises at the
first search.

Left out from the JAX server: the ``prewarm`` call at start-up and the
``SLIM_TIMING`` prints (compile-shape and debug machinery; nothing here
compiles per shape, and ``last_update_stats`` / ``last_stats`` keep the
split). The serving graph keeps the JAX server's node padding
(``pad_chal_nodes`` to ``node_bucket``): the dense serving layouts take
their row capacity from it, so appended nodes fit without a re-densify
until a bucket fills.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import threading
import time
import zlib
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..config import HnswConfig, SlimConfig
from ..graph.incremental import IncrementalSlim, IncrementalSlimZero
from ..graph.types import pad_chal_nodes
from ..index.hnsw import HnswIndex
from ..index.slim import HnswSlimIndex
from ..persist import checkpoint
from ..persist import patch as patchlib
from ..utils import trace
from . import wire


class _RWLock:
    """Many readers or one writer; a waiting writer holds off new readers."""

    def __init__(self):
        self._cv = threading.Condition()
        self._readers = 0
        self._writing = False
        self._waiting = 0

    @contextlib.contextmanager
    def read(self):
        with self._cv:
            while self._writing or self._waiting:
                self._cv.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cv:
                self._readers -= 1
                self._cv.notify_all()

    @contextlib.contextmanager
    def write(self):
        with self._cv:
            self._waiting += 1
            while self._writing or self._readers:
                self._cv.wait()
            self._waiting -= 1
            self._writing = True
        try:
            yield
        finally:
            with self._cv:
                self._writing = False
                self._cv.notify_all()


class _HTTPServer(ThreadingHTTPServer):
    """A thread per request; a listen backlog for many clients connecting at
    once (socketserver's default of 5 resets the rest)."""

    daemon_threads = True
    request_queue_size = 1024


class _Batcher:
    """Fuse concurrent single-query requests into one search call:
    ``search(queries f32[B, d], k) -> (d f32[B, k], labels i64[B, k])``.
    The first request of a window leads: it waits ``window_ms``, then for the
    previous batch's search (one fused search at a time: a beam's latency
    hardly grows with the batch, so requests that arrive during a search
    join the next batch instead of starting a search of their own), takes
    every pending request and runs them as one batch. A request its leader
    missed runs alone."""

    def __init__(self, search, window_ms: float = 2.0):
        self.search = search
        self.window = window_ms / 1e3
        self.lock = threading.Lock()
        self.busy = threading.Lock()  # held by the fused search in flight
        self.pending: list = []
        # sizes of the last 4096 fused searches
        self.batch_sizes: deque = deque(maxlen=4096)

    def query(self, vec: np.ndarray, k: int):
        slot = {"vec": vec, "k": k, "done": threading.Event(), "out": None}
        with self.lock:
            self.pending.append(slot)
            leader = len(self.pending) == 1
        if leader:
            time.sleep(self.window)
            with self.busy:
                with self.lock:
                    batch, self.pending = self.pending, []
                kmax = max(s["k"] for s in batch)
                d, i = self.search(np.stack([s["vec"] for s in batch]), kmax)
            self.batch_sizes.append(len(batch))
            for r, s in enumerate(batch):
                s["out"] = (d[r, : s["k"]], i[r, : s["k"]])
                s["done"].set()
        slot["done"].wait(timeout=60.0)
        if slot["out"] is None:  # the leader raced away without us
            d, i = self.search(vec[None], k)
            return d[0], i[0]
        return slot["out"]


class SlimServer:
    # host-mirror growth quantum (rows): one amortized realloc per HOST_GROW
    # inserts instead of a full-mirror copy per batch
    HOST_GROW = 262144

    def __init__(
        self,
        base_vectors,
        hnsw_cfg: HnswConfig | None = None,
        slim_cfg: SlimConfig | None = None,
        build_strategy: str = "auto",
        host: str = "0.0.0.0",
        port: int = 8080,
        patch_chunk_bytes: int = 200 * 1024 * 1024,
        serve_index: str = "slim",  # "slim", "hnsw" (the unpruned graph)
        # or "slimzero" (the in-degree-guarded conversion)
        dense0: bool = True,  # dense level-0 and upper serving layouts,
        # refreshed in place across /updateIndex
        device=None,
    ):
        """``base_vectors``: float32 [N, d] to build an HnswIndex from (on
        ``device``, the card unless the caller passes another), or a built
        HnswIndex to take over as the mutable serving state."""
        self.hnsw_cfg = hnsw_cfg or HnswConfig()
        self.slim_cfg = slim_cfg or SlimConfig.from_ratios()
        self.serve_index = serve_index
        if isinstance(base_vectors, HnswIndex):
            self.hnsw = base_vectors
            self.hnsw_cfg = self.hnsw.cfg
        else:
            self.hnsw = HnswIndex(self.hnsw_cfg, strategy=build_strategy,
                                  device=device)
            self.hnsw.build(np.asarray(base_vectors, np.float32))
        self.device = self.hnsw.device
        metric = self.hnsw.cfg.metric
        inc_cls = (IncrementalSlimZero if serve_index == "slimzero"
                   else IncrementalSlim)
        self.inc = inc_cls(self.slim_cfg, metric=metric)
        chal = self.inc.full(self.hnsw.host_adj(), np.asarray(self.hnsw.levels),
                             int(self.hnsw.graph.entry), self.hnsw.vectors,
                             self.hnsw.vn)
        self.slim = HnswSlimIndex(metric=metric, device=self.device)
        # the unpadded graph is the persistence and patch source of truth
        self.chal_unpadded = chal
        self.node_bucket = max(4096,
                               1 << max(0, (chal.n - 1).bit_length() - 4))
        self.slim.graph = pad_chal_nodes(chal, self.node_bucket)
        self.slim.vectors = self.hnsw.vectors
        self.slim.vn = self.hnsw.vn
        if dense0 and serve_index != "hnsw":
            self.slim.host_chal = self.inc.host_chal
            self.slim.densify_level0()
            self.slim.densify_upper()
        # host vector mirror for patch encoding, in capacity-bucketed
        # buffers with logical-length views
        n0 = self.hnsw.graph.n
        cap0 = n0 + self.HOST_GROW
        self._vec_buf = np.empty((cap0, self.hnsw.vectors.shape[1]),
                                 np.float32)
        self._vec_buf[:n0] = self.hnsw.vectors[:n0].float().cpu().numpy()
        self._del_buf = np.zeros(cap0, bool)
        # external label layer (the reference's label_lookup_): internal
        # slot -> label; deleted slots are reused by later inserts
        self._lab_buf = np.arange(cap0, dtype=np.int64)
        self.vectors_np = self._vec_buf[:n0]
        self.deleted = self._del_buf[:n0]
        self.labels = self._lab_buf[:n0]
        self.next_label = int(n0)
        self.rw = _RWLock()
        self.batcher = _Batcher(self.search)
        self.pending_writer: patchlib.PatchWriter | None = None
        self.patch_chunk_bytes = patch_chunk_bytes
        # cumulative /query phase costs (reference hnsw_server.cc:41-95)
        self.query_cost = {"parse": 0.0, "search": 0.0, "serialize": 0.0,
                           "resp": 0.0, "n": 0}
        self.host, self.port = host, port
        self._httpd = None
        self._placeholders = None

    def _ensure_host_capacity(self, n: int) -> None:
        """Grow the host mirrors to >= n rows (amortized; see HOST_GROW)."""
        cap = len(self._vec_buf)
        if n <= cap:
            return
        new_cap = -(-n // self.HOST_GROW) * self.HOST_GROW + self.HOST_GROW
        live = len(self.vectors_np)
        vb = np.empty((new_cap, self._vec_buf.shape[1]), np.float32)
        vb[:live] = self._vec_buf[:live]
        db = np.zeros(new_cap, bool)
        db[:live] = self._del_buf[:live]
        lb = np.empty(new_cap, np.int64)
        lb[:live] = self._lab_buf[:live]
        self._vec_buf, self._del_buf, self._lab_buf = vb, db, lb
        self.vectors_np = vb[:live]
        self.deleted = db[:live]
        self.labels = lb[:live]

    # ---- operations -------------------------------------------------

    def search(self, queries: np.ndarray, k: int):
        """One batched search, as the /query batcher runs it, under the
        reader lock: deleted nodes are excluded in the kernel (the
        allowed-only track), internal ids map to labels. Returns numpy
        (d f32[B, k], labels i64[B, k])."""
        with self.rw.read():
            mask = ~self.deleted if self.deleted.any() else None
            index = self.hnsw if self.serve_index == "hnsw" else self.slim
            d, i = index.search(queries, k=k, filter_mask=mask)
            return d, np.where(i >= 0, self.labels[np.maximum(i, 0)], -1)

    def query(self, vec: np.ndarray, k: int):
        """(distances f32[k], labels i64[k]) of one query, batched with the
        concurrent ones."""
        return self.batcher.query(np.asarray(vec, np.float32), k)

    def set_ef(self, ef: int) -> None:
        self.slim.set_ef(ef)
        self.hnsw.set_ef(ef)

    def update_index(self, new_vectors: np.ndarray,
                     new_labels=None) -> patchlib.PatchWriter:
        """Insert + incremental re-prune + diff (hnsw_slim_server.cc:115-142,
        through graph/incremental.py instead of a whole-graph pass). Deleted
        slots are reused first (replace_deleted, deferred reinsert); the
        rest append. Holds the writer lock throughout."""
        with self.rw.write():
            with trace.span("server.insert"):
                reused, touched, level_changed, prev_count = self._insert(
                    new_vectors, new_labels)
            with trace.span("server.reprune"):
                # with both dense serving layouts the card never reads the
                # flat CHAL arrays: the re-prune packs to host arrays only
                # and the serving graph holds small device placeholders
                host_mode = (self.slim.dense0 is not None
                             and self.slim.dense_up is not None
                             and self.inc.host_chal is not None)
                chal, changed = self.inc.update(
                    self.hnsw.host_adj(), np.asarray(self.hnsw.levels),
                    int(self.hnsw.graph.entry), self.hnsw.vectors,
                    self.hnsw.vn, touched=touched,
                    level_changed=level_changed, device_pack=not host_mode)
                self.chal_unpadded = chal
            with trace.span("server.dense_refresh"):
                self._refresh_serving(chal, changed, host_mode, prev_count,
                                      reused)
            with trace.span("server.patch_encode"):
                # reused slots must ship their new vectors: classify as new
                reused_set = set(int(v) for v in reused)
                changed_old = sorted(
                    int(v) for v in changed
                    if v < prev_count and int(v) not in reused_set)
                changed_new = sorted(set(range(prev_count,
                                               self.hnsw.graph.n))
                                     | reused_set)
                writer = patchlib.PatchWriter(
                    chal, changed_old, changed_new, vectors=self.vectors_np,
                    host_chal=self.inc.host_chal)
            self.pending_writer = writer
            return writer

    def _insert(self, new_vectors, new_labels):
        """update_index's insert: slots reused first, the rest appended, the
        host mirrors kept in step. Returns (reused slots, touched vanilla
        rows, ids whose level changed, the node count before)."""
        new_vectors = np.asarray(new_vectors, np.float32)
        if new_labels is None:
            new_labels = range(self.next_label,
                               self.next_label + len(new_vectors))
        new_labels = np.asarray(list(new_labels), np.int64)
        prev_count = self.hnsw.graph.n

        free = np.nonzero(self.deleted)[0]
        n_reuse = min(len(free), len(new_vectors))
        reused = free[:n_reuse]
        touched = [np.asarray(reused, np.int64)]
        level_changed = np.zeros(0, np.int64)
        if n_reuse:
            t, level_changed = self.hnsw.replace_points(
                reused, new_vectors[:n_reuse])
            touched.append(t)
            self.vectors_np[reused] = new_vectors[:n_reuse]
            self.labels[reused] = new_labels[:n_reuse]
            self.deleted[reused] = False
        if n_reuse < len(new_vectors):
            touched.append(self.hnsw.add_points(new_vectors[n_reuse:]))
            n_now = self.hnsw.graph.n
            self._ensure_host_capacity(n_now)
            self._vec_buf[prev_count:n_now] = new_vectors[n_reuse:]
            self._lab_buf[prev_count:n_now] = new_labels[n_reuse:]
            self._del_buf[prev_count:n_now] = False
            self.vectors_np = self._vec_buf[:n_now]
            self.labels = self._lab_buf[:n_now]
            self.deleted = self._del_buf[:n_now]
        self.next_label = max(self.next_label,
                              int(new_labels.max(initial=0)) + 1)
        return reused, np.concatenate(touched), level_changed, prev_count

    def _refresh_serving(self, chal, changed, host_mode: bool,
                         prev_count: int, reused) -> None:
        """update_index's serving graph and dense layouts: the rows whose
        CHAL content changed, the appended and the reused slots refreshed
        in place, or the layouts rebuilt without a host mirror."""
        host_chal = self.inc.host_chal
        if host_mode:
            # host arrays carry the HNSW capacity padding (level -1
            # rows); round the level array up to the node bucket, as
            # pad_chal_nodes does
            n_src = len(host_chal["level"])
            n_pad = -(-n_src // self.node_bucket) * self.node_bucket
            lvl_pad = np.full(n_pad, -1, np.int32)
            lvl_pad[:n_src] = host_chal["level"]
            if self._placeholders is None:
                self._placeholders = (
                    torch.zeros(8, dtype=torch.int32, device=self.device),
                    torch.zeros((8, 8), dtype=torch.int32,
                                device=self.device))
            self.slim.graph = dataclasses.replace(
                chal, nbr=self._placeholders[0],
                lvl_off=self._placeholders[1],
                level=torch.as_tensor(lvl_pad, device=self.device),
                n_real=chal.n)
            self.slim.host_chal = host_chal
        else:
            self.slim.graph = pad_chal_nodes(chal, self.node_bucket)
            self.slim.host_chal = None
        self.slim.vectors = self.hnsw.vectors
        self.slim.vn = self.hnsw.vn
        if self.slim.dense0 is not None:
            if host_chal is not None:
                # refresh only the rows whose CHAL content changed, plus
                # the appended and reused slots
                upd_ids = np.concatenate([
                    changed,
                    np.arange(prev_count, self.hnsw.graph.n,
                              dtype=np.int64),
                    np.asarray(reused, np.int64)])
                self.slim.update_dense0(host_chal, upd_ids)
                if self.slim.dense_up is not None:
                    self.slim.update_dense_upper(host_chal, upd_ids)
            else:
                self.slim.densify_level0()
                if self.slim.dense_up is not None:
                    self.slim.densify_upper()

    def mark_delete(self, labels) -> int:
        """markDelete by external label (hnsw_slim_server_patch.cc:230-241).
        Returns the number of slots marked."""
        with self.rw.write():
            ids = np.nonzero(np.isin(self.labels,
                                     np.asarray(list(labels), np.int64)))[0]
            self.deleted[ids] = True
            return int(len(ids))

    def index_bytes(self) -> bytes:
        """The logical Slim index (no serving padding) as a save_slim file."""
        with self.rw.read():
            logical = HnswSlimIndex(metric=self.slim.metric,
                                    device=self.device)
            logical.graph = self.chal_unpadded
            logical.vectors = self.slim.vectors
            buf = io.BytesIO()
            checkpoint.save_slim(buf, logical)
            return buf.getvalue()

    def vector_range(self, start: int, count: int) -> np.ndarray:
        """Store rows [start, start + count) as f32, cut at the node count."""
        with self.rw.read():
            end = min(start + count, self.slim.graph.n)
            return self.slim.vectors[start:max(start, end)].float() \
                .cpu().numpy()

    def stats(self) -> dict:
        with self.rw.read():
            return {"n": int(self.hnsw.graph.n),
                    "index_bytes": self.slim.index_size()}

    # ---- HTTP -------------------------------------------------------

    def serve_forever(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _body(self):
                length = int(self.headers.get("Content-Length", 0))
                data = self.rfile.read(length)
                if self.headers.get("Content-Encoding") == "deflate":
                    data = zlib.decompress(data)
                return data

            def _send(self, data: bytes, ctype="application/octet-stream",
                      extra=None):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                for k, v in (extra or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def _query(self):
                # per-phase counters, reference hnsw_server.cc:41-95
                c = server.query_cost
                with trace.phase("server.parse", c, "parse"):
                    vec, k = wire.decode_query_request(self._body())
                with trace.phase("server.search", c, "search"):
                    d, labels = server.query(vec, k or 10)
                with trace.phase("server.serialize", c, "serialize"):
                    blob = wire.encode_query_response(labels, d)
                with trace.phase("server.send", c, "resp"):
                    self._send(blob)
                c["n"] += 1
                if c["n"] % 10000 == 0:
                    print(f"query {c['n']}: parse={c['parse']:.2f}s "
                          f"search={c['search']:.2f}s "
                          f"serialize={c['serialize']:.2f}s "
                          f"resp={c['resp']:.2f}s (cumulative)", flush=True)

            def _update(self):
                with trace.span("server.decode"):
                    ids, vecs = wire.decode_update_index_request(
                        self._body())
                    dim = server.vectors_np.shape[1]
                    vecs = (np.stack(vecs).astype(np.float32) if vecs
                            else np.zeros((0, dim), np.float32))
                # proto3 id 0 on every entry means the client set no ids:
                # the server assigns them
                writer = server.update_index(
                    vecs, new_labels=None if all(i == 0 for i in ids)
                    else ids)
                with trace.span("server.patch_encode"):
                    blob, finished = writer.next_chunk(
                        server.patch_chunk_bytes)
                trace.count("server.patch_bytes", len(blob))
                with trace.span("server.send"):
                    self._send(blob, extra={
                        "X-Patch-Finished": str(int(finished))})

            def _last_batch(self):
                w = server.pending_writer
                if w is None:
                    self._send(b"", extra={"X-Patch-Finished": "1"})
                    return
                with trace.span("server.patch_encode"):
                    blob, finished = w.next_chunk(server.patch_chunk_bytes)
                if finished:
                    server.pending_writer = None
                trace.count("server.patch_bytes", len(blob))
                with trace.span("server.send"):
                    self._send(blob, extra={
                        "X-Patch-Finished": str(int(finished))})

            def do_POST(self):
                try:
                    if self.path == "/query":
                        with trace.span("server.query"):
                            self._query()
                    elif self.path == "/setEf":
                        ef = wire.decode_set_ef_request(self._body())
                        server.set_ef(ef)
                        self._send(wire.encode_set_ef_response("ok", ef))
                    elif self.path == "/updateIndex":
                        with trace.span("server.update"):
                            self._update()
                    elif self.path == "/markDelete":
                        n = server.mark_delete(json.loads(self._body()))
                        self._send(json.dumps({"deleted": n}).encode(),
                                   "application/json")
                    else:
                        self.send_error(404)
                except Exception as e:  # pragma: no cover
                    self.send_error(500, str(e))

            def do_GET(self):
                try:
                    if self.path.startswith("/getIndex"):
                        # client bootstrap: the full slim checkpoint
                        self._send(server.index_bytes())
                    elif self.path.startswith("/getVectors"):
                        # bulk raw-vector range (putVector /
                        # getVectorFromBatch, hnswalg_slim.h:2254-2290)
                        q = parse_qs(urlparse(self.path).query)
                        arr = server.vector_range(
                            int(q.get("start", ["0"])[0]),
                            int(q.get("count", ["65536"])[0]))
                        self._send(np.ascontiguousarray(arr).tobytes(),
                                   extra={"X-Dim": str(arr.shape[1]),
                                          "X-Count": str(arr.shape[0])})
                    elif self.path == "/getLastBatch":
                        with trace.span("server.get_last_batch"):
                            self._last_batch()
                    elif self.path == "/stats":
                        self._send(json.dumps(server.stats()).encode(),
                                   "application/json")
                    else:
                        self.send_error(404)
                except Exception as e:  # pragma: no cover
                    self.send_error(500, str(e))

        self._httpd = _HTTPServer((self.host, self.port), Handler)
        self._httpd.serve_forever()

    def start_background(self):
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        while self._httpd is None:
            time.sleep(0.01)
        return t

    def shutdown(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
