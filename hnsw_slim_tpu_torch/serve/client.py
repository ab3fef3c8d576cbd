"""HTTP client: remote query + incremental index sync (port of
hnsw_slim_tpu/serve/client.py).

Counterpart of hnsw_client.cc (remote query) and
hnsw_slim_client_update(_patch).cc (batch insert + patch application): the
client holds its own Slim index and applies the binary patches the server
sends. Messages go through ``serve/wire.py``, the same bytes as protobuf's
``query_pb2``, so either engine's client talks to either engine's server.
"""

from __future__ import annotations

import http.client
import io
import json
import zlib

import numpy as np
import torch

from ..ops.distance import sq_norms
from ..persist import checkpoint
from ..persist import patch as patchlib
from ..utils import trace
from . import wire


class SlimClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 8080,
                 timeout: float = 120.0):
        self.host, self.port, self.timeout = host, port, timeout

    def _conn(self):
        return http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)

    def _request(self, method: str, path: str, body: bytes | None = None,
                 headers=None):
        c = self._conn()
        try:
            c.request(method, path, body, headers or {})
            r = c.getresponse()
            data = r.read()
            if r.status != 200:
                raise RuntimeError(f"{path}: HTTP {r.status} {data[:200]!r}")
            return data, r
        finally:
            c.close()

    def query(self, vector: np.ndarray, k: int = 10):
        """(distances f32[k], labels i64[k]) of one query."""
        data, _ = self._request("POST", "/query",
                                wire.encode_query_request(vector, k))
        labels, dist = wire.decode_query_response(data)
        return dist, labels

    def set_ef(self, ef: int) -> bool:
        data, _ = self._request("POST", "/setEf",
                                wire.encode_set_ef_request(ef))
        status, new_ef = wire.decode_set_ef_response(data)
        return status == "ok" and new_ef == ef

    def update_index(self, ids, vectors: np.ndarray, compress: bool = True):
        """Send a vector batch; returns the first patch chunk and its
        finished flag (zlib request compression, as
        hnsw_slim_client_update.cc:83-84)."""
        with trace.span("client.update"):
            body = wire.encode_update_index_request(ids, vectors)
            headers = {}
            if compress:
                body = zlib.compress(body)
                headers["Content-Encoding"] = "deflate"
            data, r = self._request("POST", "/updateIndex", body, headers)
        return data, r.getheader("X-Patch-Finished") == "1"

    def get_last_batch(self):
        data, r = self._request("GET", "/getLastBatch")
        return data, r.getheader("X-Patch-Finished") == "1"

    def bootstrap(self, device=None):
        """Fetch the server's full Slim index (a fresh client's join) onto
        ``device`` (the card unless the caller passes another)."""
        data, _ = self._request("GET", "/getIndex")
        return checkpoint.load_slim(io.BytesIO(data), device=device)

    def get_vectors(self, start: int, count: int) -> np.ndarray:
        data, r = self._request("GET",
                                f"/getVectors?start={start}&count={count}")
        n, dim = int(r.getheader("X-Count")), int(r.getheader("X-Dim"))
        return np.frombuffer(data, np.float32).reshape(n, dim)

    def stats(self) -> dict:
        """The server's node count and index bytes (/stats)."""
        data, _ = self._request("GET", "/stats")
        return json.loads(data)

    def mark_delete(self, ids) -> int:
        data, _ = self._request(
            "POST", "/markDelete", json.dumps([int(i) for i in ids]).encode())
        return json.loads(data)["deleted"]

    def sync_patches(self, local_index, first_chunk: bytes,
                     first_finished: bool):
        """Apply the first patch chunk, then drain /getLastBatch until done
        (hnsw_slim_client_update_patch.cc:177-190). The graph and the fp32
        store are patched where they live (on the card: Kπ, nothing
        pulled); the local index's dense serving layouts are rebuilt from
        the patched graph."""
        with trace.span("client.sync"):
            vecs = local_index.vectors[:local_index.graph.n].float()
            with trace.span("client.apply"):
                graph, vecs = patchlib.apply_patch(local_index.graph,
                                                   first_chunk, vecs)
            finished = first_finished
            while not finished:
                with trace.span("client.fetch"):
                    blob, finished = self.get_last_batch()
                if not blob:
                    break
                with trace.span("client.apply"):
                    graph, vecs = patchlib.apply_patch(graph, blob, vecs)
            local_index.graph = graph
            local_index.host_chal = None  # the graph changed under any mirror
            local_index.vectors = torch.as_tensor(vecs,
                                                  device=local_index.device)
            with trace.span("client.norms"):
                local_index.vn = sq_norms(local_index.vectors)
            with trace.span("client.densify"):
                if local_index.dense0 is not None:
                    local_index.densify_level0()
                if local_index.dense_up is not None:
                    local_index.densify_upper()
        return local_index
