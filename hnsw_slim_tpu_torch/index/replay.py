"""One CUDA graph per repeated batch search: the index host path's replay.

``HnswSlimIndex.search`` and ``HnswSlimQIndex.search`` hand a ``Replay``
the device chain that ``search_async`` enqueues, from uploaded queries to
the answers. For a call it takes, the host does three things: copy the
queries into a pinned input (span ``index.upload``; PyTorch's threaded
copy), launch one graph (``index.replay``), then wait and copy the call's
rows of one pinned output out, into host memory that several calls'
results share (``index.readback``). The graph is the chain as the eager
call launches it: first the query copy from the pinned input, then the
hand-written kernels and their glue, last d[:, :k], ids[:, :k], hops and
dcomp gathered into one output and copied back to pinned memory.

When it takes a call, from what the call shows (there is nothing to set):

- ``engages``: a CUDA device, at least one query, and no per-call tensor
  besides the queries (an allow-list or per-query entries stay eager);
- ``rows``: a batch replays padded to the next power of two rows, above
  ``FINE`` rows to the next of eight steps an octave (less than an eighth
  more rows), so that a batcher's varying sizes share a few graphs. (On an
  H100, a 200k-point Slim index at ef 64: 513 rows replayed as 1024 took
  0.78 ms a call against 0.91 eager; 2049 rows replayed as 2560, a
  quarter more, 1.65 against 1.41.) The
  chain searches each query row on its own, so the padding rows (queries
  of earlier calls) leave a call's rows bit for bit as an eager call of
  its own size gives them;
- ``key``: the padded shape, and every scalar and tensor the chain reads, a
  tensor by address, shape, strides and dtype (the queries are copied into
  a float32 input, so their own dtype is not part of it). A key is captured
  on its second sighting, so a shape seen once (one large call) never pays
  for a capture. Where the index grows or rebuilds a layout its tensors
  move, the key changes, and the stale graph ages out unreplayed; a tensor
  written in place keeps its key, and a replay reads what it holds then;
- at most ``SLOTS`` graphs, and as many keys seen once, the least recently
  used dropped first: room for every padded size up to ``FINE`` rows
  (eleven) of one index and one k, and a few larger;
- one caller at a time: a caller that finds the static buffers in use runs
  eagerly.

The chain's ``trace.count`` calls and kernel launch counts
(``ops/cuda.py launch``) are held back while it is captured, which runs
nothing (``trace.diverted``, ``cuda.held``), and counted after each replay:
the launches as captured, the counts of the call's rows alone (each count
of the chain is of its query rows: a host number of rows, or a device
tensor of one value a row), so a replay counts what an eager call of its
size counts. Counters of its own: ``index.captures`` and
``index.replays`` (over the count of ``index.search`` spans, the share of
calls replayed).
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from ..ops import cuda
from ..utils import trace

SLOTS = 16  # graphs kept, and keys remembered after one sighting
FINE = 1024  # rows above which a batch pads by less than an eighth
SLAB = 1 << 23  # bytes of host memory that several calls' results share


def engages(device, batch: int, *per_call) -> bool:
    """Whether a search may replay: on a CUDA device, with a non-empty
    batch, and every per-call argument in ``per_call`` None."""
    return (torch.device(device).type == "cuda" and batch > 0
            and all(a is None for a in per_call))


def rows(b: int) -> int:
    """The rows a batch of ``b`` >= 1 queries replays at: the next power of
    two up to ``FINE``, above it the next multiple of a sixteenth of the
    next power of two."""
    p = 1 << (b - 1).bit_length()
    if p <= FINE:
        return p
    step = p >> 4
    return -(-b // step) * step


def key(*parts) -> tuple:
    """A hashable signature of ``parts``: a tensor by (address, shape,
    strides, dtype, device), a dict by its sorted items, a tuple or list
    element by element, anything else (hashable) as it is."""
    return tuple(_sig(p) for p in parts)


def _sig(p):
    if isinstance(p, torch.Tensor):
        return ("tensor", p.data_ptr(), tuple(p.shape), p.stride(), p.dtype,
                p.device)
    if isinstance(p, dict):
        return tuple((k, _sig(v)) for k, v in sorted(p.items()))
    if isinstance(p, (tuple, list)):
        return tuple(_sig(v) for v in p)
    return p


def per_row(counts, b: int) -> list:
    """``counts`` of a chain of ``b`` query rows, [(name, n)] as
    ``trace.diverted`` collects them, as (name, n) with a host n counted a
    row; raises where a count is not one of the rows."""
    out = []
    for name, n in counts:
        if isinstance(n, torch.Tensor) and n.shape[:1] == (b,):
            out.append((name, n))
        elif not isinstance(n, torch.Tensor) and n % b == 0:
            out.append((name, n // b))
        else:
            raise ValueError(f"{name}: a count of the chain is not one of "
                             f"its {b} query rows")
    return out


def recount(counts, launched, b: int) -> None:
    """After a replay whose first ``b`` rows are the call's: count the
    captured launches, each of ``per_row``'s ``counts`` over those rows,
    and the replay."""
    cuda.counted(launched)
    for name, n in counts:
        trace.count(name, n[:b] if isinstance(n, torch.Tensor) else n * b)
    trace.count("index.replays", 1)


class Replay:
    """The graphs of one index, kept by key; see the module docstring."""

    def __init__(self):
        self._lock = threading.Lock()
        self._graphs: OrderedDict = OrderedDict()
        self._seen: OrderedDict = OrderedDict()

    def sight(self, k) -> str:
        """The rule for one call of key ``k``: "replay" where a graph is
        kept, "capture" on the second sighting, else "eager"."""
        if k in self._graphs:
            self._graphs.move_to_end(k)
            return "replay"
        if k in self._seen:
            del self._seen[k]
            return "capture"
        self._seen[k] = None
        if len(self._seen) > SLOTS:
            self._seen.popitem(last=False)
        return "eager"

    def keep(self, k, graph) -> None:
        """Keep ``graph`` under ``k``, evicting the least recently used
        beyond ``SLOTS``."""
        self._graphs[k] = graph
        while len(self._graphs) > SLOTS:
            self._graphs.popitem(last=False)

    def search(self, reads, queries: np.ndarray, width: int, chain, device):
        """(d f32[b, width], ids i32[b, width], hops i32[b], dcomp i32[b])
        as fresh host arrays from the graph of the padded shape and
        ``reads`` (what the chain reads besides the queries, as ``key``
        takes it), captured here on the key's second sighting; None where
        the caller runs eagerly. ``queries`` f32[b, D]; ``chain(q)``
        enqueues the search of device queries q f32[B, D] and returns its
        device tensors, d and ids at least ``width`` wide."""
        if not self._lock.acquire(blocking=False):
            return None
        try:
            shape = (rows(len(queries)), queries.shape[1])
            k = key(shape, *reads)
            step = self.sight(k)
            if step == "eager":
                return None
            if step == "capture":
                self.keep(k, _Graph(queries, shape, width, chain, device))
                trace.count("index.captures", 1)
            return self._graphs[k].run(queries)
        finally:
            self._lock.release()


class _Graph:
    """One captured chain with its static buffers: the pinned input f32[B, D]
    and its device twin, and one output (d, ids, hops and dcomp as i32
    words) on the device and pinned. The graph's first node copies the
    input to the card, its last copies the output back. The input starts
    as the capturing call's queries, repeated down its B rows."""

    def __init__(self, queries: np.ndarray, shape, width: int, chain,
                 device):
        b = shape[0]
        bw = b * width
        self.width = width
        self.inp = torch.from_numpy(
            queries[np.arange(b) % len(queries)]).pin_memory()
        self.q = torch.empty(shape, dtype=torch.float32, device=device)
        self.out = torch.empty(2 * bw + 2 * b, dtype=torch.int32,
                               pin_memory=True)
        self.staged = torch.empty(2 * bw + 2 * b, dtype=torch.int32,
                                  device=device)
        views = (self.staged[:bw].view(torch.float32).view(b, width),
                 self.staged[bw:2 * bw].view(b, width),
                 self.staged[2 * bw:2 * bw + b], self.staged[2 * bw + b:])
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.q.copy_(self.inp, non_blocking=True)
            with trace.diverted() as counts, cuda.held() as launched:
                res = chain(self.q)
            for v, r in zip(views, (res[0][:, :width], res[1][:, :width],
                                    *res[2:4])):
                v.copy_(r)
            self.out.copy_(self.staged, non_blocking=True)
        self.done = torch.cuda.Event()
        # the counted tensors are graph outputs that the chain never writes
        # after counting them: after a replay they hold that call's values
        self.counts, self.launched = per_row(counts, b), launched
        o = self.out.numpy()
        self.rows = (o[:bw].view(np.float32).reshape(b, width),
                     o[bw:2 * bw].reshape(b, width), o[2 * bw:2 * bw + b],
                     o[2 * bw + b:])
        self.slab, self.used = None, 0

    def fresh(self, n: int) -> np.ndarray:
        """Host memory for one call's ``n`` result words: the next piece of
        a slab of ``SLAB`` bytes that the next calls' results share, so
        that many calls pay for one allocation and fault its pages in
        together. (On an H100 machine's host, 4096 queries' 360 kB results
        kept by the caller cost 0.46 ms a call in allocations of their own,
        0.13 ms cut from slabs.) A piece is never reused; a result kept
        alive keeps its slab alive."""
        if self.slab is None or self.used + n > len(self.slab):
            self.slab = np.empty(max(n, SLAB // 4), np.int32)
            self.used = 0
        self.used += n
        return self.slab[self.used - n:self.used]

    def run(self, queries: np.ndarray):
        b, w = len(queries), self.width
        with trace.span("index.upload"):
            self.inp[:b].copy_(torch.from_numpy(queries))
        with trace.span("index.replay"):
            self.graph.replay()
            self.done.record()
            recount(self.counts, self.launched, b)
        with trace.span("index.readback"):
            self.done.synchronize()
            host = self.fresh(b * (2 * w + 2))
            bw = b * w
            got = (host[:bw].view(np.float32).reshape(b, w),
                   host[bw:2 * bw].reshape(b, w), host[2 * bw:2 * bw + b],
                   host[2 * bw + b:])
            for dst, src in zip(got, self.rows):
                dst[...] = src[:b]
        return got
