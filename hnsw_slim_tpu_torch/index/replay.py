"""One host path for every index's batch search, and its CUDA graph replay.

Every index's ``search`` runs ``batch_search``; ``HnswSlimIndex.search`` and
``HnswSlimQIndex.search`` also hand it a ``Replay`` of the device chain that
``search_async`` enqueues, from uploaded queries to the answers. For a call
it takes, the host does three things: copy the queries (and the call's
per-row words, where it has any) into a pinned input (span
``index.upload``; PyTorch's threaded copy), launch one graph
(``index.replay``), then wait and copy the call's rows of one pinned output
out, into host memory that several calls' results share
(``index.readback``). The graph is the chain as the eager
call launches it: first the query copy from the pinned input, then the
hand-written kernels and their glue, last d[:, :k], ids[:, :k], hops and
dcomp gathered into one output and copied back to pinned memory.

When it takes a call, from what the call shows (there is nothing to set):

- ``engages``: a CUDA device, at least one query, and no per-call tensor
  besides the queries and the per-row words (an allow-list or per-query
  entries stay eager). Per-row words (``extra``, i32[X, b]: a tag-filtered
  search's need words and iteration caps) go up in the queries' copy, as
  the input's tail, so a call copies one input to the card however many
  words a row has;
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


def packed(queries: np.ndarray, extra: np.ndarray | None) -> np.ndarray:
    """One f32 host array: the queries' rows, then the per-row words
    ``extra`` i32[X, b] row by row, their bits as they are."""
    if extra is None:
        return queries
    out = np.empty(queries.size + extra.size, np.float32)
    out[:queries.size] = queries.reshape(-1)
    out[queries.size:].view(np.int32)[:] = extra.reshape(-1)
    return out


def unpacked(buf: torch.Tensor, b: int, d: int, nx: int):
    """(q f32[b, D], x i32[nx, b] or None): views of ``packed``'s layout."""
    q = buf[:b * d].view(b, d)
    if not nx:
        return q, None
    return q, buf[b * d:b * (d + nx)].view(torch.int32).view(nx, b)


def enqueue(queries, device, chain, extra=None):
    """``chain(q)``'s device tensors (``chain(q, x)``'s with per-row words
    ``extra`` i32[X, b]), q the ``queries`` uploaded onto ``device`` as
    f32[b, D] and x the words, in one copy (span ``index.upload``)."""
    with trace.span("index.upload"):
        q = np.asarray(queries, np.float32)
        buf = torch.as_tensor(packed(q, extra), device=device)
    if extra is None:
        return chain(buf)
    return chain(*unpacked(buf, len(q), q.shape[1], len(extra)))


def batch_search(index, queries, k: int, plan, *per_call,
                 graphs: Replay | None = None, words=None):
    """(d f32[b, k], ids i32[b, k]) as numpy, and the call's (hops, dcomp)
    into ``index.last_stats``: every index's ``search`` (span
    ``index.search``). ``plan()`` gives (reads, chain) as ``Replay.search``
    takes them; the call replays one of ``graphs`` where ``engages`` allows
    (``per_call``: the call's other per-call arguments), else it runs
    eagerly: ``enqueue``, then d and ids read back (``index.readback``).
    ``words(q)``, given q f32[b, D]: the call's per-row words i32[X, b]
    (span ``index.words``), which the chain takes as its second argument;
    they replay like the queries."""
    with trace.span("index.search"):
        q = np.asarray(queries, np.float32)
        extra = None
        if words is not None:
            with trace.span("index.words"):
                extra = words(q)
        reads, chain = plan()
        out = None
        if graphs is not None and engages(index.device, len(q), *per_call):
            out = graphs.search(reads, q, k, chain, index.device, extra)
        if out is None:
            d, ids, hops, dcomp = enqueue(q, index.device, chain, extra)
            with trace.span("index.readback"):
                d, ids = d[:, :k].cpu().numpy(), ids[:, :k].cpu().numpy()
        else:
            d, ids, hops, dcomp = out
    index.last_stats = (hops, dcomp)
    return d, ids


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

    def search(self, reads, queries: np.ndarray, width: int, chain, device,
               extra: np.ndarray | None = None):
        """(d f32[b, width], ids i32[b, width], hops i32[b], dcomp i32[b])
        as fresh host arrays from the graph of the padded shape and
        ``reads`` (what the chain reads besides the queries, as ``key``
        takes it), captured here on the key's second sighting; None where
        the caller runs eagerly. ``queries`` f32[b, D]; ``chain(q)``
        enqueues the search of device queries q f32[B, D] and returns its
        device tensors, d and ids at least ``width`` wide; with per-row
        words ``extra`` i32[X, b], ``chain(q, x)`` takes them as x
        i32[X, B]."""
        if not self._lock.acquire(blocking=False):
            return None
        try:
            nx = 0 if extra is None else len(extra)
            shape = (rows(len(queries)), queries.shape[1], nx)
            k = key(shape, *reads)
            step = self.sight(k)
            if step == "eager":
                return None
            if step == "capture":
                self.keep(k, _Graph(queries, shape, width, chain, device,
                                    extra))
                trace.count("index.captures", 1)
            return self._graphs[k].run(queries, extra)
        finally:
            self._lock.release()


class _Graph:
    """One captured chain with its static buffers: the pinned input (f32[B,
    D] queries, then X per-row words i32[X, B], in ``packed``'s layout) and
    its device twin, and one output (d, ids, hops and dcomp as i32
    words) on the device and pinned. The graph's first node copies the
    input to the card, its last copies the output back. The input starts
    as the capturing call's rows, repeated down its B rows."""

    def __init__(self, queries: np.ndarray, shape, width: int, chain,
                 device, extra: np.ndarray | None = None):
        b, d, nx = shape
        bw = b * width
        self.width = width
        pad = np.arange(b) % len(queries)
        self.inp = torch.from_numpy(packed(
            queries[pad], None if extra is None else extra[:, pad])
            .reshape(-1)).pin_memory()
        self.inp_q, self.inp_x = unpacked(self.inp, b, d, nx)
        dev = torch.empty(self.inp.shape, dtype=torch.float32, device=device)
        self.q, self.x = unpacked(dev, b, d, nx)
        self.out = torch.empty(2 * bw + 2 * b, dtype=torch.int32,
                               pin_memory=True)
        self.staged = torch.empty(2 * bw + 2 * b, dtype=torch.int32,
                                  device=device)
        views = (self.staged[:bw].view(torch.float32).view(b, width),
                 self.staged[bw:2 * bw].view(b, width),
                 self.staged[2 * bw:2 * bw + b], self.staged[2 * bw + b:])
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            dev.copy_(self.inp, non_blocking=True)
            with trace.diverted() as counts, cuda.held() as launched:
                res = chain(self.q) if self.x is None else chain(self.q,
                                                                 self.x)
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

    def run(self, queries: np.ndarray, extra: np.ndarray | None = None):
        b, w = len(queries), self.width
        with trace.span("index.upload"):
            self.inp_q[:b].copy_(torch.from_numpy(queries))
            if extra is not None:
                self.inp_x[:, :b].copy_(torch.from_numpy(extra))
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
