"""Spans and counters of the port, on the host's monotonic clock.

One facility for the whole package:

- ``span(name, **attrs)``: a context manager that records the name, the
  start and end from ``time.monotonic_ns()``, its own id, its parent (the
  innermost open span of the same thread), the thread and the attributes;
- ``count(name, n)``: a counter. Host integers add at once; a device tensor
  adds its sum on its device, read back once, at ``drain()``;
- ``phase(name, into, key)``: a span that also adds its seconds into the
  caller's dict ``into[key]``, whether recording or not (the update paths'
  per-phase ``seconds`` dicts);
- ``drain()``: the spans and counters recorded so far, cleared;
- ``diverted()``: a context in which this thread's ``count`` calls are
  collected into a list instead, recording or not: a CUDA graph capture
  takes them so, and the graph's owner counts them after each replay.

Recording is on while any ``torch.profiler`` session records, and only
then, so a profiled window gets the program's spans with nothing else to
set, and a long-lived process outside one keeps nothing. Off, ``span`` returns one shared null
context and ``count`` returns at once: two attribute reads, no clock read,
no allocation. On or off, nothing here synchronises the device or opens a
``record_function`` range: the device side of a span is read from the
device trace, after shifting the span onto that trace's clock (the
benchmark's ``harness/program.py``; ``add_to_chrome_trace`` for a trace
file).

Span names are dotted, ``layer.part`` (``index.search``, ``server.update``,
``client.sync``).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from collections import deque
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler


class Span(NamedTuple):
    """One finished span: ``start`` and ``end`` in ns of the host's
    monotonic clock; ``parent`` 0 at the top of its thread."""

    name: str
    start: int
    end: int
    id: int
    parent: int
    thread: int
    attrs: dict


_NULL = contextlib.nullcontext()


class _Open:
    """An open span, or a phase's stopwatch (``rec`` None: not recording)."""

    __slots__ = ("rec", "name", "attrs", "into", "key", "id", "parent",
                 "t0")

    def __init__(self, rec, name, attrs, into=None, key=None):
        self.rec, self.name, self.attrs = rec, name, attrs
        self.into, self.key = into, key

    def __enter__(self):
        rec = self.rec
        if rec is not None:
            stack = rec._stack()
            self.parent = stack[-1] if stack else 0
            self.id = next(rec._ids)
            stack.append(self.id)
        self.t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.monotonic_ns()
        rec = self.rec
        if rec is not None:
            rec._stack().pop()
            rec._spans.append(Span(
                self.name, self.t0, t1, self.id, self.parent,
                threading.get_ident(), self.attrs))
        if self.into is not None:
            self.into[self.key] = (self.into.get(self.key, 0.0)
                                   + (t1 - self.t0) / 1e9)
        return False


class Recorder:
    """Spans and counters of one process (``RECORDER``); see the module
    docstring."""

    def __init__(self):
        self._spans: deque = deque()
        self._host: dict = {}
        self._dev: dict = {}  # (name, device) -> int64 accumulator
        self._lock = threading.Lock()
        self._diverted = 0  # threads inside ``diverted``
        self._ids = itertools.count(1)
        self._local = threading.local()

    def recording(self) -> bool:
        return _profiler._is_profiler_enabled

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, **attrs):
        if not _profiler._is_profiler_enabled:
            return _NULL
        return _Open(self, name, attrs)

    def phase(self, name: str, into: dict, key: str | None = None,
              **attrs):
        """A span named ``name`` whose seconds also add into
        ``into[key or name]``."""
        rec = self if self.recording() else None
        return _Open(rec, name, attrs, into, name if key is None else key)

    def count(self, name: str, n) -> None:
        if self._diverted:
            sink = getattr(self._local, "sink", None)
            if sink is not None:
                sink.append((name, n))
                return
        if not _profiler._is_profiler_enabled:
            return
        if isinstance(n, torch.Tensor):
            with self._lock:
                acc = self._dev.get((name, n.device))
                if acc is None:
                    acc = self._dev[(name, n.device)] = torch.zeros(
                        (), dtype=torch.int64, device=n.device)
                acc.add_(n.sum(dtype=torch.int64))
        else:
            with self._lock:
                self._host[name] = self._host.get(name, 0) + int(n)

    @contextlib.contextmanager
    def diverted(self):
        """Collect this thread's ``count`` calls as [(name, n)], in order,
        instead of recording them, whether recording or not. Under a CUDA
        graph capture a device counter's add would be captured with the
        address of an accumulator that ``drain`` replaces; the owner of the
        graph counts the collected values after each replay instead."""
        sink: list = []
        prev = getattr(self._local, "sink", None)
        self._local.sink = sink
        with self._lock:
            self._diverted += 1
        try:
            yield sink
        finally:
            self._local.sink = prev
            with self._lock:
                self._diverted -= 1

    def drain(self) -> dict:
        """{"spans": [Span] in the order they ended, "counters": {name:
        int}}, and clears both. Reads each device counter back, once."""
        spans = []
        while True:
            try:
                spans.append(self._spans.popleft())
            except IndexError:
                break
        with self._lock:
            counters, self._host = self._host, {}
            dev, self._dev = self._dev, {}
        for (name, _), acc in dev.items():
            counters[name] = counters.get(name, 0) + int(acc)
        return {"spans": spans, "counters": counters}


ANCHOR = "trace.clock_anchor"


def add_to_chrome_trace(path, spans, t0: int) -> int:
    """Write ``spans`` into the Chrome trace file at ``path`` as complete
    events of category "program_span", on the trace's clock: the trace holds
    one ``ANCHOR`` range (a ``record_function``) entered just after
    ``time.monotonic_ns()`` read ``t0``. Returns the number written."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    anchors = [ev for ev in events
               if ev.get("name") == ANCHOR and ev.get("ph") == "X"]
    if not anchors:
        raise ValueError(f"{path}: no {ANCHOR} range to place spans by")
    anchor = min(anchors, key=lambda ev: float(ev["ts"]))
    shift_us = float(anchor["ts"]) - t0 / 1e3
    for s in spans:
        args = {"id": s.id, "parent": s.parent, **s.attrs}
        events.append({"ph": "X", "cat": "program_span", "name": s.name,
                       "pid": anchor.get("pid", 0), "tid": s.thread,
                       "ts": s.start / 1e3 + shift_us,
                       "dur": (s.end - s.start) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(spans)


RECORDER = Recorder()
span = RECORDER.span
phase = RECORDER.phase
count = RECORDER.count
drain = RECORDER.drain
diverted = RECORDER.diverted
recording = RECORDER.recording
