"""The traced window: torch.profiler over the window, reduced to device busy
time, device time by kernel, the benchmark's host spans and the device's
idle gaps by the span the host was in. The profile goes through a Chrome
trace file, deleted once read.

Spans are the benchmark's own, around its calls into the system
(``Tracer.span``), from any thread: each is read from the host's monotonic
clock and moved onto the trace's clock by the window's own span, which is
a ``record_function`` range entered at a known host time. With tracing off
they cost nothing.
"""

from __future__ import annotations

import bisect
import contextlib
import re
import time

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench_window"


class Trace:
    """A parsed trace: ``window`` (start, end) in ns; ``ops`` [(name, start,
    end)] of device operations; ``spans`` {name: [(start, end)]};
    ``busy`` the merged device intervals inside the window."""

    def __init__(self, window, ops, spans):
        self.window = window
        self.ops = ops
        self.spans = spans
        w0, w1 = window
        clipped = sorted((max(s, w0), min(e, w1)) for _, s, e in ops
                         if e > w0 and s < w1)
        self.busy = merge(clipped)
        self._starts = self._cum = None

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def op_seconds(self, pattern: str) -> float:
        """Device seconds of the operations whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.ops if rx.search(n)) / 1e9

    def _busy_upto(self, t: int) -> int:
        if self._cum is None:
            self._starts = [s for s, _ in self.busy]
            self._cum = [0]
            for s, e in self.busy:
                self._cum.append(self._cum[-1] + e - s)
        j = bisect.bisect_right(self._starts, t)
        return self._cum[j] - max(0, self.busy[j - 1][1] - t) if j else 0

    def busy_within(self, s0: int, s1: int) -> int:
        """Device-busy ns inside [s0, s1]."""
        return self._busy_upto(s1) - self._busy_upto(s0)

    def span_self_ms(self, name: str) -> float | None:
        """Mean ms per ``name`` span of host time with no device operation
        under it: the span's length less the device busy time inside it."""
        spans = self.spans.get(name, [])
        if not spans:
            return None
        idle = sum((e - s) - self.busy_within(s, e) for s, e in spans)
        return idle / len(spans) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the device's idle
        time inside the window by the host span it fell in (the innermost
        span covering a gap's midpoint; "no_span" outside every span)."""
        by_op: dict = {}
        for n, s, e in self.ops:
            key = short_name(n)
            by_op[key] = by_op.get(key, 0) + (e - s)
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        gaps: dict = {}
        w0, w1 = self.window
        edges = [w0] + [t for iv in self.busy for t in iv] + [w1]
        # spans of one name follow one another: per name, the last span
        # that starts at or before a point is the only one that can cover it
        named = {n: sorted(ivs) for n, ivs in self.spans.items()
                 if n != WINDOW}
        starts = {n: [s for s, _ in ivs] for n, ivs in named.items()}
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 <= g0:
                continue
            mid = (g0 + g1) // 2
            inner = []
            for n, ivs in named.items():
                j = bisect.bisect_right(starts[n], mid) - 1
                if j >= 0 and ivs[j][1] >= mid:
                    inner.append((ivs[j][1] - ivs[j][0], n))
            label = min(inner)[1] if inner else "no_span"
            gaps[label] = gaps.get(label, 0) + (g1 - g0)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, v / 1e9] for n, v in ops],
                "idle_gaps": [[n, v / 1e9] for n, v in idle]}


def merge(intervals) -> list:
    out: list = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def short_name(name: str) -> str:
    """A device operation's name without return type, namespaces, template
    arguments and parameters ("beam_kernel", "Memcpy HtoD")."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith(("Memcpy", "Memset")):
        return " ".join(name.split()[:2])
    out, depth = [], 0
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif depth == 0:
            if ch == "(":
                break
            out.append(ch)
    base = "".join(out).strip().split(" ")[-1].split("::")[-1]
    return base or name[:64]


class Tracer:
    """Profiles the window when ``on``; ``span`` marks a host span.

    On a card the profiler records device activity alone (no host
    operator events, which cost more host time than some calls take): the
    window is bounded by two marker kernels launched on an idle card at
    known host times, and they carry the host clock onto the trace's. On
    the CPU the window is a ``record_function`` range instead."""

    MARKER = "spin_kernel"  # torch.cuda._sleep's kernel

    def __init__(self, on: bool, path=None):
        self.on = on
        self.path = path  # where the Chrome trace is written, then read
        self.prof = None
        self._window = None
        self._cuda = False
        self._t0 = 0
        self._spans: list = []  # (name, start ns, end ns), host clock
        self.trace: Trace | None = None

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return self._span(name)

    @contextlib.contextmanager
    def _span(self, name: str):
        t0 = time.monotonic_ns()
        try:
            yield
        finally:
            self._spans.append((name, t0, time.monotonic_ns()))

    def start(self) -> None:
        if not self.on:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        self._cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CUDA if self._cuda else ProfilerActivity.CPU]
        self.prof = profile(activities=acts, record_shapes=False,
                            with_stack=False, profile_memory=False)
        self.prof.__enter__()
        if self._cuda:
            torch.cuda.synchronize()
            self._t0 = time.monotonic_ns()
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        else:
            self._window = record_function(WINDOW)
            self._t0 = time.monotonic_ns()
            self._window.__enter__()

    def stop(self) -> None:
        if not self.on:
            return
        import torch

        if self._cuda:
            torch.cuda.synchronize()
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        else:
            self._window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.trace = parse(self.prof, self.path,
                           self.MARKER if self._cuda else None)
        self.prof = None
        shift = self.trace.window[0] - self._t0
        for name, a, b in self._spans:
            self.trace.spans.setdefault(name, []).append((a + shift,
                                                          b + shift))
        for ivs in self.trace.spans.values():
            ivs.sort()

    @contextlib.contextmanager
    def window(self):
        self.start()
        try:
            yield
        finally:
            self.stop()


def parse(prof, path, marker: str | None = None) -> Trace:
    """Reduce a finished profile to a Trace through its Chrome trace (the
    export every torch.profiler version writes alike; timestamps in us on
    one clock for host and device events). The window runs from the first
    ``marker`` kernel's start to the last one's, or is the ``WINDOW``
    range where no marker is given."""
    import json
    import os

    prof.export_chrome_trace(str(path))
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    ops, spans, marks = [], {}, []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        s = int(round(float(ev["ts"]) * 1e3))
        e = s + int(round(float(ev.get("dur", 0)) * 1e3))
        name = ev.get("name", "?")
        if cat in DEVICE_KINDS:
            if marker and marker in name:
                marks.append(s)
            else:
                ops.append((name, s, e))
        elif cat == "user_annotation":
            spans.setdefault(name, []).append((s, e))
    if marker:
        if len(marks) < 2:
            raise RuntimeError(f"the trace holds {len(marks)} marker kernels")
        return Trace((min(marks), max(marks)), ops, spans)
    win = spans.get(WINDOW)
    if not win:
        raise RuntimeError("the trace holds no window span")
    return Trace(win[0], ops, spans)
