"""The port's own spans and counters in a traced run.

The port records them (``hnsw_slim_tpu_torch/utils/trace.py``) while a
profiler session records, so only the traced window holds any. They are
read once a run (``load``), moved from the host's monotonic clock onto
the device trace's (``shift``), and added to ``run.trace.spans``: the metric
readers run before the result's breakdown, so ``breakdown.idle_gaps``
then names the innermost program span of each idle gap. A port without the
facility records nothing, and every reader here returns None.
"""

from __future__ import annotations

import bisect

# The query upload of a search (``index.upload``) is a synchronous copy from
# pageable memory, the one such copy a search makes: its span ends just
# after the copy does.
ANCHOR, COPY = "index.upload", "Memcpy HtoD"


def anchors(tr, t0: int, spans) -> list:
    """[(host start of an ``ANCHOR`` span, the shift it gives)], in time
    order: the span's copy's end less the span's end. The n-th such span
    issued the n-th such copy, so they pair in order where their numbers
    agree; else there are none. Each call pins the offset between the
    host's clock and the trace's on its own: on an H100 under the profiler
    the trace's device times stray from the host's by milliseconds over a
    few seconds of some runs, so no single shift holds for a window."""
    ups = sorted((s for s in spans if s.name == ANCHOR),
                 key=lambda s: s.start)
    copies = sorted((s, e) for n, s, e in tr.ops if n.startswith(COPY))
    if len(copies) != len(ups):
        return []
    return [(sp.start, e - sp.end) for sp, (_, e) in zip(ups, copies)]


def shift(tr, t0: int, spans) -> list:
    """ns to add to each of ``spans`` (host clock) to place it on the
    trace's clock: the shift of the anchor span that starts nearest it, or,
    with none, ``Tracer.stop``'s shift, ``tr.window[0] - t0``, which places
    spans late by the first marker kernel's launch latency (~0.4 ms on an
    H100 under the profiler) and carries the trace's straying."""
    fits = anchors(tr, t0, spans)
    if not fits:
        return [tr.window[0] - t0] * len(spans)
    starts = [a for a, _ in fits]
    out = []
    for sp in spans:
        j = bisect.bisect_left(starts, sp.start)
        if j == len(starts) or (j and sp.start - starts[j - 1]
                                < starts[j] - sp.start):
            j -= 1
        out.append(fits[j][1])
    return out


def load(run) -> dict | None:
    """{"spans": {name: [(start, end)]} on the trace's clock, "counters":
    {name: int}} of the traced window, or None where the port recorded
    nothing. Drains the port's buffer on the first call of a run."""
    if hasattr(run, "_program"):
        return run._program
    run._program = None
    tr = run.trace
    if tr is None:
        return None
    try:
        from hnsw_slim_tpu_torch.utils import trace as port_trace
    except ImportError:
        return None
    got = port_trace.drain()
    t0 = run.tracer._t0
    mine = [s for s in got["spans"] if s.start >= t0]
    spans: dict = {}
    for s, dt in zip(mine, shift(tr, t0, mine)):
        spans.setdefault(s.name, []).append((s.start + dt, s.end + dt))
    if not spans and not got["counters"]:
        return None
    for name, ivs in spans.items():
        ivs.sort()
        tr.spans.setdefault(name, []).extend(ivs)
        tr.spans[name].sort()
    run._program = {"spans": spans, "counters": dict(got["counters"])}
    return run._program


def count(run, name: str) -> int:
    """The number of ``name`` spans in the window."""
    p = load(run)
    return len(p["spans"].get(name, [])) if p else 0


def idle_ms_per(run, names, per: str) -> float | None:
    """Device-idle ms under the spans named in ``names`` (each span's length
    less the device busy time inside it), per ``per`` span."""
    p, n = load(run), count(run, per)
    if not p or not n:
        return None
    tr = run.trace
    idle = sum((e - s) - tr.busy_within(s, e)
               for name in names for s, e in p["spans"].get(name, []))
    return idle / n / 1e6


def seconds_per(run, names, per: str) -> float | None:
    """Host seconds of the spans named in ``names``, per ``per`` span."""
    p, n = load(run), count(run, per)
    if not p or not n:
        return None
    return sum(e - s for name in names
               for s, e in p["spans"].get(name, [])) / n / 1e9


def counter_per(run, name: str, per: str) -> float | None:
    """Counter ``name`` per ``per`` span."""
    p, n = load(run), count(run, per)
    if not p or not n or name not in p["counters"]:
        return None
    return p["counters"][name] / n
