"""Window statistics, all over every request of a window."""

from __future__ import annotations

import math
import statistics

import numpy as np


def window_rate(count: float, seconds: float) -> float:
    """Work per second over the whole window: every unit done over every
    second the window lasted."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return count / seconds


def nearest_rank(values, q: float) -> float:
    """The q-th percentile by nearest rank: the ceil(q/100 * n)-th smallest
    value (inf sorts last)."""
    v = np.sort(np.asarray(values, np.float64))
    if len(v) == 0:
        raise ValueError("no values")
    return float(v[max(0, math.ceil(q / 100.0 * len(v)) - 1)])


def latencies_from_due(due, done, ok) -> np.ndarray:
    """Seconds from each request's due time to its answer; a request that
    failed or never came back is inf, slower than every answered one."""
    due = np.asarray(due, np.float64)
    lat = np.asarray(done, np.float64) - due
    lat[~np.asarray(ok, bool)] = np.inf
    return lat


def p95_ms(due, done, ok) -> float:
    """The 95th percentile, in ms, of the latencies from due times. Where the
    rank falls on a failed request, the time from the first due time to the
    last answer or give-up (``done`` holds it for a failed request) stands
    in: finite, and above every answered request."""
    lat = latencies_from_due(due, done, ok)
    p = nearest_rank(lat, 95)
    if math.isinf(p):
        p = float(np.max(np.asarray(done, np.float64))
                  - np.min(np.asarray(due, np.float64)))
    return p * 1e3


def spread(values) -> float:
    """Distance between the first and third quartiles (Python's
    ``statistics.quantiles(values, n=4)``) as a share of the median."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
