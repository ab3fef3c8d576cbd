#!/usr/bin/env python3
"""Compare the result values of two chip_smoke.py runs.

    python3 scripts/smoke_compare.py BEFORE.log AFTER.log

Reads the summary line of each log (the JSON object that starts with
``{"insert":``), flattens it, and compares every number whose key names a
result rather than a time: recall, hops, distance computations, edges and
degrees, index / vector / patch bytes, sizes and counts of rows, nodes and
chunks. Prints each value that differs and one JSON line with the counts;
exits 1 if any differs or a log has no summary line.
"""

from __future__ import annotations

import json
import re
import sys

RESULT = re.compile(r"recall|hops|dcomp|distance_computations|edge|degree|"
                    r"bytes|index_size|size|nodes|chunks|rows|floor|"
                    r"self_hit|changed|count|_n$|^n$", re.I)
TIME = re.compile(r"_s$|_ms$|qps|p50|p99|wall|seconds|time|launches",
                  re.I)


def summary(path: str) -> dict:
    with open(path, errors="replace") as fh:
        for line in fh:
            if line.startswith('{"insert":'):
                return json.loads(line)
    raise SystemExit(f"{path}: no summary line")


def leaves(obj, path=()):
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from leaves(v, path + (str(k),))
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            yield from leaves(v, path + (str(i),))
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        yield path, obj


def results(obj) -> dict:
    out = {}
    for path, v in leaves(obj):
        names = [p for p in path if not p.isdigit()]
        if any(TIME.search(p) for p in names):
            continue
        if names and RESULT.search(names[-1]):
            out["/".join(path)] = v
    return out


def main() -> int:
    a, b = (results(summary(p)) for p in sys.argv[1:3])
    diff = sorted(k for k in a.keys() | b.keys() if a.get(k) != b.get(k))
    for k in diff:
        print(f"{k}: {a.get(k)} -> {b.get(k)}")
    print(json.dumps({"compared": len(a.keys() & b.keys()),
                      "only_before": len(a.keys() - b.keys()),
                      "only_after": len(b.keys() - a.keys()),
                      "differ": len(diff)}))
    return 1 if diff else 0


if __name__ == "__main__":
    sys.exit(main())
