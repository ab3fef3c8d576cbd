"""Kβ's work count: the beams' distance computations (the port's device
counter ``index.beam_dcomp``) over the queries searched (``index.queries``)
in the traced window. Beside ``kernel.beam_ms`` it tells a faster beam per
distance from a beam that computes fewer."""

from harness import program


def read(run):
    p = program.load(run)
    if not p:
        return None
    c = p["counters"]
    if not c.get("index.queries") or "index.beam_dcomp" not in c:
        return None
    return c["index.beam_dcomp"] / c["index.queries"]
