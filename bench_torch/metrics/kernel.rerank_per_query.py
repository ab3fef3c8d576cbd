"""The rerank track's work count: the exact distances Kβ's rerank track
computes, one a popped node (the port's device counter
``index.rerank_dcomp``), over the queries searched (``index.queries``) in
the traced window. Beside ``kernel.beam_ms`` it tells a faster reranked
beam from one that pops fewer nodes."""

from harness import program


def read(run):
    p = program.load(run)
    if not p:
        return None
    c = p["counters"]
    if not c.get("index.queries") or "index.rerank_dcomp" not in c:
        return None
    return c["index.rerank_dcomp"] / c["index.queries"]
