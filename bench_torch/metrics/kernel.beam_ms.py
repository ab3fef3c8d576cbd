"""Kβ's device time per batch search: the ``beam_kernel`` time of the
traced window over its ``search_call`` spans, in ms."""

KERNELS = r"\bbeam_kernel\b"


def read(run):
    tr = run.trace
    calls = len(tr.spans.get("search_call", []))
    busy = tr.op_seconds(KERNELS)
    if not calls or busy <= 0:
        return None
    return 1e3 * busy / calls
