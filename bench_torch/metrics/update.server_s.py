"""Seconds per batch of ``/updateIndex`` on the client's clock (insert,
re-prune, dense refresh, patch encode, the first chunk's transfer)."""


def read(run):
    s = run.rec.get("server_s") or []
    return sum(s) / len(s) if s else None
