"""Seconds per batch of the client's ``sync_patches`` (the store pull, the
patch applies, the upload and the dense layout rebuild)."""


def read(run):
    s = run.rec.get("client_s") or []
    return sum(s) / len(s) if s else None
