"""Seconds of the server's incremental Slim re-prune (the port's
``server.reprune`` span, ``IncrementalSlim.update``) per ``/updateIndex``
request (``server.update``) of the traced window."""

from harness import program


def read(run):
    return program.seconds_per(run, ("server.reprune",), "server.update")
