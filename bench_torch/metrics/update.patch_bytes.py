"""Patch bytes the server sends (the port's counter ``server.patch_bytes``,
every chunk of ``/updateIndex`` and ``/getLastBatch``) per ``/updateIndex``
request (``server.update``) of the traced window."""

from harness import program


def read(run):
    return program.counter_per(run, "server.patch_bytes", "server.update")
