"""Seconds the client spends rebuilding its copy's norms and both dense
serving layouts in ``sync_patches`` (the port's ``client.norms`` and
``client.densify`` spans) per sync (``client.sync``) of the traced
window."""

from harness import program


def read(run):
    return program.seconds_per(run, ("client.norms", "client.densify"),
                               "client.sync")
