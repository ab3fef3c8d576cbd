"""Seconds the client spends moving its vector store between the card and
the host in ``sync_patches`` (the port's ``client.pull`` and
``client.upload`` spans) per sync (``client.sync``) of the traced
window."""

from harness import program


def read(run):
    return program.seconds_per(run, ("client.pull", "client.upload"),
                               "client.sync")
