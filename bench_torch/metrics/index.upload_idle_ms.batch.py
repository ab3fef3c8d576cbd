"""Device-idle time under the port's ``index.upload`` spans (the query
batch copied to the card), per ``index.search`` call of the traced window,
in ms."""

from harness import program


def read(run):
    return program.idle_ms_per(run, ("index.upload",), "index.search")
