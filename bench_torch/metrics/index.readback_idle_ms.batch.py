"""Device-idle time under the port's ``index.readback`` spans (distances
and ids copied to the host), per ``index.search`` call of the traced
window, in ms."""

from harness import program


def read(run):
    return program.idle_ms_per(run, ("index.readback",), "index.search")
