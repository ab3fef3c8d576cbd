"""Device-idle time under the port's ``index.seed``, ``index.descent`` and
``index.beam`` spans (the launch path of the seed scan or descent and of
the beam: the card waiting on the host), per ``index.search`` call of the
traced window, in ms."""

from harness import program

NAMES = ("index.seed", "index.descent", "index.beam")


def read(run):
    return program.idle_ms_per(run, NAMES, "index.search")
