"""Host milliseconds of the query rotation (the port's ``index.rotate``
span around Kη's launch on the query batch) per ``index.search`` call of
the traced window. None where the port records no such span."""

from harness import program

SPAN = "index.rotate"


def read(run):
    if not program.count(run, SPAN):
        return None
    return 1e3 * program.seconds_per(run, (SPAN,), "index.search")
