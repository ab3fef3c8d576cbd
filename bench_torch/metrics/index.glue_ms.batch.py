"""Host time of a batch ``search`` call with no device work under it: each
``search_call`` span's length less the device busy time inside it, mean over
the traced window, in ms."""


def read(run):
    return run.trace.span_self_ms("search_call")
