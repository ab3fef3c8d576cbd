"""The share of batch ``search`` calls served by one CUDA graph replay: the
port's counter ``index.replays`` over its ``index.search`` spans in the
traced window. None where the port counts no replay."""

from harness import program


def read(run):
    return program.counter_per(run, "index.replays", "index.search")
