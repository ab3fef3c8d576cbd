"""How much of Kβ's distance work in a label-filtered search could enter a
result: the scored candidates that passed their query's predicate (the
port's device counter ``index.filter_admit``) over all the beams' scored
candidates (``index.beam_dcomp``) in the traced window. Near the predicate's
allowed share, the traversal is blind to the predicate; a predicate-aware
traversal raises it. None where the port counts no admitted candidate."""

from harness import program


def read(run):
    p = program.load(run)
    if not p:
        return None
    c = p["counters"]
    if "index.filter_admit" not in c or not c.get("index.beam_dcomp"):
        return None
    return c["index.filter_admit"] / c["index.beam_dcomp"]
