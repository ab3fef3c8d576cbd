"""Share of the traced window in which no operation ran on the device
(kernels, copies and sets, from torch.profiler's device trace), in %."""


def read(run):
    tr = run.trace
    if tr.window_s <= 0 or not tr.ops:
        return None
    return tr.idle_pct()
