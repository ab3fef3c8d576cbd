"""Kα's share of its roofline as the seed scan of a batch search: the
least time the card could take for the scans of the traced window (one a
``search_call`` span, the work from ``roofline/topk_dist.py`` at the real
number of level >= 1 rows) over the device time of Kα's kernels
(``scan_kernel``, ``topk_merge``). None without a trace, a scan, or a peak
for the card."""

import torch

from harness.peaks import bound_s
from roofline.topk_dist import seed_scan_work

KERNELS = r"\bscan_kernel\b|\btopk_merge\b"


def read(run):
    tr = run.trace
    calls = len(tr.spans.get("search_call", []))
    busy = tr.op_seconds(KERNELS)
    if not calls or busy <= 0 or not run.cuda:
        return None
    flops, nbytes = seed_scan_work(run.traffic["batch"], run.info["n_up"],
                                   run.info["dim"],
                                   run.cfg["search"]["seed_width"])
    least = bound_s(torch.cuda.get_device_name(run.device), flops, nbytes)
    if least is None:
        return None
    return 100.0 * calls * least / busy
