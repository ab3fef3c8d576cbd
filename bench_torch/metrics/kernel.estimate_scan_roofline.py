"""Kα's share of its roofline as the estimate-mode seed scan of a SlimQ
batch search: the least time the card could take for the scans of the
traced window (one a ``search_call`` span inside the window, the work from
``roofline/estimate_scan.py`` at the real number of level >= 1 rows) over
the device time of Kα's estimate-mode kernels (``scan_kernel`` with its
estimate flag set) and of ``topk_merge``, which merges the scan's splits
(in a SlimQ window every Kα call is this scan). None without a trace, an
estimate-mode scan, or a peak for the card."""

import torch

from harness.peaks import bound_s
from roofline.estimate_scan import estimate_scan_work

MERGE = "topk_merge"


def template_args(name: str, kernel: str) -> list:
    """The top-level template arguments of ``kernel<...>`` in a demangled
    device operation's name, [] where the name holds no such kernel."""
    at = name.find(kernel + "<")
    if at < 0:
        return []
    args, depth, cur = [], 0, []
    for ch in name[at + len(kernel) + 1:]:
        if ch == "<":
            depth += 1
        elif ch == ">":
            if depth == 0:
                args.append("".join(cur).strip())
                return args
            depth -= 1
        elif ch == "," and depth == 0:
            args.append("".join(cur).strip())
            cur = []
            continue
        cur.append(ch)
    return []


def estimate_scan(name: str) -> bool:
    """Kα's scan kernel instantiated in estimate mode: ``scan_kernel<Tile,
    EST, T>`` with EST true."""
    args = template_args(name, "scan_kernel")
    return len(args) >= 2 and args[1] == "true"


def read(run):
    tr = run.trace
    calls = sum(1 for s, _ in tr.spans.get("search_call", [])
                if s >= tr.window[0])
    scan = sum(e - s for n, s, e in tr.ops if estimate_scan(n))
    if not calls or scan <= 0 or not run.cuda:
        return None
    busy = (scan + sum(e - s for n, s, e in tr.ops if MERGE in n)) / 1e9
    flops, nbytes = estimate_scan_work(
        run.traffic["batch"], run.info["n_up"], run.info["p"],
        run.info["clusters"], run.cfg["search"]["seed_width"])
    least = bound_s(torch.cuda.get_device_name(run.device), flops, nbytes)
    if least is None:
        return None
    return 100.0 * calls * least / busy
