"""What the host did during a phase of a run, for standard error: this
process's CPU seconds per second and context switches, the machine's CPU
time by state (where the kernel reports it), and the memory the kernel
holds free and as page cache. Times on the host's clock differ from run to
run more than the card's; this line is where to look for why."""

from __future__ import annotations

import os
import resource
import time

# /proc/stat's cpu line: user nice system idle iowait irq softirq steal
_STATES = {"user": (0, 1), "system": (2, 5, 6), "iowait": (4,), "steal": (7,)}


def _proc_stat() -> list[int]:
    try:
        with open("/proc/stat") as f:
            return [int(x) for x in f.readline().split()[1:9]]
    except (OSError, ValueError):
        return []


def _meminfo_gib(keys=("MemAvailable", "Cached")) -> dict:
    out = {}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                name, rest = line.split(":", 1)
                if name in keys:
                    out[name] = int(rest.split()[0]) / 2**20
    except (OSError, ValueError):
        pass
    return out


class Snapshot:
    def __init__(self):
        self.t = time.monotonic()
        self.stat = _proc_stat()
        self.ru = resource.getrusage(resource.RUSAGE_SELF)


def describe(a: Snapshot, b: Snapshot) -> str:
    """One line on what happened between two snapshots."""
    dt = b.t - a.t
    cpu_s = (b.ru.ru_utime + b.ru.ru_stime) - (a.ru.ru_utime + a.ru.ru_stime)
    parts = [f"{dt:.1f} s; this process {cpu_s / dt if dt > 0 else 0.0:.2f} "
             f"cpu-s/s, context switches voluntary "
             f"{b.ru.ru_nvcsw - a.ru.ru_nvcsw} involuntary "
             f"{b.ru.ru_nivcsw - a.ru.ru_nivcsw}"]
    d = [y - x for x, y in zip(a.stat, b.stat)]
    if sum(d) > 0:
        parts.append(f"machine ({os.cpu_count()} cpus) " + ", ".join(
            f"{name} {100.0 * sum(d[i] for i in idx) / sum(d):.1f}%"
            for name, idx in _STATES.items()))
    mem = _meminfo_gib()
    if mem:
        parts.append(", ".join(f"{k} {v:.1f} GiB" for k, v in mem.items()))
    return "; ".join(parts)
