"""Reading torch.profiler's record of a traced window: device intervals,
the benchmark's own host spans, and the breakdown of device time and idle
gaps. Times are microseconds on the profiler's clock."""
from __future__ import annotations

from dataclasses import dataclass, field

from . import stats

SPAN_PREFIX = "bench."


@dataclass
class Trace:
    device: list = field(default_factory=list)  # (start, end, name)
    spans: list = field(default_factory=list)   # (label, start, end)

    @property
    def jobs(self) -> list:
        return [(s, e) for lab, s, e in self.spans if lab == "job"]

    @property
    def window(self) -> tuple:
        """First job's start to the last job's end."""
        jobs = self.jobs
        return min(s for s, _ in jobs), max(e for _, e in jobs)

    @property
    def window_s(self) -> float:
        lo, hi = self.window
        return (hi - lo) / 1e6

    def busy_s(self, lo=None, hi=None) -> float:
        """Seconds of [lo, hi] (default: the window) in which some kernel
        or copy ran: the union of the device intervals, not their sum."""
        if lo is None:
            lo, hi = self.window
        return stats.covered([(s, e) for s, e, _ in self.device],
                             lo, hi) / 1e6

    def kernels(self) -> list:
        """Device intervals of kernels (copies and memsets left out)."""
        return [d for d in self.device if not is_copy(d[2])]


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def collect(prof) -> Trace:
    """Device events and `bench.` spans of a finished profiler."""
    from torch.autograd import DeviceType

    tr = Trace()
    for e in prof.events():
        ours = e.name.startswith(SPAN_PREFIX)
        # the profiler mirrors each span on the device's timeline as an
        # annotation: it marks no device work
        if e.device_type == DeviceType.CUDA and not ours:
            tr.device.append((e.time_range.start, e.time_range.end, e.name))
        elif e.device_type == DeviceType.CPU and ours:
            tr.spans.append((e.name[len(SPAN_PREFIX):], e.time_range.start,
                             e.time_range.end))
    return tr


def short(name: str, width: int = 160) -> str:
    """A kernel's name without its argument list."""
    return (name.rsplit(">(", 1)[0] + ">" if ">(" in name else name)[:width]


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations with the most device time, and the idle time
    of the window by the innermost host span around each gap."""
    lo, hi = tr.window
    per_op = {}
    for s, e, name in tr.device:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            per_op[short(name)] = per_op.get(short(name), 0.0) \
                + (e - s) / 1e6
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    idle = {}
    for g0, g1 in stats.gaps([(s, e) for s, e, _ in tr.device], lo, hi):
        mid = 0.5 * (g0 + g1)
        around = [(e - s, lab) for lab, s, e in tr.spans if s <= mid <= e]
        lab = min(around)[1] if around else "outside the spans"
        n, t = idle.get(lab, (0, 0.0))
        idle[lab] = (n + 1, t + (g1 - g0) / 1e6)
    gaps = sorted(idle.items(), key=lambda kv: -kv[1][1])[:top]
    return {"device_ops": [[name, t] for name, t in ops],
            "idle_gaps": [[f"{lab} ({n} gaps)", t]
                          for lab, (n, t) in gaps]}
