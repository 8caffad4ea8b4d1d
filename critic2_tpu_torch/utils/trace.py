"""The program's record of spans and counters, kept in memory on the host.

    with trace.span("yt.solve"):          # a timed step of the program
        ...
    trace.count("host_syncs")             # a host counter
    trace.count_device("yt_gs_pass.grid_barriers", counts, 0)

Recording is on while torch.profiler records, or inside `recording()`;
otherwise `span`, `count` and `count_device` cost one flag check and
touch nothing: no allocation, no `record_function`, no sync, no launch.
The spans stay out of the profiler's own record, whose readers would take
them for device work; a reader of both lines them up by the root spans.

A span keeps its name, start and end (`time.perf_counter_ns()`), the
index of its parent span (-1 for a root) and the id of the root call it
belongs to; spans nest in the order they open, in one thread. Past
`Record.cap` spans, or device counters, new ones are counted as dropped.
A device counter is an int64 tensor handed over without being read: it is
summed on the host only by `Record.read()`, one sync after the window.
"""
from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["Record", "RECORD", "span", "count", "count_device",
           "recording", "read", "reset"]

_profiling = torch.autograd._profiler_enabled


class Record:
    """Spans, host counters and pending device counters of one window."""

    def __init__(self, cap: int = 1 << 16):
        self.cap = cap
        self.reset()

    def reset(self):
        self.spans = []        # [name, start_ns, end_ns, parent, call]
        self.counters = {}
        self.pending = {}      # name -> [(tensor, index or None)]
        self.npending = 0
        self.dropped = 0
        self.calls = 0
        self._open = []        # indices of the spans open now

    def begin(self, name: str) -> int:
        t = time.perf_counter_ns()
        if len(self.spans) >= self.cap:
            self.dropped += 1
            return -1
        if self._open:
            parent = self._open[-1]
            call = self.spans[parent][4]
        else:
            parent = -1
            self.calls += 1
            call = self.calls
        self.spans.append([name, t, None, parent, call])
        self._open.append(len(self.spans) - 1)
        return len(self.spans) - 1

    def end(self, i: int):
        t = time.perf_counter_ns()
        if i >= 0:
            self.spans[i][2] = t
            self._open.pop()

    def count(self, name: str, n: int = 1):
        self.counters[name] = self.counters.get(name, 0) + n

    def count_device(self, name: str, t: torch.Tensor, i=None):
        if self.npending >= self.cap:
            self.dropped += 1
            return
        self.pending.setdefault(name, []).append((t, i))
        self.npending += 1

    def read(self) -> dict:
        """{"spans": [(name, start_ns, end_ns, parent, call)], "counters":
        {name: int}, "dropped": int}. Sums the pending device counters
        into the counters first (one host read per device and name)."""
        for name, items in self.pending.items():
            by_dev = {}
            for t, i in items:
                v = t.reshape(-1)[i] if i is not None else t.sum()
                by_dev.setdefault(t.device, []).append(v.to(torch.int64))
            for vals in by_dev.values():
                self.count(name, int(torch.stack(vals).sum()))
        self.pending.clear()
        self.npending = 0
        return {"spans": [tuple(s) for s in self.spans if s[2] is not None],
                "counters": dict(self.counters), "dropped": self.dropped}

    def summary(self) -> dict:
        """{"spans": {name: [count, seconds]}, "counters": {...}}: the
        totals of `read()`, for a one-line log."""
        rec = self.read()
        tot = {}
        for name, t0, t1, _, _ in rec["spans"]:
            n, s = tot.get(name, (0, 0.0))
            tot[name] = [n + 1, s + (t1 - t0) / 1e9]
        return {"spans": tot, "counters": rec["counters"]}


RECORD = Record()
_state = {"record": RECORD, "depth": 0}


class _Span:
    __slots__ = ("rec", "name", "i")

    def __init__(self, rec, name):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.i = self.rec.begin(self.name)

    def __exit__(self, *exc):
        self.rec.end(self.i)


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records one span while recording is on."""
    if _state["depth"] > 0 or _profiling():
        return _Span(_state["record"], name)
    return _OFF


def count(name: str, n: int = 1):
    """Add n to the host counter `name` while recording is on."""
    if _state["depth"] > 0 or _profiling():
        _state["record"].count(name, n)


def count_device(name: str, t: torch.Tensor, i=None):
    """Hand the device counter `name` the value t[i] (all of t summed
    when i is None) while recording is on; it is read by `read()`."""
    if _state["depth"] > 0 or _profiling():
        _state["record"].count_device(name, t, i)


@contextlib.contextmanager
def recording(record: Record | None = None):
    """Record into `record` (a new Record by default) inside the block;
    yields it. The record that was current before is current after."""
    rec = Record() if record is None else record
    prev = _state["record"]
    _state["record"] = rec
    _state["depth"] += 1
    try:
        yield rec
    finally:
        _state["depth"] -= 1
        _state["record"] = prev


def read() -> dict:
    """The default record's `read()`: what a profiled window recorded."""
    return RECORD.read()


def reset():
    RECORD.reset()
