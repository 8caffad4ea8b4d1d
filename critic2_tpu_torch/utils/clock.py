"""Section wall-clock bookkeeping (reference tictac/start_clock/
print_clock, src/tools_io@proc.F90:1276-1321)."""
from __future__ import annotations

import time
from contextlib import contextmanager

__all__ = ["tictac", "Clock"]


class Clock:
    def __init__(self):
        self.t0 = time.perf_counter()
        self.sections: dict[str, float] = {}

    @contextmanager
    def section(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.sections[name] = self.sections.get(name, 0.0) + \
                time.perf_counter() - t

    def report(self) -> str:
        lines = ["# section clocks (s)"]
        for k, v in sorted(self.sections.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {k:<28s} {v:10.3f}")
        lines.append(f"  {'TOTAL':<28s} "
                     f"{time.perf_counter() - self.t0:10.3f}")
        return "\n".join(lines)


GLOBAL = Clock()


def tictac(msg: str):
    """One-line timestamp print (reference tictac)."""
    print(f"-- {msg} : {time.perf_counter() - GLOBAL.t0:.3f} s --")
