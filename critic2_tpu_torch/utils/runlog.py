"""Structured one-line-JSON run log.

Role of the reference's timing/metrics apparatus (tictac section clocks,
src/tools_io@proc.F90:1276, surfaced through the BENCHMARK keyword): a
machine-readable record of what each driver did and how long it took.
Here every dispatched CLI keyword (and any code that calls `log()`
directly) appends ONE JSON line {"ts", "kw", "wall_s", ...} to the file
named by the CRITIC2_RUNLOG environment variable or `enable(path)`.
A keyword's line also carries what the program recorded while it ran
(utils/trace.py): "spans" {name: [count, seconds]} and "counters".
Disabled (zero-cost) when no sink is configured.
"""
from __future__ import annotations

import json
import os
import time

_path: str | None = None


def enable(path: str | None) -> None:
    """Set (or clear, with None) the run-log sink file."""
    global _path
    _path = path


def sink() -> str | None:
    return _path if _path is not None else os.environ.get("CRITIC2_RUNLOG")


def log(kw: str, wall_s: float | None = None, **fields) -> None:
    """Append one JSON line; never raises (metrics must not kill runs)."""
    p = sink()
    if not p:
        return
    rec = {"ts": round(time.time(), 3), "kw": kw}
    if wall_s is not None:
        rec["wall_s"] = round(wall_s, 4)
    rec.update(fields)
    try:
        with open(p, "a") as f:
            f.write(json.dumps(rec) + "\n")
    except OSError:
        pass
