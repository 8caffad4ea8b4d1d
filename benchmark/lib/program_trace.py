"""The program's own record of a traced window, and its spans laid on the
device trace's clock.

critic2_tpu_torch/utils/trace.py records spans (host clock, ns) and
counters while torch.profiler records, so in a `--trace 1` run the record
holds the traced window and nothing else; it keeps them out of the
profiler's record, where they would read as device work. A checkout of
the program without that module, or an empty record, gives None: the
metric is then left out.

Alignment: the i-th root span `intgrid` of the record is the call that
the i-th `analysis` span of the benchmark's jobs wraps; every span of
that call is shifted by the difference of the two starts, onto the
profiler's clock (us).

    python -m benchmark.lib.program_trace --workload nacl-b1-256.yt \
        --seed 7 --seconds 8

runs one traced window on the card and prints, as one JSON object, the
per-call offsets and the device idle inside the `analysis` spans by the
innermost program span around it.
"""
from __future__ import annotations

from . import stats

ROOT = "intgrid"
ANCHOR = "analysis"
# spans in which the card waits on the host for the whole span
HOST_STEPS = ("yt.neighbours", "yt.order", "intgrid.rows")


def record():
    """The program's record of the window, or None."""
    try:
        from critic2_tpu_torch.utils import trace
    except ImportError:
        return None
    rec = trace.read()
    return rec if rec["spans"] or rec["counters"] else None


def span_ms_per_job(run, name: str):
    """Milliseconds of the spans named `name`, summed, per job."""
    rec = record()
    if rec is None or run.njobs < 1:
        return None
    ns = sum(t1 - t0 for n, t0, t1, _, _ in rec["spans"] if n == name)
    return ns / 1e6 / run.njobs


def counter_per_job(run, name: str):
    """The program counter `name` over the window (0 where the record
    holds no such count), per job."""
    rec = record()
    if rec is None or run.njobs < 1:
        return None
    return rec["counters"].get(name, 0) / run.njobs


def aligned_calls(run, rec):
    """[(offset_us, [(name, start_us, end_us)])], one entry per `intgrid`
    call, its spans on the profiler's clock; None without a trace or a
    record, where a span was dropped, or where the calls and the
    `analysis` spans differ in number."""
    if run.trace is None or rec is None or rec["dropped"]:
        return None
    anchors = sorted(s for lab, s, _ in run.trace.spans if lab == ANCHOR)
    roots = sorted((sp for sp in rec["spans"]
                    if sp[0] == ROOT and sp[3] == -1), key=lambda sp: sp[1])
    if not roots or len(roots) != len(anchors):
        return None
    by_call = {}
    for name, t0, t1, _, call in rec["spans"]:
        by_call.setdefault(call, []).append((name, t0, t1))
    out = []
    for root, a in zip(roots, anchors):
        off = a - root[1] / 1e3
        out.append((off, [(n, t0 / 1e3 + off, t1 / 1e3 + off)
                          for n, t0, t1 in by_call[root[4]]]))
    return out


def _device_gaps(run) -> list:
    lo, hi = run.trace.window
    return stats.gaps([(s, e) for s, e, _ in run.trace.device], lo, hi)


def _overlap(gaps, intervals) -> float:
    """Length of the sorted disjoint `gaps` inside the union of the
    intervals."""
    total, i = 0.0, 0
    for s, e in stats.interval_union(intervals):
        while i < len(gaps) and gaps[i][1] <= s:
            i += 1
        j = i
        while j < len(gaps) and gaps[j][0] < e:
            total += min(e, gaps[j][1]) - max(s, gaps[j][0])
            j += 1
    return total


def idle_inside(run, intervals) -> float:
    """Microseconds of the traced window, inside the union of the
    intervals (us), in which no kernel or copy ran."""
    return _overlap(_device_gaps(run), intervals)


def idle_by_span(run, calls) -> dict:
    """{label: us} of device idle inside the `analysis` spans, by the
    innermost program span around it: a span's name, `intgrid` for the
    root's own time, or `analysis` outside the call."""
    gaps = _device_gaps(run)
    anchors = sorted((s, e) for lab, s, e in run.trace.spans
                     if lab == ANCHOR)
    out = {}
    for (a0, a1), (_, spans) in zip(anchors, calls):
        cuts = sorted({a0, a1} | {t for _, s, e in spans for t in (s, e)
                                  if a0 < t < a1})
        for lo, hi in zip(cuts, cuts[1:]):
            mid = 0.5 * (lo + hi)
            around = [(e - s, n) for n, s, e in spans if s <= mid <= e]
            lab = min(around)[1] if around else ANCHOR
            out[lab] = out.get(lab, 0.0) + _overlap(gaps, [(lo, hi)])
    return out


def main(argv=None) -> int:
    import argparse
    import json
    import time

    t_start = time.perf_counter()
    import torch

    from benchmark.run import power_limit_w

    from . import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    cell = harness.Cell.load(args.workload)
    runs = []
    read = harness.read_metrics

    def keep(cell_, run, kind):
        runs.append(run)
        return read(cell_, run, kind)

    harness.read_metrics = keep
    try:
        res = harness.run_cell(cell, args.seed, args.seconds, True,
                               torch.device("cuda", 0), t_start)
    finally:
        harness.read_metrics = read
    run = runs[0]
    calls = aligned_calls(run, record())
    offs = [off for off, _ in calls] if calls else []
    idle = idle_by_span(run, calls) if calls else {}
    total = sum(idle.values())
    outside = idle.get(ANCHOR, 0.0) + idle.get(ROOT, 0.0)
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "correct": res["correct"], "jobs": run.njobs,
        "calls": len(offs),
        "offset_us": [min(offs), max(offs)] if offs else None,
        "offset_spread_us": max(offs) - min(offs) if offs else None,
        "idle_ms_per_job": {k: v / 1e3 / run.njobs for k, v in
                            sorted(idle.items(), key=lambda kv: -kv[1])},
        "idle_share_below_intgrid": (1 - outside / total) if total else None,
        "counters": (record() or {}).get("counters"),
        "metrics": res["metrics"], "device": res["device"],
        "card": torch.cuda.get_device_name(0),
        "power_limit_w": power_limit_w()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
