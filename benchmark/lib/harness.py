"""The benchmark's driver: one cell, one seed, one window.

Everything of a cell is found by name. BENCHMARK.json names the cell's
configuration and traffic; the configuration is configs/<config>.json,
the traffic traffic/<traffic>.json, whose "job" names jobs/<job>.py, the
limits of the output check are limits/<cell>.json, and each metric is
read by metrics/<metric>.py. Adding a cell, a configuration, a traffic
mix or a metric adds files and entries; no file here changes.

A job module defines:
  run(ctx, rho) -> outputs on the host   the timed call into the program
  reference(ctx, rho, dtype) -> answer   the plain reference
  compare(ctx, outputs, answer) -> {number: value}
  counters() -> {name: cumulative count}  program counters (optional)
  info(ctx) -> dict                       sizes the metric readers need
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass

import numpy as np

from . import density

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names a run may not load
FORBIDDEN = ("jax", "jaxlib", "flax", "critic2_tpu")
# the program, which a data model may not load either
PROGRAM = "critic2_tpu_torch"
# a traced window lasts at most this long (a traffic file may set less,
# "trace_seconds"), so its record stays small
TRACE_SECONDS = 8.0


def log(msg: str):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is forbidden, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names}
                  & set(FORBIDDEN))


def data_model(cfg: dict, bench_dir: str = BENCH_DIR):
    """The module that makes the configuration's pool: lib/density.py for
    two_gaussians, else data/<model>.py. Raises if the file is missing or
    if loading it loads the program or a forbidden module."""
    name = cfg["density"]["model"]
    if name == "two_gaussians":
        return density
    path = os.path.join(bench_dir, "data", name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"data model {name!r} has no file {path}")
    before = {m.split(".")[0] for m in sys.modules}
    mod = load_module(path, "bench_data_" + name.replace(".", "_"))
    new = {m.split(".")[0] for m in sys.modules} - before
    bad = sorted(new & {*FORBIDDEN, PROGRAM})
    if bad:
        raise ImportError(f"data model {name!r} loads {bad}")
    return mod


@dataclass
class Cell:
    """A cell with everything its files say."""
    name: str
    entry: dict
    cfg: dict
    traffic: dict
    limits: dict
    job: object
    metrics: dict           # name -> entry of BENCHMARK.json
    data: object            # the configuration's data model
    bench_dir: str = BENCH_DIR

    @classmethod
    def load(cls, name: str, bench_dir: str = BENCH_DIR,
             spec_path: str | None = None) -> "Cell":
        spec = load_json(spec_path or os.path.join(os.path.dirname(
            bench_dir), "BENCHMARK.json"))
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = cells[name]
        traffic = load_json(os.path.join(bench_dir, "traffic",
                                         w["traffic"] + ".json"))
        job = load_module(os.path.join(bench_dir, "jobs",
                                       traffic["job"] + ".py"),
                          "bench_job_" + traffic["job"])
        metrics = {m["name"]: dict(m, kind=kind)
                   for kind in ("end_to_end", "per_layer")
                   for m in spec[kind]
                   if name in m.get("workloads", [name])}
        cfg = load_json(os.path.join(bench_dir, "configs",
                                     w["config"] + ".json"))
        return cls(name=name, entry=w, cfg=cfg, traffic=traffic,
                   limits=load_json(os.path.join(bench_dir, "limits",
                                                 name + ".json")),
                   job=job, metrics=metrics,
                   data=data_model(cfg, bench_dir), bench_dir=bench_dir)


@dataclass
class Context:
    """What a job sees: the cell's data and the device; `span` marks a
    step of the job in the profiler's record (read by a traced run)."""
    cfg: dict
    traffic: dict
    device: object

    @contextlib.contextmanager
    def span(self, label: str):
        import torch

        with torch.profiler.record_function("bench." + label):
            yield


@dataclass
class Run:
    """What the metric readers see."""
    info: dict
    setup_s: float
    walls: list
    window_s: float
    njobs: int
    peak_bytes: int
    counters: dict
    trace: object = None


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _finite(v) -> float:
    v = float(v)
    return v if math.isfinite(v) else 1e300


def _keep_plan(cell, seed, npool, est_jobs):
    """Job indices whose outputs are kept for the check: every job, or, for
    outputs too large to keep, one job per pool item drawn from the seed
    among those the window should reach."""
    if cell.traffic.get("compare", "all") == "all":
        return None
    rng = np.random.default_rng([int(seed), 7])
    rounds = max(1, int(0.8 * est_jobs) // npool)
    return {int(i + npool * rng.integers(rounds)) for i in range(npool)}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float, run_job=None) -> dict:
    """Set up, warm up, measure one window, check the outputs; returns the
    result line's dict. run_job(ctx, item) replaces the job's run (the
    control and the fault tests put theirs in the program's place)."""
    import torch

    job = cell.job
    run_job = run_job or job.run
    ctx = Context(cfg=cell.cfg, traffic=cell.traffic, device=device)
    npool = int(cell.traffic["pool"])
    a = time.perf_counter()
    log(f"{cell.name} seed {seed}: imports and context {a - t_start:.3f} s")
    pool = cell.data.make_pool(cell.cfg, seed, npool, device)
    _sync(device)
    b = time.perf_counter()
    cell.data.check_pool(cell.cfg, pool, seed)
    _sync(device)
    log(f"pool of {npool} {b - a:.3f} s, its checks "
        f"{time.perf_counter() - b:.3f} s")
    a = time.perf_counter()
    run_job(ctx, pool[-1])
    _sync(device)
    warm = time.perf_counter() - a
    log(f"warm-up job {warm:.3f} s")
    setup_s = time.perf_counter() - t_start
    keep = _keep_plan(cell, seed, npool, seconds / max(warm, 1e-3))

    counters = getattr(job, "counters", lambda: {})
    c0 = counters()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    window = min(seconds, float(cell.traffic.get(
        "trace_seconds", TRACE_SECONDS))) if trace else seconds
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA], acc_events=True)
        prof.__enter__()
    walls, kept, last = [], {}, {}
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < window:
        d = i % npool
        a = time.perf_counter()
        with ctx.span("job"):
            out = run_job(ctx, pool[d])
        walls.append(time.perf_counter() - a)
        if keep is None or i in keep:
            kept[i] = (d, out)
        last[d] = (i, out)
        i += 1
    t1 = time.perf_counter()
    log(f"window {t1 - t0:.3f} s, {len(walls)} jobs")
    if prof is not None:
        _sync(device)
        prof.__exit__(None, None, None)
        log(f"profiler stopped {time.perf_counter() - t1:.3f} s")
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    c1 = counters()
    # a sampled job the window did not reach: the last one of its item
    if keep is not None:
        have = {d for d, _ in kept.values()}
        for d, (j, out) in last.items():
            if d not in have:
                kept[j] = (d, out)
    del out, last
    run = Run(info=job.info(ctx), setup_s=setup_s, walls=walls,
              window_s=t1 - t0, njobs=len(walls), peak_bytes=int(peak),
              counters={k: c1[k] - c0.get(k, 0) for k in c1})
    if prof is not None:
        from . import trace as tr

        a = time.perf_counter()
        run.trace = tr.collect(prof)
        del prof
        log(f"trace read {time.perf_counter() - a:.3f} s")
    metrics = read_metrics(cell, run, "per_layer" if trace else "end_to_end")

    # the check: the plain reference of every pool item a kept job used
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    a = time.perf_counter()
    checks, failed = check_outputs(cell, ctx, pool, kept)
    log(f"check of {len(kept)} jobs {time.perf_counter() - a:.3f} s")
    result = {"correct": failed == 0 and len(kept) > 0,
              "attempted": len(walls), "failed": failed,
              "metrics": metrics, "device": {"memory_peak_bytes": int(peak)}}
    if run.trace is not None:
        from . import trace as tr

        result["device"].update(busy_s=run.trace.busy_s(),
                                window_s=run.trace.window_s)
        result["breakdown"] = tr.breakdown(run.trace)
    result["checks"] = checks
    return result


def check_outputs(cell: Cell, ctx: Context, pool, kept: dict):
    """Compare every kept output with the reference of its pool item.
    Returns ({number: {"value", "limit"}}, jobs that broke a limit)."""
    import torch

    worst = {}
    failed = 0
    by_item = {}
    for j, (d, out) in sorted(kept.items()):
        by_item.setdefault(d, []).append(out)
    for d, outs in sorted(by_item.items()):
        ans = cell.job.reference(ctx, pool[d], torch.float64)
        for out in outs:
            nums = cell.job.compare(ctx, out, ans)
            bad = False
            for k, v in nums.items():
                v = _finite(v)
                worst[k] = max(worst.get(k, -1e300), v)
                bad |= not v <= float(cell.limits[k])
            failed += int(bad)
        del ans
    checks = {k: {"value": v, "limit": float(cell.limits[k])}
              for k, v in sorted(worst.items())}
    for k in cell.limits:
        if k not in checks:
            raise KeyError(f"limit {k!r} of {cell.name} has no number")
    return checks, failed


def read_metrics(cell: Cell, run: Run, kind: str) -> dict:
    """The cell's metrics of one kind, each by its reader; a reader that
    finds nothing to read returns None and the metric is left out."""
    out = {}
    for name, m in cell.metrics.items():
        if m["kind"] != kind:
            continue
        reader = load_module(os.path.join(cell.bench_dir, "metrics",
                                          name + ".py"),
                             "bench_metric_" + name.replace(".", "_"))
        v = reader.read(run)
        if v is not None:
            out[name] = {"value": float(v), "unit": m["unit"]}
    return out
