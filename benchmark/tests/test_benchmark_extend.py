"""A later change adds a configuration, a job kind, a traffic mix, a cell
and a per-layer metric as files and entries, and edits no file the
benchmark has."""
import hashlib
import json
import os
import time

from benchmark.lib import harness

DUMMY_JOB = '''
"""Job `mass`: the grid sum of the density, read back to the host."""
import torch

CONTROL = torch.float32


def run(ctx, rho):
    with ctx.span("analysis"):
        return {"mass": float(rho.sum())}


def info(ctx):
    return {}


def reference(ctx, rho, dtype):
    return {"mass": float(rho.to(dtype).sum(dtype=torch.float64))}


def as_output(ans):
    return dict(ans)


def compare(ctx, out, ans):
    return {"mass_gap": abs(out["mass"] - ans["mass"])}
'''

DUMMY_METRIC = '''
"""jobs_in_window: a per-layer metric read from the run."""


def read(run):
    return float(run.njobs)
'''


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_config_job_metric_and_cell_as_files(tiny_bench):
    bd, spec = tiny_bench
    before = _digests(bd)
    with open(os.path.join(bd, "configs", "nacl-b1-256-tiny.json")) as fh:
        cfg = json.load(fh)
    cfg["name"] = "nacl-b1-24"
    cfg["grid"] = [24, 24, 24]
    for sp in cfg["density"]["species"].values():
        sp["core_width"] = sp["valence_width"] = 1.2
    files = {
        "configs/nacl-b1-24.json": json.dumps(cfg),
        "jobs/mass.py": DUMMY_JOB,
        "traffic/mass.json": json.dumps({"job": "mass", "pool": 2,
                                         "compare": "all"}),
        "limits/nacl-b1-24.mass.json": json.dumps({"mass_gap": 1e-9}),
        "metrics/jobs_in_window.py": DUMMY_METRIC,
    }
    for rel, text in files.items():
        assert not os.path.exists(os.path.join(bd, rel))
        with open(os.path.join(bd, rel), "w") as fh:
            fh.write(text)
    spec["configs"].append({"name": "nacl-b1-24", "source": "test",
                            "file": "benchmark/configs/nacl-b1-24.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "nacl-b1-24.mass",
                              "config": "nacl-b1-24", "traffic": "mass",
                              "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "jobs_in_window", "unit": "jobs",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "job_s",
                              "workloads": ["nacl-b1-24.mass"]})
    with open(os.path.join(os.path.dirname(bd), "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)

    cell = harness.Cell.load("nacl-b1-24.mass", bench_dir=bd)
    res = harness.run_cell(cell, 12345678901, 0.3, False, "cpu",
                           time.perf_counter())
    assert res["correct"] is True
    assert set(res["metrics"]) == {"job_s", "setup_s"}
    run = harness.Run(info={}, setup_s=0.0, walls=[1.0, 1.0],
                      window_s=2.0, njobs=2, peak_bytes=0, counters={})
    assert harness.read_metrics(cell, run, "per_layer") == {
        "jobs_in_window": {"value": 2.0, "unit": "jobs"}}
    # every file the benchmark had is as it was
    after = _digests(bd)
    assert {k: after[k] for k in before} == before
    new = {p for p in set(after) - set(before) if "__pycache__" not in p}
    assert new == set(files)
