"""A later change adds a configuration, a data model, a job kind, a
traffic mix, a cell and a per-layer metric as files and entries, and
edits no file the benchmark has."""
import hashlib
import json
import os
import subprocess
import sys
import time

import pytest

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

# a data model whose items are not a grid: a dict of a positive grid and
# a stack of complex states over its points
TOY_MODEL = '''
"""Data model `toy_states`: per item a positive (n1, n2, n3) grid and a
(M, N) complex128 stack of states over its N points, from the seed."""
import numpy as np
import torch


def make_pool(cfg, seed, npool, device):
    m = cfg["density"]
    shape = tuple(int(v) for v in m["grid"])
    n = int(np.prod(shape))
    g = torch.Generator(device="cpu").manual_seed(int(seed) % (1 << 63))
    pool = []
    for _ in range(npool):
        grid = 0.5 + torch.rand(shape, generator=g, dtype=torch.float64)
        re, im = torch.randn((2, int(m["states"]), n), generator=g,
                             dtype=torch.float64)
        pool.append({"grid": grid.to(device),
                     "stack": torch.complex(re, im).to(device)})
    return pool


def check_pool(cfg, pool, seed):
    out = []
    for item in pool:
        low = float(item["grid"].min())
        if not low > 0.0:
            raise ValueError(f"grid minimum {low!r} is not positive")
        out.append({"min": low})
    return out
'''

# the toy model with a check that refuses every pool
BROKEN_MODEL = TOY_MODEL + '''

def check_pool(cfg, pool, seed):
    raise ValueError("toy pool refused by its check")
'''

TOY_JOB = '''
"""Job `gram`: the stack's Gram matrix weighted by the grid,
G_ij = sum_n s_i(n) w(n) conj(s_j(n))."""
import numpy as np
import torch

CONTROL = torch.float32


def run(ctx, item):
    with ctx.span("analysis"):
        s = item["stack"]
        g = (s * item["grid"].reshape(-1)) @ s.conj().T
    return {"gram": g.cpu().numpy()}


def info(ctx):
    m = ctx.cfg["density"]
    return {"M": int(m["states"]), "N": int(np.prod(m["grid"]))}


def reference(ctx, item, dtype):
    real, cplx = ((np.float64, np.complex128) if dtype == torch.float64
                  else (np.float32, np.complex64))
    w = item["grid"].cpu().numpy().reshape(-1).astype(real)
    s = item["stack"].cpu().numpy().astype(cplx)
    return {"gram": np.einsum("in,n,jn->ij", s, w, s.conj())}


def as_output(ans):
    return dict(ans)


def compare(ctx, out, ans):
    ref = ans["gram"]
    return {"gram_gap": float(np.abs(out["gram"] - ref).max()
                              / np.abs(ref).max())}
'''

TOY_METRIC = '''
"""gram_least_ms: the least time of a job's ZGEMM on the card's FP64
Tensor Cores, 8 M^2 N real flops."""
from benchmark.lib import roofline


def read(run):
    M, N = run.info["M"], run.info["N"]
    return 1e3 * roofline.least_seconds_flops(8 * M * M * N)
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


def _add(bd, spec, files, configs=(), workloads=(), per_layer=()):
    """Write new files and entries into a copy of the benchmark."""
    for rel, text in files.items():
        assert not os.path.exists(os.path.join(bd, rel))
        os.makedirs(os.path.dirname(os.path.join(bd, rel)), exist_ok=True)
        with open(os.path.join(bd, rel), "w") as fh:
            fh.write(text)
    for name in configs:
        spec["configs"].append({"name": name, "source": "test",
                                "file": f"benchmark/configs/{name}.json",
                                "reduced": [], "why": "test"})
    for name in workloads:
        config, traffic = name.split(".")
        spec["workloads"].append({"name": name, "config": config,
                                  "traffic": traffic, "chips": 1,
                                  "why": "test"})
    spec["per_layer"].extend(per_layer)
    with open(os.path.join(os.path.dirname(bd), "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)


def _new_files(before, after):
    return {p for p in set(after) - set(before) if "__pycache__" not in p}


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
    _add(bd, spec, files, ["nacl-b1-24"], ["nacl-b1-24.mass"],
         [{"name": "jobs_in_window", "unit": "jobs", "better": "higher",
           "source": "host_clock", "layer": "test", "moves": "job_s",
           "workloads": ["nacl-b1-24.mass"]}])

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
    assert _new_files(before, after) == set(files)


TOY_CONFIG = {"name": "toy-states", "reduced": [],
              "density": {"model": "toy_states", "grid": [4, 4, 5],
                          "states": 6}}
TOY_FILES = {
    "data/toy_states.py": TOY_MODEL,
    "data/toy_broken.py": BROKEN_MODEL,
    "configs/toy-states.json": json.dumps(TOY_CONFIG),
    "configs/toy-broken.json": json.dumps(dict(
        TOY_CONFIG, name="toy-broken",
        density=dict(TOY_CONFIG["density"], model="toy_broken"))),
    "jobs/gram.py": TOY_JOB,
    "traffic/gram.json": json.dumps({"job": "gram", "pool": 3,
                                     "compare": "all"}),
    "limits/toy-states.gram.json": json.dumps({"gram_gap": 1e-10}),
    "limits/toy-broken.gram.json": json.dumps({"gram_gap": 1e-10}),
    "metrics/gram_least_ms.py": TOY_METRIC,
}


@pytest.fixture
def toy_bench(tiny_bench):
    """The tiny copy with the toy data model's configuration, job, cell
    and metric added; returns (benchmark dir, digests before, files)."""
    bd, spec = tiny_bench
    before = _digests(bd)
    _add(bd, spec, TOY_FILES, ["toy-states", "toy-broken"],
         ["toy-states.gram", "toy-broken.gram"],
         [{"name": "gram_least_ms", "unit": "ms", "better": "lower",
           "source": "host_clock", "layer": "test", "moves": "job_s",
           "workloads": ["toy-states.gram"]}])
    return bd, before


def test_a_data_model_of_states_runs_as_files(toy_bench):
    """A configuration whose items are a dict of a grid and complex
    states: its own data model, job, reference and metric, end to end."""
    bd, before = toy_bench
    cell = harness.Cell.load("toy-states.gram", bench_dir=bd)
    assert cell.data.__name__ == "bench_data_toy_states"
    res = harness.run_cell(cell, 2 ** 33 + 5, 0.3, False, "cpu",
                           time.perf_counter())
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"job_s", "setup_s"}
    assert res["checks"]["gram_gap"]["value"] < 1e-13

    def control(ctx, item):
        return cell.job.as_output(cell.job.reference(ctx, item,
                                                     cell.job.CONTROL))

    res = harness.run_cell(cell, 2 ** 33 + 5, 0.3, False, "cpu",
                           time.perf_counter(), run_job=control)
    assert res["correct"] is False
    run = harness.Run(info={"M": 6, "N": 80}, setup_s=0.0, walls=[1.0],
                      window_s=1.0, njobs=1, peak_bytes=0, counters={})
    # 8 M^2 N = 23,040 flops at 67 TFLOP/s
    assert harness.read_metrics(cell, run, "per_layer") == {
        "gram_least_ms": {"value": pytest.approx(23040 / 67e9, rel=1e-12),
                          "unit": "ms"}}
    after = _digests(bd)
    assert {k: after[k] for k in before} == before
    assert _new_files(before, after) == set(TOY_FILES)


def test_same_seed_same_toy_pool(toy_bench):
    import torch

    cell = harness.Cell.load("toy-states.gram", bench_dir=toy_bench[0])
    a, b, c = (cell.data.make_pool(cell.cfg, s, 2, "cpu")
               for s in (2 ** 40, 2 ** 40, 2 ** 40 + 1))
    for x, y, z in zip(a, b, c):
        for k in ("grid", "stack"):
            assert torch.equal(x[k], y[k]) and not torch.equal(x[k], z[k])


def test_a_model_with_no_file_fails_at_load(toy_bench):
    bd, _ = toy_bench
    path = os.path.join(bd, "configs", "toy-states.json")
    with open(path) as fh:
        cfg = json.load(fh)
    cfg["density"]["model"] = "no_such_model"
    with open(path, "w") as fh:
        json.dump(cfg, fh)
    with pytest.raises(FileNotFoundError, match="no_such_model"):
        harness.Cell.load("toy-states.gram", bench_dir=bd)


# run.py in the copy with the look for a card answered yes and the run
# kept on the CPU
FAKE_CARD = r'''
import runpy, sys
import torch
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
torch.cuda.get_device_name = lambda i=0: "cpu"
from benchmark.lib import harness
run_cell = harness.run_cell
harness.run_cell = lambda c, seed, s, trace, device, t0: run_cell(
    c, seed, s, trace, "cpu", t0)
runpy.run_path("benchmark/run.py", run_name="__main__")
'''


@pytest.mark.parametrize("name,rc", [("toy-states.gram", 0),
                                     ("toy-broken.gram", 1)])
def test_a_pool_its_check_refuses_stops_the_run(toy_bench, name, rc):
    """A data model whose check_pool raises: run.py exits with code 1
    before the warm-up and the window, and prints no result."""
    checkout = os.path.dirname(toy_bench[0])
    p = subprocess.run([sys.executable, "-c", FAKE_CARD, "--workload",
                        name, "--seed", "3000000019", "--seconds", "0.3",
                        "--trace", "0"], cwd=checkout, capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert p.returncode == rc, p.stderr[-3000:]
    if rc == 0:
        assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
    else:
        assert p.stdout == ""
        assert "toy pool refused by its check" in p.stderr
        assert "warm-up job" not in p.stderr
        assert "[bench] window" not in p.stderr
