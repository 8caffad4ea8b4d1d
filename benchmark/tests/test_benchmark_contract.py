"""BENCHMARK.json against the benchmark's contract, the files each entry
names, and the shape of the result line."""
import json
import os
import re
import subprocess
import sys

import pytest

from benchmark.lib import harness

ROOT = harness.ROOT
with open(os.path.join(ROOT, "BENCHMARK.json")) as _fh:
    SPEC = json.load(_fh)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ONE_LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_configs():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and ONE_LINE.match(c["source"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


def test_cells_and_their_files():
    names = [w["name"] for w in SPEC["workloads"]]
    assert len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and ONE_LINE.match(w["why"])
        assert w["chips"] == 1
        cell = harness.Cell.load(w["name"])
        for fn in ("run", "reference", "compare", "info", "as_output"):
            assert callable(getattr(cell.job, fn))
        assert cell.job.CONTROL is not None
        kinds = {m["kind"] for m in cell.metrics.values()}
        assert kinds == {"end_to_end", "per_layer"}
        assert "setup_s" in cell.metrics
        assert len([m for m in cell.metrics.values()
                    if m["kind"] == "end_to_end"]) >= 2


def test_metrics_have_readers_and_fields():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    seen = set()
    for kind in ("end_to_end", "per_layer"):
        for m in SPEC[kind]:
            assert m["name"] not in seen
            seen.add(m["name"])
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert os.path.exists(os.path.join(
                harness.BENCH_DIR, "metrics", m["name"] + ".py"))
            for w in m.get("workloads", []):
                assert w in {c["name"] for c in SPEC["workloads"]}
            if kind == "end_to_end":
                assert set(m) <= {"name", "unit", "better", "bound",
                                  "source", "workloads"}
                assert m["source"] in ("host_clock", "device_trace")
                assert 0.01 <= m["bound"] <= 0.25
            else:
                assert set(m) <= {"name", "unit", "better", "source",
                                  "layer", "moves", "workloads"}
                assert m["moves"] in e2e and ONE_LINE.match(m["layer"])
                assert m["source"] in ("device_trace", "program_span",
                                       "program_counter", "host_clock")
                if m["name"].endswith("_roofline_pct"):
                    assert m["unit"] == "%"


def test_limits_name_the_numbers_of_their_job(tiny_bench):
    import torch

    from benchmark.lib import density

    bd, spec = tiny_bench
    for w in spec["workloads"]:
        if not w["name"].endswith(".yt") or "-tiny" not in w["name"] \
                or "anthracene" in w["name"]:
            continue
        cell = harness.Cell.load(w["name"], bench_dir=bd)
        rho = density.make_pool(cell.cfg, 1, 1, "cpu")[0]
        ctx = harness.Context(cfg=cell.cfg, traffic=cell.traffic,
                              device="cpu")
        ans = cell.job.reference(ctx, rho, torch.float64)
        nums = cell.job.compare(ctx, cell.job.as_output(ans), ans)
        assert set(nums) == set(cell.limits)


def test_result_line_shape(tiny_bench):
    import time

    bd, _ = tiny_bench
    cell = harness.Cell.load("nacl-b1-256-tiny.yt", bench_dir=bd)
    res = harness.run_cell(cell, 2 ** 40 + 3, 0.5, False, "cpu",
                           time.perf_counter())
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {"job_s", "job_p90_s", "setup_s"} \
        or set(res["metrics"]) == {"job_s", "setup_s"}
    for v in res["metrics"].values():
        assert set(v) == {"value", "unit"}
    for v in res["checks"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(res, allow_nan=False)


def test_run_without_a_card_exits_nonzero_and_prints_nothing(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        SPEC["workloads"][0]["name"], "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0
    assert p.stdout == ""


def test_run_without_the_program_exits_nonzero(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        SPEC["workloads"][0]["name"], "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0
    assert p.stdout == ""


@pytest.mark.parametrize("mods,bad", [
    (["critic2_tpu_torch", "critic2_tpu_torch.ops"], []),
    (["critic2_tpu.ops.yt"], ["critic2_tpu"]),
    (["jax.numpy", "jaxlib", "flax.linen", "numpy"], ["flax", "jax",
                                                      "jaxlib"]),
])
def test_forbidden_modules_by_whole_top_level_name(mods, bad):
    assert harness.forbidden_modules(mods) == bad
