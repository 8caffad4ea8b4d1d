"""The Bader cell's files on the CPU at a test size: the configuration
(its entry, the grid the crystal's operations keep, widths the full grid
resolves), the density on scaled-down grids, the job against its plain
reference within the cell's limits, the float32 control and broken
outputs outside them, a whole run, the metric readers, and what the
reference loads."""
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from conftest import tiny_config

from benchmark.lib import density, harness, program_trace
from benchmark.lib.trace import Trace

CELL = "hematite-r3c.bader"
CONFIG = "hematite-r3c"
METRICS = ("bader_walk_ms", "bader_basins_ms", "bader_walker_steps_per_job",
           "bader_segments_per_job", "bader_walk_roofline_pct",
           "bader_walk_launches_per_job")


def small_config() -> dict:
    """The configuration at 27 x 27 x 72, a grid every operation of R-3c
    keeps (spacing 0.361 bohr): every width is raised to 0.85 bohr, 2.1
    spacings at its narrowest draw (a floor under the valence widths
    too, unlike conftest.tiny_config's 1.3 times the floor, which merges
    O maxima into Fe ones on some draws)."""
    cfg = tiny_config(CONFIG, (27, 27, 72))
    for sp in cfg["density"]["species"].values():
        sp["core_width"] = max(sp["core_width"], 0.85)
        sp["valence_width"] = max(sp["valence_width"], 0.85)
    return cfg


def _full():
    with open(os.path.join(harness.BENCH_DIR, "configs",
                           CONFIG + ".json")) as fh:
        return json.load(fh)


def test_the_configuration_and_its_entry():
    cfg = _full()
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    entry, = [c for c in spec["configs"] if c["name"] == CONFIG]
    assert entry["source"] == cfg["source"] and len(cfg["source"]) <= 200
    assert entry["reduced"] == cfg["reduced"] == []
    st = cfg["structure"]
    assert len(st["x_frac"]) == 30
    assert [st["species"][i]["name"] for i in st["species_of"]].count(
        "Fe") == 12
    assert density.electrons(cfg) == 204.0
    assert len(st["symmetry"]["rotations"]) == 36
    a = np.asarray(st["lattice_bohr"])
    assert abs(np.linalg.det(a)) == pytest.approx(2042.869, abs=1e-3)
    cos = a[:, 0] @ a[:, 1] / np.linalg.norm(a[:, 0]) / np.linalg.norm(
        a[:, 1])
    assert cos == pytest.approx(-0.5, abs=1e-12)        # gamma = 120
    # every operation maps the full grid onto itself
    for rot, tr in zip(st["symmetry"]["rotations"],
                       st["symmetry"]["translations"]):
        density._grid_map(rot, tr, cfg["grid"])
    density.draw(cfg, 1, 64)          # raises on a width under 2 spacings
    w, = [w for w in spec["workloads"] if w["name"] == CELL]
    assert (w["config"], w["traffic"], w["chips"]) == (
        CONFIG, "bader-pool4", 1)
    assert harness.data_model(cfg) is density


@pytest.mark.parametrize("cfg", [small_config(),
                                 tiny_config(CONFIG, (54, 54, 144))],
                         ids=["27x27x72", "54x54x144"])
def test_the_density_keeps_its_guarantees_scaled_down(cfg):
    pool = density.make_pool(cfg, 2 ** 33 + 5, 2, "cpu")
    for r in density.check_pool(cfg, pool, 3):
        assert r["maxima"] == 30
        assert r["electrons"] == pytest.approx(204.0, rel=1e-10)


@pytest.fixture(scope="module")
def solved():
    """Two densities of the small grid, the job's outputs on each and the
    reference's answers."""
    cfg = small_config()
    cell = harness.Cell.load(CELL)
    ctx = harness.Context(cfg=cfg, traffic=cell.traffic, device="cpu")
    pool = density.make_pool(cfg, 3100000901, 2, "cpu")
    out = [cell.job.run(ctx, rho) for rho in pool]
    ans = [cell.job.reference(ctx, rho, torch.float64) for rho in pool]
    return {"cell": cell, "ctx": ctx, "pool": pool, "out": out, "ans": ans}


def test_the_job_agrees_with_the_reference(solved):
    lim = solved["cell"].limits
    for out, ans in zip(solved["out"], solved["ans"]):
        assert len(out["iattr"]) == 30
        assert sorted(out["attr_map"]) == list(range(30))
        assert out["charge"].sum() == pytest.approx(204.0, rel=1e-9)
        assert out["volume"].sum() == pytest.approx(2042.8692587, rel=1e-9)
        nums = solved["cell"].job.compare(solved["ctx"], out, ans)
        assert set(nums) == set(lim)
        for k, v in nums.items():
            assert v <= lim[k], (k, v)


def _move_one_point(out, ans):
    """One grid point's volume moved from one basin to another."""
    dv = 2042.8692587 / (27 * 27 * 72)
    v = out["volume"].copy()
    v[0] += dv
    v[1] -= dv
    return dict(out, volume=v)


def _swap_attractor(out, ans):
    i = np.array(out["iattr"])
    i[0] += 1
    return dict(out, iattr=i)


def _stray_attractor(out, ans):
    """A walker stopped off any maximum, as at the cap: an attractor and
    row of one point that the reference shares."""
    dv = 2042.8692587 / (27 * 27 * 72)
    stray = int(ans["iattr"][0]) + 1
    amap = np.append(out["attr_map"], len(out["volume"]))
    return dict(out, iattr=np.append(out["iattr"], stray), attr_map=amap,
                volume=np.append(out["volume"], dv),
                charge=np.append(out["charge"], 0.0))


def _control(out, ans, solved):
    ctl = solved["cell"].job.reference(solved["ctx"], solved["pool"][0],
                                       solved["cell"].job.CONTROL)
    return solved["cell"].job.as_output(ctl)


@pytest.mark.parametrize("fault", ["move_one_point", "swap_attractor",
                                   "control", "stray_attractor"])
def test_a_broken_output_is_not_correct(solved, fault):
    """A grid point in the wrong basin, an attractor one point off, the
    control (the reference on the float32 density) in the program's
    place, and a stray attractor that the reference shares: each breaks
    at least one of the cell's limits."""
    out, ans = solved["out"][0], solved["ans"][0]
    if fault == "control":
        bad = _control(out, ans, solved)
    elif fault == "stray_attractor":
        bad = _stray_attractor(out, ans)
        stray = int(bad["iattr"][-1])
        ans = dict(ans, iattr=np.append(ans["iattr"], stray),
                   volume=np.append(ans["volume"], bad["volume"][-1]),
                   charge=np.append(ans["charge"], 0.0))
    else:
        bad = {"move_one_point": _move_one_point,
               "swap_attractor": _swap_attractor}[fault](out, ans)
    nums = solved["cell"].job.compare(solved["ctx"], bad, ans)
    lim = solved["cell"].limits
    assert any(not float(v) <= lim[k] for k, v in nums.items()), nums
    if fault == "stray_attractor":     # only the count sees it
        assert nums["attractors_unmatched"] == 0
        assert nums["attractor_count_gap"] == 1


def test_a_run_of_the_cell_is_correct_on_the_cpu(tmp_path):
    """The whole run on the CPU: a copy of the benchmark whose cell takes
    the small configuration."""
    root = tmp_path / "checkout"
    bd = root / "benchmark"
    shutil.copytree(harness.BENCH_DIR, bd, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    with open(bd / "configs" / (CONFIG + ".json"), "w") as fh:
        json.dump(small_config(), fh)
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    cell = harness.Cell.load(CELL, bench_dir=str(bd))
    res = harness.run_cell(cell, 2 ** 35 + 25, 0.3, False, "cpu",
                           time.perf_counter())
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"job_s", "setup_s"}
    assert set(res["checks"]) == set(cell.limits)


def _run(kernels=(), njobs=2):
    tr = Trace(device=list(kernels), spans=[("job", 0.0, 1000.0),
                                            ("job", 1000.0, 2000.0)])
    return harness.Run(info={"N": 1_000_000, "K": 26}, setup_s=0.0,
                       walls=[1.0] * njobs, window_s=2.0, njobs=njobs,
                       peak_bytes=0, counters={}, trace=tr)


def _reader(name):
    return harness.load_module(os.path.join(harness.BENCH_DIR, "metrics",
                                            name + ".py"), "m_" + name)


def _record(spans, counters):
    return {"spans": spans, "counters": counters, "dropped": 0}


def test_metric_readers_on_a_synthetic_run(monkeypatch):
    ms = 1_000_000
    spans = [("intgrid", 0, 100 * ms, -1, 1),
             ("bader.walk", 0, 80 * ms, 0, 1),
             ("bader.basins", 80 * ms, 86 * ms, 0, 1),
             ("bader.sums", 86 * ms, 90 * ms, 0, 1),
             ("intgrid", 200 * ms, 300 * ms, -1, 2),
             ("bader.walk", 200 * ms, 270 * ms, 0, 2),
             ("bader.basins", 270 * ms, 274 * ms, 0, 2)]
    rec = _record(spans, {"bader.walker_steps": 1000,
                          "bader.segments": 14, "bader.capped": 0})
    monkeypatch.setattr(program_trace, "record", lambda: rec)
    want = {"bader_walk_ms": 75.0, "bader_basins_ms": 7.0,
            "bader_walker_steps_per_job": 500.0,
            "bader_segments_per_job": 7.0}
    for name, v in want.items():
        assert _reader(name).read(_run()) == pytest.approx(v), name
    # 1e6 points: 16 MB of least bytes in f64, 4.776 us at 3.35 TB/s, over
    # 10 us of the kernel (the other kernels are not the walk's)
    kernels = [(10.0, 16.0, "void bader_walk_kernel<double>(double const*, "
                "int, int, int, WalkConsts<double>, int, long*, "
                "unsigned long long*)"),
               (500.0, 504.0, "void bader_walk_kernel<double>(x)"),
               (600.0, 700.0, "void at::native::unique_kernel(x)")]
    pct = _reader("bader_walk_roofline_pct").read(_run(kernels))
    assert pct == pytest.approx(100.0 * 2 * 16e6 / 3.35e12 / 10e-6)
    run = _run()
    run.counters = {"bader_walk": 2}
    assert _reader("bader_walk_launches_per_job").read(run) == 1.0


def test_metric_readers_read_none_where_nothing_is_there(monkeypatch):
    # a record of the YT path (as a program without the Bader record)
    rec = _record([("intgrid", 0, 5, -1, 1), ("yt.solve", 1, 4, 0, 1)],
                  {"host_syncs": 3})
    monkeypatch.setattr(program_trace, "record", lambda: rec)
    for name in METRICS:
        assert _reader(name).read(_run()) is None, name
    monkeypatch.setattr(program_trace, "record", lambda: None)
    for name in METRICS:
        assert _reader(name).read(_run()) is None, name
    # a window whose walk launched no kernel, and an untraced run
    other = [(10.0, 20.0, "void at::native::index_elementwise_kernel(x)")]
    reader = _reader("bader_walk_roofline_pct")
    assert reader.read(_run(other)) is None
    notrace = _run()
    notrace.trace = None
    assert reader.read(notrace) is None


LOADS = r'''
import json, sys
sys.path.insert(0, {root!r})
import torch
from benchmark.lib import harness
harness.load_module({root!r} + "/benchmark/jobs/bader.py", "jb")
from benchmark.reference import bader
sys.path.insert(0, {bench_tests!r})
from test_benchmark_bader import small_config
cfg = small_config()
rho = harness.data_model(cfg).make_pool(cfg, 5, 1, "cpu")[0]
bader.basins(rho, cfg["structure"]["lattice_bohr"], torch.float32)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
'''


def test_its_files_load_neither_the_program_nor_jax():
    code = LOADS.format(root=harness.ROOT,
                        bench_tests=os.path.dirname(__file__))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "torch" in loaded
    assert not loaded & {"critic2_tpu_torch", "critic2_tpu", "jax",
                         "jaxlib", "flax"}


def test_a_program_without_the_walk_kernel_cannot_run_the_cell(
        tmp_path, monkeypatch):
    """As the program before the walk kernel: its launch count is missing,
    and the run stops at set-up, after the warm-up job."""
    root = tmp_path / "checkout"
    bd = root / "benchmark"
    shutil.copytree(harness.BENCH_DIR, bd, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    with open(bd / "configs" / (CONFIG + ".json"), "w") as fh:
        json.dump(small_config(), fh)
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    cell = harness.Cell.load(CELL, bench_dir=str(bd))
    import critic2_tpu_torch.analysis.integration  # noqa: F401
    import critic2_tpu_torch.ops

    monkeypatch.setitem(sys.modules, "critic2_tpu_torch.ops.bader_walk",
                        None)
    monkeypatch.delattr(critic2_tpu_torch.ops, "bader_walk")
    with pytest.raises(ImportError):
        harness.run_cell(cell, 2 ** 35 + 26, 0.3, False, "cpu",
                         time.perf_counter())
