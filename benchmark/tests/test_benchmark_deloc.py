"""The deloc cell's files on the CPU at a test size: the data model (the
same seed gives the same pool; its check refuses a broken item), the
job's comparison (a broken output reads not correct under the cell's
limits), its metric readers (a number from a synthetic run, None where
there is nothing to read), and what its files load."""
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark.lib import harness, program_trace
from benchmark.lib.trace import Trace

CELL = "nacl-b1-wannier-k4.deloc"
METRICS = ("deloc_support_ms", "deloc_wannier_ms", "deloc_sij_ms",
           "deloc_fa_ms", "deloc_zgemm_roofline_pct")


def small_config() -> dict:
    """The configuration at 24^3, nk 2x2x2, ecutwfc 12.4 Ry (about 900
    plane waves a k-point), exponents the small sphere holds."""
    with open(os.path.join(harness.BENCH_DIR, "configs",
                           "nacl-b1-wannier-k4.json")) as fh:
        cfg = json.load(fh)
    cfg["grid"] = [24, 24, 24]
    m = cfg["density"]
    m["nk"] = [2, 2, 2]
    m["ecutwfc_ry"], m["ecutrho_ry"] = 12.4, 49.6
    m["species"] = {"Na": {"s": 0.33, "p": 0.16},
                    "Cl": {"s": 0.28, "p": 0.13}}
    return cfg


@pytest.fixture(scope="module")
def model():
    return harness.data_model(small_config())


@pytest.fixture(scope="module")
def solved(model):
    """One item, the job's outputs on it and the reference's answer."""
    cfg = small_config()
    item = model.make_pool(cfg, 3100000501, 1, "cpu")[0]
    cell = harness.Cell.load(CELL)
    ctx = harness.Context(cfg=cfg, traffic=cell.traffic, device="cpu")
    out = cell.job.run(ctx, item)
    ans = cell.job.reference(ctx, item, torch.float64)
    return {"cell": cell, "ctx": ctx, "item": item, "out": out, "ans": ans}


def test_same_seed_same_pool(model):
    cfg = small_config()
    a, b, c = (model.make_pool(cfg, s, 2, "cpu")
               for s in (2 ** 40 + 9, 2 ** 40 + 9, 2 ** 40 + 10))
    for x, y, z in zip(a, b, c):
        assert torch.equal(x["evc"], y["evc"])
        assert not torch.equal(x["evc"], z["evc"])
        for k in ("u", "centres_ang", "spreads_ang2", "igk_k", "nl",
                  "miller", "kpt", "wk", "occ"):
            assert np.array_equal(x[k], y[k]), k
        assert not np.array_equal(x["u"], z["u"])
    assert not torch.equal(a[0]["evc"], a[1]["evc"])


def test_a_sound_pool_passes_its_check(model):
    cfg = small_config()
    out = model.check_pool(cfg, model.make_pool(cfg, 3100000502, 2, "cpu"),
                           1)
    for r in out:
        assert r["attractors"] == 8 and r["unitary_gap"] <= 1e-12
        assert r["electrons"] == pytest.approx(64.0, rel=1e-12)


def _broken(model, how):
    cfg = small_config()
    pw = model.plane_waves(cfg)
    (ex, rng), = model.draw(cfg, 3100000503, 1)
    x = None
    if how == "moved_atom":
        x = np.asarray(cfg["structure"]["x_frac"], dtype=float)
        x[5, 0] += 1.0 / 24.0            # one Cl a grid step along a
    item = model.make_item(cfg, pw, ex, rng, "cpu", x_frac=x)
    if how == "electrons":
        # 64 + 1e-6 electrons
        item["evc"] = item["evc"] * np.sqrt(1.0 + 1e-6 / 64.0)
    elif how == "non_unitary":
        item["u"] = item["u"].copy()
        item["u"][3] *= 1.0 + 1e-9
    return cfg, item


@pytest.mark.parametrize("how,match", [
    ("electrons", "electrons"), ("non_unitary", "unitary"),
    ("moved_atom", "symmetry")])
def test_check_pool_refuses_a_broken_item(model, how, match):
    cfg, item = _broken(model, how)
    with pytest.raises(ValueError, match=match):
        model.check_pool(cfg, [item], 1)


def test_the_job_agrees_with_the_reference(solved):
    nums = solved["cell"].job.compare(solved["ctx"], solved["out"],
                                      solved["ans"])
    assert set(nums) == set(solved["cell"].limits)
    for k, v in nums.items():
        assert v <= solved["cell"].limits[k], (k, v)


def _swap_attractor(out):
    i = np.array(out["iattr"])
    i[[0, 1]] = i[[1, 0]]
    return dict(out, iattr=i)


def _perturb_fa(out):
    fa = out["fa"].copy()
    fa[0, 2, 5, 3] += 1e-6
    return dict(out, fa=fa)


def _drop_r(out):
    return dict(out, fa=out["fa"][..., 1:], rvec=out["rvec"][1:])


def _control(solved):
    ctl = solved["cell"].job.reference(solved["ctx"], solved["item"],
                                       solved["cell"].job.CONTROL)
    return solved["cell"].job.as_output(ctl)


@pytest.mark.parametrize("fault", [_swap_attractor, _perturb_fa, _drop_r,
                                   None])
def test_a_broken_output_is_not_correct(solved, fault):
    """A swapped attractor, Fa moved by 1e-6, a lost lattice vector, and
    the control (the reference in complex64) in the program's place."""
    out = fault(solved["out"]) if fault else _control(solved)
    nums = solved["cell"].job.compare(solved["ctx"], out, solved["ans"])
    lim = solved["cell"].limits
    assert any(not float(v) <= lim[k] for k, v in nums.items()), nums


def test_a_run_of_the_cell_is_correct_on_the_cpu(tmp_path):
    """The whole run on the CPU: a copy of the benchmark whose cell takes
    the small configuration."""
    root = tmp_path / "checkout"
    bd = root / "benchmark"
    import shutil

    shutil.copytree(harness.BENCH_DIR, bd, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    with open(bd / "configs" / "nacl-b1-wannier-k4.json", "w") as fh:
        json.dump(small_config(), fh)
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    cell = harness.Cell.load(CELL, bench_dir=str(bd))
    res = harness.run_cell(cell, 2 ** 35 + 21, 0.3, False, "cpu",
                           time.perf_counter())
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"job_s", "setup_s"}
    assert set(res["checks"]) == set(cell.limits)


def _run(kernels=(), njobs=2):
    tr = Trace(device=[(s, e, n) for s, e, n in kernels],
               spans=[("job", 0.0, 1000.0), ("job", 1000.0, 2000.0)])
    return harness.Run(info={}, setup_s=0.0, walls=[1.0] * njobs,
                       window_s=2.0, njobs=njobs, peak_bytes=0,
                       counters={}, trace=tr)


def _reader(name):
    return harness.load_module(os.path.join(harness.BENCH_DIR, "metrics",
                                            name + ".py"), "m_" + name)


def _record(spans, counters):
    return {"spans": spans, "counters": counters, "dropped": 0}


def test_metric_readers_on_a_synthetic_run(monkeypatch):
    ms = 1_000_000
    spans = [("deloc", 0, 100 * ms, -1, 1),
             ("deloc.support", 0, 30 * ms, 0, 1),
             ("deloc.wannier", 30 * ms, 50 * ms, 0, 1),
             ("deloc.sij", 50 * ms, 90 * ms, 0, 1),
             ("deloc.fa", 90 * ms, 96 * ms, 0, 1),
             ("deloc", 200 * ms, 300 * ms, -1, 2),
             ("deloc.support", 200 * ms, 220 * ms, 0, 2)]
    # 67e9 flops: 1 ms at the FP64 Tensor Core rate, over 4 ms of ZGEMM
    rec = _record(spans, {"deloc.zgemm_flops": 67_000_000_000})
    monkeypatch.setattr(program_trace, "record", lambda: rec)
    kernels = [(10.0, 1010.0, "sm90_xmma_gemm_cf64cf64_f64f64_cf64_tn_n_"
                "tilesize64x64x32_stage3_warpsize4x2x1_tensor16x8x16_"
                "execute_kernel__5x_cublas"),
               (1100.0, 4100.0, "void gemv2N_kernel<int, int, double2, "
                "double2, double2, double2, 128, 1, 4, 4, 1, false>(x)"),
               (4200.0, 4300.0, "void gemv2N_kernel<int, int, float2, "
                "float2>(x)"),
               (4400.0, 4500.0, "void other_kernel(double*)")]
    run = _run(kernels)
    want = {"deloc_support_ms": 25.0, "deloc_wannier_ms": 10.0,
            "deloc_sij_ms": 20.0, "deloc_fa_ms": 3.0}
    for name, v in want.items():
        assert _reader(name).read(run) == pytest.approx(v), name
    pct = _reader("deloc_zgemm_roofline_pct").read(run)
    assert pct == pytest.approx(100.0 * 1.0 / 4.0)


def test_metric_readers_read_none_where_nothing_is_there(monkeypatch):
    # a record without the deloc spans or counter (as the parent's)
    rec = _record([("intgrid", 0, 5, -1, 1)], {"host_syncs": 3})
    monkeypatch.setattr(program_trace, "record", lambda: rec)
    run = _run([(10.0, 20.0, "sm90_xmma_gemm_cf64cf64_f64f64_cf64_nn")])
    for name in METRICS:
        assert _reader(name).read(run) is None, name
    # no record at all, and a record but no trace or no ZGEMM launch
    monkeypatch.setattr(program_trace, "record", lambda: None)
    for name in METRICS:
        assert _reader(name).read(run) is None, name
    rec = _record([("deloc", 0, 5, -1, 1)], {"deloc.zgemm_flops": 10})
    monkeypatch.setattr(program_trace, "record", lambda: rec)
    reader = _reader("deloc_zgemm_roofline_pct")
    assert reader.read(_run([(1.0, 2.0, "void other(double*)")])) is None
    notrace = copy.copy(run)
    notrace.trace = None
    assert reader.read(notrace) is None


LOADS = r'''
import json, sys
sys.path.insert(0, {root!r})
import torch
from benchmark.lib import harness
job = harness.load_module({root!r} + "/benchmark/jobs/deloc.py", "jd")
from benchmark.reference import deloc
sys.path.insert(0, {bench_tests!r})
from test_benchmark_deloc import small_config
cfg = small_config()
model = harness.data_model(cfg)
item = model.make_pool(cfg, 5, 1, "cpu")[0]
deloc.deloc(item, cfg["structure"]["lattice_bohr"], torch.float32, 4.0)
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
