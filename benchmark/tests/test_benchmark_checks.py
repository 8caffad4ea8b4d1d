"""The output check: the reference agrees with the program on the CPU, and
a run whose timed path is broken, or whose program is replaced by the
control, comes out not correct under the cells' own limits."""
import time

import numpy as np
import pytest
import torch

from benchmark.lib import density, harness

YT = "nacl-b1-256-tiny.yt"
TOPOLOGY = "nacl-b1-256-tiny.topology"
NCI = "anthracene-x23-tiny.nci"


def _cell(bd, name):
    return harness.Cell.load(name, bench_dir=bd)


def _run(cell, run_job=None, seed=2 ** 35 + 11):
    return harness.run_cell(cell, seed, 0.3, False, "cpu",
                            time.perf_counter(), run_job=run_job)


@pytest.mark.parametrize("name", [YT, TOPOLOGY, NCI])
def test_reference_agrees_with_the_program_on_the_cpu(tiny_bench, name):
    """Each job kind on NaCl at 32^3: the program on the CPU within the
    cell's limits of the plain reference, on every density of a pool."""
    cell = _cell(tiny_bench[0], name)
    cfg = _cell(tiny_bench[0], YT).cfg
    ctx = harness.Context(cfg=cfg, traffic=cell.traffic, device="cpu")
    for rho in density.make_pool(cfg, 987654321987, 2, "cpu"):
        ans = cell.job.reference(ctx, rho, torch.float64)
        nums = cell.job.compare(ctx, cell.job.run(ctx, rho), ans)
        for k, v in nums.items():
            assert v <= cell.limits[k], (k, v)


@pytest.mark.parametrize("name", [YT, TOPOLOGY, NCI])
def test_a_sound_run_is_correct(tiny_bench, name):
    res = _run(_cell(tiny_bench[0], name))
    assert res["correct"] is True, res["checks"]


@pytest.mark.parametrize("name", [YT, TOPOLOGY, NCI])
def test_the_control_is_not_correct(tiny_bench, name):
    """The reference one precision below the configuration's, in the
    program's place."""
    cell = _cell(tiny_bench[0], name)

    def control(ctx, rho):
        return cell.job.as_output(cell.job.reference(ctx, rho,
                                                     cell.job.CONTROL))

    res = _run(cell, control)
    assert res["correct"] is False
    assert any(v["value"] > v["limit"] for v in res["checks"].values())


def test_yt_solve_returning_its_state_unchanged_is_caught(tiny_bench,
                                                          monkeypatch):
    from critic2_tpu_torch.analysis import yt

    monkeypatch.setattr(yt, "_solve_sweep",
                        lambda chiP, chiP32, chiR, f3, offs, **kw: f3)
    res = _run(_cell(tiny_bench[0], YT))
    assert res["correct"] is False


def test_yt_charge_altered_where_produced_is_caught(tiny_bench, monkeypatch):
    """One basin's charge off by a millionth of itself."""
    from critic2_tpu_torch.analysis import integration

    real = integration.intgrid

    def altered(*a, **kw):
        res = real(*a, **kw)
        res.rows[1].pop *= 1.0 + 1e-6
        return res

    monkeypatch.setattr(integration, "intgrid", altered)
    res = _run(_cell(tiny_bench[0], YT))
    assert res["correct"] is False
    assert res["checks"]["charge_gap_e"]["value"] > \
        res["checks"]["charge_gap_e"]["limit"]


def _patch_nci(monkeypatch, edit):
    from critic2_tpu_torch.analysis import nci

    real = nci.nciplot

    def broken(*a, **kw):
        res = real(*a, **kw)
        edit(res)
        return res

    monkeypatch.setattr(nci, "nciplot", broken)


def test_nci_rdg_altered_where_produced_is_caught(tiny_bench, monkeypatch):
    """One point's RDG, among those plotted, off by 2 %."""
    def edit(res):
        flat = res.cgrad.reshape(-1)
        i = int(torch.nonzero((flat < 100.0) & (flat > 0.5))[0])
        flat[i] *= 1.02

    _patch_nci(monkeypatch, edit)
    res = _run(_cell(tiny_bench[0], NCI))
    assert res["correct"] is False
    assert res["checks"]["rdg_gap"]["value"] > \
        res["checks"]["rdg_gap"]["limit"]


def test_nci_half_of_the_grid_left_out_is_caught(tiny_bench, monkeypatch):
    def edit(res):
        n = res.crho.shape[0] // 2
        res.crho[n:] = 0.0
        res.cgrad[n:] = 100.0

    _patch_nci(monkeypatch, edit)
    assert _run(_cell(tiny_bench[0], NCI))["correct"] is False


def test_each_seed_draws_its_own_pool(tiny_bench):
    """Every job, the warm-up too, runs on a density of the pool that the
    run's seed draws, and two seeds share no density."""
    cell = _cell(tiny_bench[0], YT)
    seen = {}
    for seed in (2 ** 40 + 9, 2 ** 40 + 10):
        got = []

        def job(ctx, rho, got=got):
            got.append(rho.clone())
            return cell.job.run(ctx, rho)

        assert _run(cell, job, seed)["correct"] is True
        pool = density.make_pool(cell.cfg, seed, int(cell.traffic["pool"]),
                                 "cpu")
        assert len(got) >= 2
        assert all(any(torch.equal(g, r) for r in pool) for g in got)
        seen[seed] = got
    a, b = seen.values()
    assert not any(torch.equal(x, y) for x in a for y in b)


def test_every_sampled_nci_job_is_a_density_of_the_pool(tiny_bench):
    cell = _cell(tiny_bench[0], NCI)
    plan = harness._keep_plan(cell, 5, 4, 100)
    assert len(plan) == 4 and {j % 4 for j in plan} == {0, 1, 2, 3}
    assert harness._keep_plan(cell, 5, 4, 100) == plan
    assert np.all(np.array(sorted(plan)) < 80)


def test_calibration_separates_program_and_control(tiny_bench):
    """calibrate.py's readings on the CPU: every number of the program
    under its limit, and the control over the limit in one number."""
    from benchmark.calibrate import calibrate

    cell = _cell(tiny_bench[0], YT)
    s = calibrate(cell, [3, 4], [5], "cpu")
    assert all(v <= cell.limits[k] for k, v in s["program"].items())
    assert any(v > cell.limits[k] for k, v in s["control"].items())


def test_topology_newton_returning_its_seeds_is_caught(tiny_bench,
                                                       monkeypatch):
    from critic2_tpu_torch.analysis import autocp

    def unchanged(fn, x0, **kw):
        return x0, torch.ones(len(x0), dtype=torch.bool), None

    monkeypatch.setattr(autocp, "newton_batch", unchanged)
    assert _run(_cell(tiny_bench[0], TOPOLOGY))["correct"] is False


def test_topology_path_end_altered_where_produced_is_caught(tiny_bench,
                                                            monkeypatch):
    """A bond path that reports the wrong nucleus at one end."""
    from critic2_tpu_torch.analysis import autocp

    real = autocp.makegraph

    def altered(system, cpl, **kw):
        cpl = real(system, cpl, **kw)
        bcp = next(cp for cp in cpl.cps if cp.typ == -1)
        nuc = [i for i, cp in enumerate(cpl.cps) if cp.isnuc]
        bcp.ipath[0] = next(i for i in nuc if i not in bcp.ipath and
                            cpl.cps[i].name == cpl.cps[bcp.ipath[1]].name)
        return cpl

    monkeypatch.setattr(autocp, "makegraph", altered)
    res = _run(_cell(tiny_bench[0], TOPOLOGY))
    assert res["correct"] is False
    assert res["checks"]["path_end_mismatches"]["value"] > 0
