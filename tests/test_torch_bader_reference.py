"""The port's intgrid(method="bader") at critic2's near-grid default
against the benchmark's plain reference (benchmark/reference/bader.py),
which walks every grid point again by the published step rule with code
of its own, on seeded two-Gaussian densities of the benchmark's data
model: hematite on a small grid that keeps every operation of R-3c (a
hexagonal grid lattice, 30 basins of two kinds), rock salt on a cubic
grid, and rock salt with its low density clamped to an exact zero
plateau. Attractors and labels must be equal; volumes and charges per
attractor agree to 1e-10 relative (float64 sums on the CPU, in orders
that differ). Pure torch: nothing here compiles JAX.
"""
import json
import os

import numpy as np
import pytest
import torch

from benchmark.lib import density, harness
from benchmark.reference import bader as ref_bader
from critic2_tpu_torch.analysis.integration import intgrid
from critic2_tpu_torch.ops import bader_walk

torch.set_num_threads(1)

RTOL = 1e-10


def small_config(name="hematite-r3c", grid=(27, 27, 72), floor=0.85):
    """A benchmark configuration at a test grid, every Gaussian width
    raised to at least `floor` bohr (27 x 27 x 72 keeps R-3c's
    operations; 0.85 bohr is 2.1 of its spacings at the narrowest
    draw)."""
    with open(os.path.join(harness.BENCH_DIR, "configs",
                           name + ".json")) as fh:
        cfg = json.load(fh)
    cfg["grid"] = list(grid)
    for sp in cfg["density"]["species"].values():
        sp["core_width"] = max(sp["core_width"], floor)
        sp["valence_width"] = max(sp["valence_width"], floor)
    return cfg


def hematite(seed=3100000911):
    cfg = small_config()
    rho = density.make_pool(cfg, seed, 1, "cpu")[0]
    density.check(cfg, rho, seed)
    return cfg, rho


def rock_salt(seed=3100000912):
    cfg = small_config("nacl-b1-256", (32, 32, 32), 0.9)
    rho = density.make_pool(cfg, seed, 1, "cpu")[0]
    density.check(cfg, rho, seed)
    return cfg, rho


def plateau(seed=3100000913):
    """Rock salt with every value below a quarter of the mean set to 0:
    the interior of that region is flat, and each of its points is a
    maximum of its own."""
    cfg, rho = rock_salt(seed)
    return cfg, torch.where(rho < 0.25 * rho.mean(), 0.0, rho)


CASES = {"hematite": hematite, "rock_salt": rock_salt, "plateau": plateau}


def bader_run(cfg, rho):
    """intgrid(method="bader") through the benchmark job's System."""
    from benchmark.lib import program

    ctx = harness.Context(cfg=cfg, traffic={}, device="cpu")
    return intgrid(program.system(ctx, rho), method="bader")


@pytest.mark.parametrize("name", sorted(CASES))
def test_intgrid_bader_matches_the_plain_reference(name):
    cfg, rho = CASES[name]()
    res = bader_run(cfg, rho)
    ans = ref_bader.basins(rho, cfg["structure"]["lattice_bohr"])
    dec = res.decomp
    np.testing.assert_array_equal(dec.iattr, ans["iattr"])
    assert torch.equal(dec.labels_d, ans["labels"])
    scale = abs(float(np.linalg.det(np.asarray(
        cfg["structure"]["lattice_bohr"])))) / rho.numel()
    vol, q = dec.integrate(torch.stack([torch.ones_like(rho).reshape(-1),
                                        rho.reshape(-1)])) * scale
    np.testing.assert_allclose(vol, ans["volume"], rtol=RTOL, atol=0)
    np.testing.assert_allclose(q, ans["charge"], rtol=RTOL, atol=0)
    assert res.charges.sum() == pytest.approx(float(rho.sum()) * scale,
                                              rel=1e-9)
    assert res.volumes.sum() == pytest.approx(
        scale * rho.numel(), rel=1e-9)
    if name == "hematite":
        assert res.nattr_raw == len(res.rows) == 30
        names = sorted(r.name for r in res.rows)
        assert names == ["Fe"] * 12 + ["O"] * 18
    elif name == "plateau":
        assert dec.nattr > 8 and (ans["charge"] == 0.0).sum() == \
            dec.nattr - 8


def test_the_reference_in_float32_is_not_the_program():
    """The control of the benchmark's check: on the float32 density the
    walk stops elsewhere at some points, so attractors or labels differ."""
    cfg, rho = hematite()
    ans = ref_bader.basins(rho, cfg["structure"]["lattice_bohr"])
    ctl = ref_bader.basins(rho, cfg["structure"]["lattice_bohr"],
                           torch.float32)
    assert not np.array_equal(ctl["iattr"], ans["iattr"]) \
        or not torch.equal(ctl["labels"], ans["labels"])


def test_a_walker_in_a_four_step_cycle_reaches_its_atom(monkeypatch):
    """On hematite's grid lattice a walker near an inversion centre on the
    3-fold axis goes round four points, each step away from the point
    before the last. Remembering only the previous point it walks to the
    cap and stops off any maximum; with the walk's memory of 8 points it
    takes the on-grid step and reaches a maximum of the density, in the
    port's walk and in the reference's alike."""
    cfg = small_config(grid=(81, 81, 216), floor=0.0)
    shape = tuple(cfg["grid"])
    rho = density.make_pool(cfg, 1003, 2, "cpu")[1]
    start, cap = 986004, 4 * max(shape) + 64
    G, invd = ref_bader.metric(cfg["structure"]["lattice_bohr"], shape)
    offs = ref_bader.STENCIL[ref_bader.NEIGHBOURS]
    f = rho.reshape(-1)
    maxima = set(density.local_maxima(rho).tolist())

    def port_walk():
        state = bader_walk._walkers(torch.tensor([start]), shape, rho.dtype)
        args = (f, G, torch.as_tensor(offs), torch.as_tensor(invd), shape,
                torch.arange(-1, 2))
        steps = 0
        while not bool(state[3][0]) and steps < cap:
            state = bader_walk._neargrid_step(state, *args)
            steps += 1
        return int(bader_walk._flat(state[0], shape)), bool(state[3][0])

    def ref_walk():
        return int(ref_bader._walk(f, shape, torch.tensor([start]), G,
                                   torch.as_tensor(invd), cap)[0])

    root, done = port_walk()
    assert done and root in maxima and root == ref_walk()
    monkeypatch.setattr(bader_walk, "WALK_MEMORY", 1)
    monkeypatch.setattr(ref_bader, "MEMORY", 1)
    stuck, done = port_walk()
    assert not done and stuck not in maxima and stuck == ref_walk()
