"""The density generator's guarantees at small grids on the CPU."""
import json
import os

import numpy as np
import pytest
import torch
from conftest import BENCH, tiny_config

from benchmark.lib import density


@pytest.mark.parametrize("name,grid,widen,atoms,electrons", [
    ("nacl-b1-256", (32, 32, 32), 0.9, 8, 56.0),
    ("anthracene-x23", (96, 72, 128), 0.0, 48, 132.0),
])
def test_pool_keeps_its_guarantees(name, grid, widen, atoms, electrons):
    cfg = tiny_config(name, grid, widen)
    assert density.electrons(cfg) == electrons
    pool = density.make_pool(cfg, 2 ** 33 + 1, 4, "cpu")
    for r in density.check_pool(cfg, pool, 5):
        assert r["maxima"] == atoms
        assert abs(r["electrons"] - electrons) <= 1e-10 * electrons
        assert r["sym_gap"] <= density.SYM_RTOL
        assert r["min"] > 0


def test_same_seed_same_pool_other_seed_other_pool():
    cfg = tiny_config("nacl-b1-256", (24, 24, 24), 1.2)
    a = density.make_pool(cfg, 7, 2, "cpu")
    b = density.make_pool(cfg, 7, 2, "cpu")
    c = density.make_pool(cfg, 8, 2, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], a[1])


def test_draws_stay_within_the_jitter():
    cfg = tiny_config("anthracene-x23", (96, 72, 128))
    for params in density.draw(cfg, 123456789012, 16):
        for name, (nc, sc, nv, sv) in params.items():
            nom = cfg["density"]["species"][name]
            val = {s["name"]: s["valence"]
                   for s in cfg["structure"]["species"]}[name]
            assert nc + nv == pytest.approx(val, rel=1e-15)
            assert 0.9 <= sc / nom["core_width"] <= 1.1
            assert 0.9 <= sv / nom["valence_width"] <= 1.1


def test_full_size_widths_resolve_on_their_grids():
    for name in ("nacl-b1-256", "anthracene-x23"):
        with open(os.path.join(BENCH, "configs", name + ".json")) as fh:
            cfg = json.load(fh)
        density.draw(cfg, 1, 64)          # raises on a width under 2 h


def test_a_broken_density_is_refused(monkeypatch):
    cfg = tiny_config("nacl-b1-256", (32, 32, 32), 0.9)
    rho = density.make_pool(cfg, 3, 1, "cpu")[0]
    bent = rho.clone()
    bent[1, 2, 3] += 1e-6                    # moves charge: breaks the
    bent[5, 2, 3] -= 1e-6                    # symmetry, keeps the count
    monkeypatch.setattr(density, "SYM_SAMPLE", 1 << 30)   # every point
    with pytest.raises(ValueError, match="symmetry"):
        density.check(cfg, bent)
    with pytest.raises(ValueError, match="electrons"):
        density.check(cfg, rho * 1.001)
    wide = tiny_config("nacl-b1-256", (32, 32, 32), 3.0)
    with pytest.raises(ValueError, match="maxima"):
        density.check(wide, density.make_pool(wide, 3, 1, "cpu")[0])


def test_grid_map_refuses_a_grid_the_operation_does_not_keep():
    with pytest.raises(ValueError):
        density._grid_map(np.eye(3), [0.5, 0.0, 0.0], (33, 32, 32))
