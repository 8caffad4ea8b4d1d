"""The port's Bader assignment (analysis/bader.py) and the method="bader"
branch of intgrid against the JAX package, on the CPU.

Labels, attractor indices and positions must be equal; basin sums are
compared to 1e-10 e (both sides add in float64, in different orders).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from critic2_tpu import System as JSystem
from critic2_tpu.analysis import bader as jbader
from critic2_tpu.analysis.integration import _rasterize_field
from critic2_tpu.analysis.integration import intgrid as jintgrid
from critic2_tpu.crystal.cell import m_x2c_from_cellpar
from critic2_tpu.crystal.crystal import Crystal, Species
from critic2_tpu.fields.field import Field as JField
from critic2_tpu.fields.grid3 import Grid3 as JGrid3
from critic2_tpu_torch.analysis import bader as tbader
from critic2_tpu_torch.ops import bader_walk
from critic2_tpu_torch.analysis.integration import intgrid
from critic2_tpu_torch.convert import (bader_to_arrays, crystal_from_arrays,
                                       crystal_to_arrays,
                                       integration_to_arrays,
                                       system_from_arrays)

# the inputs are tiny: one intra-op thread a process, so that parallel
# test workers do not fight over the cores
torch.set_num_threads(1)

CPU = "cpu"


def _port(c):
    return crystal_from_arrays(**crystal_to_arrays(c))


def _two_gaussians(shape=(16, 16, 16), a=8.0, amps=(1.0, 1.0)):
    c = Crystal(m_x2c=m_x2c_from_cellpar([a, a, a], [90, 90, 90]),
                x_frac=np.array([[0.25, 0.25, 0.25], [0.75, 0.75, 0.75]]),
                species_of=np.array([0, 0]), species=[Species("C", 6)])
    g = np.stack(np.meshgrid(*[np.arange(n) / n for n in shape],
                             indexing="ij"), axis=-1)
    rho = np.zeros(shape)
    for site, amp in zip(c.x_frac, amps):
        d = g - site
        d -= np.rint(d)
        rho += amp * np.exp(-((d @ np.asarray(c.m_x2c).T) ** 2).sum(-1))
    return c, rho


def _plateau():
    c = Crystal(m_x2c=np.eye(3) * 12.0,
                x_frac=np.array([[0.25, 0.5, 0.5], [0.75, 0.5, 0.5]]),
                species_of=np.array([0, 0]), species=[Species("X", 1)])
    n = 16
    ii, jj, kk = np.meshgrid(*[np.arange(n)] * 3, indexing="ij")
    x = np.stack([ii, jj, kk], -1) / n * 12.0
    rho = np.zeros((n, n, n))
    for ctr in ([3.0, 6.0, 6.0], [9.0, 6.0, 6.0]):
        rho += np.exp(-((x - np.asarray(ctr)) ** 2).sum(-1))
    rho[rho < 1e-4] = 0.0            # exact plateau
    return c, rho


def _triclinic_random():
    c = Crystal(m_x2c=m_x2c_from_cellpar([6.0, 7.0, 8.0], [80, 95, 102]),
                x_frac=np.array([[0.1, 0.2, 0.3]]),
                species_of=np.array([0]), species=[Species("C", 6)])
    rho = np.random.default_rng(7).random((10, 12, 9))
    # smooth it a little so basins have more than a few points
    for ax in range(3):
        rho = rho + np.roll(rho, 1, ax) + np.roll(rho, -1, ax)
    return c, rho


GRIDS = {"gaussians": _two_gaussians, "plateau": _plateau,
         "triclinic": _triclinic_random,
         "unequal": lambda: _two_gaussians(a=7.0, amps=(1.0, 0.6))}
# the three cubic cases share one shape: the JAX side compiles per shape


@pytest.mark.parametrize("method", ["ongrid", "neargrid"])
@pytest.mark.parametrize("name", sorted(GRIDS))
def test_bader_integrate_matches_jax(name, method, monkeypatch):
    # the JAX package's cycle guard remembers the previous point alone:
    # the port's walk with a memory of 1 (on the triclinic noise a memory
    # of 8 moves 3 of its 1,080 labels)
    monkeypatch.setattr(bader_walk, "WALK_MEMORY", 1)
    c, rho = GRIDS[name]()
    jres = jbader.bader_integrate(c, jnp.asarray(rho), method=method)
    tres = tbader.bader_integrate(_port(c), rho, method=method, device=CPU)
    ja, ta = bader_to_arrays(jres), bader_to_arrays(tres)
    assert ta["nattr"] == ja["nattr"]
    np.testing.assert_array_equal(ta["iattr"], ja["iattr"])
    np.testing.assert_array_equal(ta["xattr"], ja["xattr"])
    np.testing.assert_array_equal(ta["labels"], ja["labels"])
    stack = np.stack([np.ones(rho.size), rho.reshape(-1)])
    np.testing.assert_allclose(tres.integrate(torch.as_tensor(stack)),
                               jres.integrate(stack), rtol=0, atol=1e-10)
    one = tres.integrate(torch.as_tensor(rho.reshape(-1)))
    np.testing.assert_allclose(one, jres.integrate(rho.reshape(-1)), rtol=0,
                               atol=1e-10)


def test_bader_attractor_positions():
    c, rho = _two_gaussians()
    res = tbader.bader_integrate(_port(c), rho, device=CPU)
    assert res.nattr == 2
    vol = res.integrate(torch.ones(rho.size, dtype=torch.float64))
    assert abs(vol.sum() - rho.size) < 1e-9
    assert abs(vol[0] - vol[1]) / vol.sum() < 0.03
    np.testing.assert_allclose(np.sort(res.xattr, axis=0),
                               [[0.25] * 3, [0.75] * 3], atol=1e-12)
    idx, w = res.basin_support(0)
    assert len(idx) == int(vol[0]) and (w == 1.0).all()


def test_bader_plateau_single_attractor():
    c, rho = _plateau()
    for method in ("ongrid", "neargrid"):
        res = tbader.bader_integrate(_port(c), rho, method=method,
                                     device=CPU)
        if method == "ongrid":
            # 2 blobs + a handful of plateau representatives at most
            assert res.nattr <= 8, res.nattr
        assert res.labels.dtype == np.int32
        assert res.labels.shape == rho.shape


def test_walk_blocks_do_not_change_the_assignment():
    """Every near-grid walk is independent: blocks of 1000 walkers and
    one block of all give the same roots."""
    c, rho = _two_gaussians((12, 14, 10))
    r = torch.as_tensor(rho)
    a = tbader._neargrid_roots(_port(c), r)
    b = tbader._neargrid_roots(_port(c), r, walk_block=1000)
    assert torch.equal(a, b)
    # ongrid in blocks of 500 points
    x = tbader.bader_integrate(_port(c), r, method="ongrid")
    y = tbader.bader_integrate(_port(c), r, method="ongrid", block=500)
    assert torch.equal(x.labels_d, y.labels_d)


def test_unknown_method_raises():
    c, rho = _two_gaussians((8, 8, 8))
    with pytest.raises(ValueError):
        tbader.bader_integrate(_port(c), rho, method="offgrid", device=CPU)


# ------------------------------------------------------- intgrid("bader")
@pytest.fixture(scope="module")
def nacl24():
    c = Crystal(m_x2c=m_x2c_from_cellpar([10.66] * 3, [90] * 3),
                x_frac=np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]),
                species_of=np.array([0, 1]),
                species=[Species("Na", 11), Species("Cl", 17)])
    js = JSystem.from_structure(c)
    g = np.asarray(_rasterize_field(js.fields[0], (24, 24, 24)))
    js.load_field(JField.from_grid(c, JGrid3(jnp.asarray(g)), name="pg"))
    ts = system_from_arrays(**crystal_to_arrays(c), grid=g, device=CPU)
    return js, ts, g


@pytest.mark.parametrize("bader_method", ["neargrid", "ongrid"])
def test_intgrid_bader_matches_jax(nacl24, bader_method):
    js, ts, g = nacl24
    jr = jintgrid(js, method="bader", bader_method=bader_method)
    tr = intgrid(ts, method="bader", bader_method=bader_method)
    ja, ta = integration_to_arrays(jr), integration_to_arrays(tr)
    assert tr.method == "bader" and tr.nattr_raw == jr.nattr_raw
    for key in ("name", "atom", "attr_map"):
        np.testing.assert_array_equal(ta[key], ja[key])
    np.testing.assert_array_equal(tr.decomp.labels, jr.decomp.labels)
    np.testing.assert_allclose(ta["pop"], ja["pop"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(ta["volume"], ja["volume"], rtol=0,
                               atol=1e-10)
    assert tr.table().splitlines()[0] == jr.table().splitlines()[0]


def test_intgrid_bader_agrees_roughly_with_yt(nacl24):
    _, ts, g = nacl24
    r_yt = intgrid(ts, method="yt")
    r_b = intgrid(ts, method="bader")
    q_yt = {r.name: r.pop for r in r_yt.rows}
    q_b = {r.name: r.pop for r in r_b.rows}
    total = g.sum() * ts.crystal.volume / g.size
    assert abs(r_b.charges.sum() - total) < 1e-8
    assert abs(r_b.charges.sum() - r_yt.charges.sum()) < 1e-8
    assert abs(r_b.volumes.sum() - ts.crystal.volume) < 1e-6
    for k in q_yt:
        # Bader and YT differ on boundary handling; same basins to ~2%
        assert abs(q_yt[k] - q_b[k]) / q_yt[k] < 0.02


def test_intgrid_bader_extra_fields_match_jax(nacl24):
    js, ts, g = nacl24
    extra = {"twice": 2.0 * g}
    jr = jintgrid(js, method="bader", fields=extra)
    tr = intgrid(ts, method="bader", fields=extra)
    for a, b in zip(tr.rows, jr.rows):
        assert abs(a.extra["twice"] - b.extra["twice"]) < 1e-10
        assert abs(a.extra["twice"] - 2 * a.pop) < 1e-10
