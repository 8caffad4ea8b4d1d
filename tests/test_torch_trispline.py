"""The port's trispline / tristar interpolation against the JAX package on
the CPU, with the JAX tests' own bars (node exactness, C2 continuity, the
cyclic-system residual, analytic derivatives)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from critic2_tpu import System as JSystem
from critic2_tpu.analysis.autocp import autocp as jautocp
from critic2_tpu.analysis.integration import _rasterize_field
from critic2_tpu.crystal.cell import m_x2c_from_cellpar
from critic2_tpu.crystal.crystal import Crystal, Species
from critic2_tpu.fields.field import Field as JField
from critic2_tpu.fields.grid3 import Grid3 as JGrid3
from critic2_tpu.ops import trispline as jtri
from critic2_tpu_torch.analysis.autocp import autocp
from critic2_tpu_torch.convert import (cplist_to_arrays, crystal_to_arrays,
                                       system_from_arrays)
from critic2_tpu_torch.ops import trispline as ttri

# the inputs are tiny: one intra-op thread a process, so that parallel
# test workers do not fight over the cores
torch.set_num_threads(1)

CPU = "cpu"
RTOL = 1e-9      # spline_coeffs / trispline_soa / trispline_star_soa vs JAX


def _close(t, j, rtol=RTOL):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=0,
                               atol=rtol * max(np.abs(j).max(), 1e-300))


@pytest.fixture(scope="module")
def rand_grid():
    f = np.random.default_rng(3).random((10, 12, 8))
    return f, torch.as_tensor(f)


@pytest.fixture(scope="module")
def trig_grid():
    n = (24, 20, 16)
    i, j, k = np.meshgrid(*[np.arange(v) for v in n], indexing="ij")
    f = (np.sin(2 * np.pi * i / n[0]) * np.cos(2 * np.pi * j / n[1])
         + 0.5 * np.cos(2 * np.pi * k / n[2]))
    return n, f


def _points(seed, N=300):
    """Scattered fractional points incl. wrap cases, a node and a tiny
    negative coordinate (x - floor(x) rounds to 1 there)."""
    pts = np.random.default_rng(seed).random((3, N)) * 3.0 - 1.0
    pts[:, 0] = [0.3, 0.25, 0.5]
    pts[:, 1] = [-1e-17, 0.4, 0.6]
    return pts


def test_spline_coeffs_match_jax(rand_grid):
    f, ft = rand_grid
    _close(ttri.spline_coeffs(ft), jtri.spline_coeffs(jnp.asarray(f)))


def test_star_c2_matches_jax_and_solves_cyclic_system(rand_grid):
    f, ft = rand_grid
    c2 = ttri.star_c2(ft)
    assert tuple(c2.shape) == f.shape + (3,)
    _close(c2, jtri.star_c2(jnp.asarray(f)))
    # residual of cyclic(1,4,1) c2 = 6 n^2 d2 along each axis
    c2 = c2.numpy()
    for ax in range(3):
        n = f.shape[ax]
        lhs = (np.roll(c2[..., ax], 1, ax) + 4.0 * c2[..., ax]
               + np.roll(c2[..., ax], -1, ax))
        rhs = 6.0 * n * n * (np.roll(f, -1, ax) - 2.0 * f
                             + np.roll(f, 1, ax))
        np.testing.assert_allclose(lhs, rhs, atol=1e-8)


@pytest.mark.parametrize("nder", [0, 1, 2])
def test_trispline_soa_matches_jax(rand_grid, nder):
    f, ft = rand_grid
    cj = jtri.spline_coeffs(jnp.asarray(f))
    ct = ttri.spline_coeffs(ft)
    pts = _points(5)
    outj = jtri.trispline_soa(cj, jnp.asarray(pts), nder=nder)
    outt = ttri.trispline_soa(ct, torch.as_tensor(pts), nder=nder)
    for a, b in zip(outt, outj):
        _close(a, b)


@pytest.mark.parametrize("nder", [0, 1, 2])
def test_trispline_star_soa_matches_jax(rand_grid, nder):
    f, ft = rand_grid
    c2j = jtri.star_c2(jnp.asarray(f))
    c2t = ttri.star_c2(ft)
    pts = _points(6)
    outj = jtri.trispline_star_soa(jnp.asarray(f), c2j, jnp.asarray(pts),
                                   nder=nder)
    outt = ttri.trispline_star_soa(ft, c2t, torch.as_tensor(pts), nder=nder)
    for a, b in zip(outt, outj):
        _close(a, b)


@pytest.mark.parametrize("mode", ["trispline", "tristar"])
def test_interpolates_nodes(trig_grid, mode):
    n, f = trig_grid
    ft = torch.as_tensor(f)
    idx = np.random.default_rng(0).integers(0, min(n), size=(3, 40))
    pts = torch.as_tensor(idx / np.asarray(n)[:, None])
    if mode == "trispline":
        y = ttri.trispline_soa(ttri.spline_coeffs(ft), pts, nder=0)[0]
    else:
        y = ttri.trispline_star_soa(ft, ttri.star_c2(ft), pts, nder=0)[0]
    np.testing.assert_allclose(y.numpy(), f[idx[0], idx[1], idx[2]],
                               atol=1e-11)


def test_derivatives_vs_analytic(trig_grid):
    n, f = trig_grid
    pts = np.random.default_rng(1).random((3, 200))
    y, yp, ypp6 = ttri.trispline_soa(
        ttri.spline_coeffs(torch.as_tensor(f)), torch.as_tensor(pts))
    x, yy, z = (2 * np.pi * pts[a] for a in range(3))
    tp = 2 * np.pi
    np.testing.assert_allclose(
        y.numpy(), np.sin(x) * np.cos(yy) + 0.5 * np.cos(z), atol=2e-4)
    ga = np.stack([tp * np.cos(x) * np.cos(yy), -tp * np.sin(x) * np.sin(yy),
                   -0.5 * tp * np.sin(z)])
    np.testing.assert_allclose(yp.numpy(), ga, atol=2e-2)
    np.testing.assert_allclose(ypp6[0].numpy(),
                               -tp * tp * np.sin(x) * np.cos(yy), atol=1.0)
    np.testing.assert_allclose(ypp6[3].numpy(),
                               -tp * tp * np.cos(x) * np.sin(yy), atol=1.0)


def test_c2_continuity(trig_grid):
    n, f = trig_grid
    c = ttri.spline_coeffs(torch.as_tensor(f))
    eps = 1e-9
    xb = 5.0 / n[0]
    pts = torch.tensor([[xb - eps, xb + eps], [0.37, 0.37], [0.21, 0.21]],
                       dtype=torch.float64)
    ypp6 = ttri.trispline_soa(c, pts)[2].numpy()
    np.testing.assert_allclose(ypp6[:, 0], ypp6[:, 1], atol=1e-4)


def _cusp_grid(n=32):
    """A cusp of 3000 on the node at the origin over a background of
    1e-3, mirror-symmetric about every node plane through (0, 1/2, 0)."""
    x = np.stack(np.meshgrid(*[np.arange(n) / n] * 3, indexing="ij"), -1)
    d = x - np.rint(x)
    g = 3000.0 * np.exp(-60.0 * np.sqrt((d ** 2).sum(-1)))
    return g + 1e-3 * (2.0 + np.cos(2 * np.pi * x).sum(-1))


@pytest.mark.parametrize("mode", ["trispline", "tristar"])
def test_curvature_rounding_is_local(mode):
    """The cyclic solve's rounding error must scale with the values
    nearby, not with the largest value on the grid: (0, 1/2, 0) is a
    critical point of the cusp grid by symmetry, and the spline's gradient
    there is zero to 1e-15 (fractional units; the background's own scale
    is 1e-3 * n * eps ~ 1e-17). A solve whose error is relative to the
    cusp (an FFT's) leaves 1e-11 there, a kink Newton cannot get below.
    The JAX package's dense solve meets the same bar."""
    g = _cusp_grid()
    ft = torch.as_tensor(g)
    x = np.array([[0.0], [0.5], [0.0]])
    if mode == "trispline":
        yp = ttri.trispline_soa(ttri.spline_coeffs(ft), torch.as_tensor(x))[1]
        ypj = jtri.trispline_soa(jtri.spline_coeffs(jnp.asarray(g)),
                                 jnp.asarray(x))[1]
        assert np.abs(np.asarray(ypj)).max() <= 1e-15
    else:
        yp = ttri.trispline_star_soa(ft, ttri.star_c2(ft),
                                     torch.as_tensor(x))[1]
    assert float(yp.abs().max()) <= 1e-15


# ------------------------------------------------- the modes in the field
@pytest.fixture(scope="module")
def ne_systems():
    c = Crystal(m_x2c=m_x2c_from_cellpar([8.0] * 3, [90] * 3),
                x_frac=np.array([[0.5, 0.5, 0.5]]),
                species_of=np.array([0]), species=[Species("Ne", 10)])
    js = JSystem.from_structure(c)
    g = np.asarray(_rasterize_field(js.fields[0], (20, 20, 20)))
    js.load_field(JField.from_grid(c, JGrid3(jnp.asarray(g))))
    ts = system_from_arrays(**crystal_to_arrays(c), grid=g, device=CPU)
    return js, ts


@pytest.mark.parametrize("mode", ["trispline", "tristar"])
def test_field_mode_matches_jax(ne_systems, mode):
    """Field.grd and Field.eval_fn in the spline modes against the JAX
    field; the points sit off the node planes (the tristar off-diagonal
    Hessian may jump at cell faces)."""
    js, ts = ne_systems
    js.ref.set_options(interp=mode)
    ts.ref.set_options(interp=mode)
    rng = np.random.default_rng(9)
    xf = (rng.integers(0, 20, (16, 3)) + 0.1 + 0.8 * rng.random((16, 3))) / 20
    pts = xf @ np.asarray(js.crystal.m_x2c).T
    rj = js.ref.grd(pts)
    rt = ts.ref.grd(pts)
    _close(rt.f, rj.f)
    _close(rt.gf, rj.gf)
    _close(rt.hf, rj.hf)
    f2, g2, h62 = ts.ref.eval_fn(nder=2)(torch.as_tensor(pts.T))
    np.testing.assert_allclose(f2.numpy(), rt.f.numpy(), rtol=1e-12)
    jf2, jg2, jh62 = js.ref.eval_fn(nder=2)(jnp.asarray(pts.T))
    _close(g2, jg2)
    _close(h62, jh62)
    js.ref.set_options(interp="tricubic")
    ts.ref.set_options(interp="tricubic")


def test_setmode_releases_the_coefficient_grids(ne_systems):
    """A mode's coefficient grids are built on first use and released when
    the mode is left (8 and 3 times the grid's size)."""
    _, ts = ne_systems
    grid = ts.ref.grid
    pts = np.array([[1.0, 2.0, 3.0]])
    assert grid._spl is None and grid._star_c2 is None
    ts.ref.set_options(interp="trispline")
    ts.ref.grd(pts)
    assert tuple(grid._spl.shape) == (8,) + grid.n and grid._star_c2 is None
    ts.ref.set_options(interp="tristar")
    ts.ref.grd(pts)
    assert grid._spl is None and tuple(grid._star_c2.shape) == grid.n + (3,)
    ts.ref.set_options(interp="tricubic")
    assert grid._spl is None and grid._star_c2 is None


def _cscl_model(n=24):
    """CsCl-type crystal with a smooth model density (one Gaussian per
    atom, minimum image) on an n^3 grid; the atoms sit at cell centres of
    the grid, so the gridded field keeps the full symmetry."""
    c = Crystal(m_x2c=m_x2c_from_cellpar([7.0] * 3, [90] * 3),
                x_frac=np.array([[2.5 / n] * 3, [2.5 / n + 0.5] * 3]),
                species_of=np.array([0, 1]),
                species=[Species("Na", 11), Species("Cl", 17)])
    x = np.stack(np.meshgrid(*[np.arange(n) / n] * 3, indexing="ij"), -1)
    g = np.zeros((n, n, n))
    for site, amp in zip(c.x_frac, (1.0, 1.6)):
        d = x - site
        d -= np.rint(d)
        g += amp * np.exp(-((d @ c.m_x2c.T) ** 2).sum(-1) / 1.5 ** 2)
    return c, g


def test_autocp_on_spline_fields_matches_jax():
    """autocp runs unchanged on a trispline field and gives the JAX
    package's CP list; on the tristar field (whose JAX search costs four
    times as much to compile) the port alone must find the same counts."""
    c, g = _cscl_model()
    js = JSystem.from_structure(c)
    js.load_field(JField.from_grid(c, JGrid3(jnp.asarray(g))))
    ts = system_from_arrays(**crystal_to_arrays(c), grid=g, device=CPU,
                            interp="trispline")
    js.ref.set_options(interp="trispline")
    tcpl, jcpl = autocp(ts), jautocp(js)
    a, b = cplist_to_arrays(tcpl), cplist_to_arrays(jcpl)
    assert tcpl.counts() == jcpl.counts()
    assert tcpl.poincare_hopf() == jcpl.poincare_hopf() == 0
    np.testing.assert_array_equal(a["typ"], b["typ"])
    np.testing.assert_array_equal(a["mult"], b["mult"])
    # which image of an orbit represents it hangs on which seed got there
    # first: compare each CP with the nearest image of its twin (1e-9 bohr)
    sg = ts.crystal.spacegroup
    for xt, xj in zip(a["x"], b["x"]):
        imgs = (sg.rotations @ xj + sg.translations) % 1.0
        assert ts.crystal.distmat(xt, imgs).min() <= 1e-9
    np.testing.assert_allclose(a["f"], b["f"], rtol=1e-9, atol=1e-9)

    ts.ref.set_options(interp="tristar")
    scpl = autocp(ts)
    assert scpl.counts() == jcpl.counts() and scpl.poincare_hopf() == 0
