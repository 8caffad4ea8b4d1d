"""analysis/autocp of the torch port against the JAX package, on the CPU.

The same structures and grids run through both autocp functions; the CP lists
are compared array by array through convert.cplist_to_arrays: equal
counts, types, multiplicities, names and Poincare-Hopf sum, positions
within 1e-9 bohr, values within 1e-9 relative. Reports must be equal as
text. Each JAX result is computed once per module.

The Catmull-Rom second derivative jumps at grid nodes, and the critical
points of the cosine grid sit exactly on nodes: there a position that
differs by 1e-13 bohr may read the Hessian from the other side of the
jump (2e-8 on that grid), so Hessian-derived values of that case are
held to 1e-6. The crystal case keeps its atoms and mirror planes between
the node planes.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from critic2_tpu.analysis import autocp as jauto
from critic2_tpu.crystal.cell import m_x2c_from_cellpar
from critic2_tpu.crystal.crystal import Crystal, Species
from critic2_tpu.crystal.seed import CrystalSeed
from critic2_tpu.fields.field import Field as JField
from critic2_tpu.fields.grid3 import Grid3 as JGrid3
from critic2_tpu.system import System as JSystem
from critic2_tpu_torch.analysis import autocp as tauto
from critic2_tpu_torch.convert import (cplist_to_arrays,
                                       crystal_from_arrays,
                                       crystal_to_arrays, system_from_arrays)

# the inputs are tiny: one intra-op thread a process, so that parallel
# test workers do not fight over the cores
torch.set_num_threads(1)

CPU = "cpu"
TOL_POS = 1e-9       # bohr


def _cosine(n=24, a=6.0):
    """f = cos(2pi x) + cos(2pi y) + cos(2pi z) on a cubic cell: known
    topology - 1 max, 3+3 saddles, 1 min, Poincare-Hopf = 0."""
    c = Crystal(m_x2c=np.eye(3) * a, x_frac=np.zeros((0, 3)),
                species_of=np.zeros(0, dtype=int), species=[])
    i, j, k = np.meshgrid(*[np.arange(n) / n] * 3, indexing="ij")
    f = np.cos(2 * np.pi * i) + np.cos(2 * np.pi * j) + np.cos(2 * np.pi * k)
    js = JSystem(crystal=c)
    js.fields[0] = JField.from_grid(c, JGrid3(jnp.asarray(f)))
    js.iref = 0
    ts = system_from_arrays(**crystal_to_arrays(c), grid=f, device=CPU)
    return js, ts


def _cscl_grid(n=24):
    """CsCl-type crystal with a smooth model density (one Gaussian per
    atom, minimum image) on an n^3 grid as the reference field:
    symmetry-aware dedup under 48 operations. The atoms sit at cell
    centres of the grid, so every mirror plane maps nodes onto nodes (the
    gridded field has the full symmetry) and passes between node planes
    (the interpolant is smooth there)."""
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
    js = JSystem.from_structure(c)
    js.load_field(JField.from_grid(c, JGrid3(jnp.asarray(g))))
    ts = system_from_arrays(**crystal_to_arrays(c), grid=g, device=CPU)
    return js, ts


def _water():
    cart = np.array([[0.0, 0.0, 0.22], [0.0, 1.43, -0.89],
                     [0.0, -1.43, -0.89]])
    seed = CrystalSeed(x_frac=cart, species_of=np.array([0, 1, 1]),
                       species=[Species("O", 8), Species("H", 1)],
                       ismolecule=True)
    c = seed.to_crystal()
    return JSystem.from_structure(c), \
        system_from_arrays(**crystal_to_arrays(c), device=CPU)


CASES = {
    "cosine": (_cosine, {}),
    "cosine_clip_cube": (_cosine, {"clip": ("cube", [0.2, 0.2, 0.2],
                                            [0.8, 0.8, 0.8])}),
    "cosine_clip_sphere": (_cosine, {"clip": ("sphere", [0.5, 0.5, 0.5],
                                              2.0)}),
    "cscl_grid": (_cscl_grid, {}),
    "water": (_water, {}),
}
COUNTS = {"cosine": (1, 3, 3, 1), "water": (3, 2, 0, 0)}


@pytest.fixture(scope="module")
def runs():
    """name -> (JAX system, port system, JAX CP list, port CP list)."""
    out = {}
    systems = {}
    for name, (build, kw) in CASES.items():
        if build not in systems:
            systems[build] = build()
        js, ts = systems[build]
        out[name] = (js, ts, jauto.autocp(js, **kw), tauto.autocp(ts, **kw))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_autocp_matches_jax(runs, name):
    js, ts, jcpl, tcpl = runs[name]
    ja, ta = cplist_to_arrays(jcpl), cplist_to_arrays(tcpl)
    assert tcpl.counts() == jcpl.counts()
    assert tcpl.poincare_hopf() == jcpl.poincare_hopf()
    if name in COUNTS:
        assert tcpl.counts() == COUNTS[name]
    for key in ("typ", "mult", "isnuc", "name"):
        np.testing.assert_array_equal(ta[key], ja[key])
    if name == "cscl_grid":
        # which image of an orbit represents it hangs on which seed got
        # there first: compare each CP with the nearest image of its twin
        sg = ts.crystal.spacegroup
        for xt, xj in zip(ta["x"], ja["x"]):
            imgs = (sg.rotations @ xj + sg.translations) % 1.0
            assert ts.crystal.distmat(xt, imgs).min() <= TOL_POS
    else:
        assert np.abs(ta["r"] - ja["r"]).max() <= TOL_POS
        assert np.abs(ta["x"] - ja["x"]).max() <= TOL_POS
    np.testing.assert_allclose(ta["f"], ja["f"], rtol=1e-9, atol=1e-9)
    htol = 1e-6 if name.startswith("cosine") else 1e-9   # see the docstring
    for key in ("del2f", "eig"):
        np.testing.assert_allclose(ta[key], ja[key], rtol=htol, atol=htol)
    np.testing.assert_allclose(ta["gfmod"], ja["gfmod"], rtol=0, atol=1e-10)
    assert (ta["gfmod"] < 1e-10).all()
    assert ta["x"].shape == (len(tcpl.cps), 3) and ta["eig"].shape[1] == 3


def test_clip_that_leaves_no_seed_finds_nothing(runs):
    _, ts, _, full = runs["cosine"]
    none = tauto.autocp(ts, clip=("cube", [0.26, 0.26, 0.26],
                                  [0.27, 0.27, 0.27]))
    assert sum(full.counts()) == 8 and sum(none.counts()) == 0
    with pytest.raises(ValueError, match="unknown clip kind"):
        tauto.autocp(ts, clip=("cone", [0, 0, 0], 1.0))


@pytest.mark.parametrize("name", ["cosine", "water", "cscl_grid"])
def test_reports_equal_as_text(runs, name):
    js, ts, jcpl, tcpl = runs[name]
    jcel, tcel = jauto.cell_cp_list(js, jcpl), tauto.cell_cp_list(ts, tcpl)
    assert len(tcel) == len(jcel) == sum(cp.mult for cp in tcpl.cps)
    assert [i for i, _, _ in tcel] == [i for i, _, _ in jcel]
    if name == "cscl_grid":
        # another representative lists the same orbit in another order:
        # the complete lists hold the same points
        d = ts.crystal.distmat([x for _, x, _ in tcel],
                               [x for _, x, _ in jcel])
        assert d.min(axis=1).max() <= TOL_POS
        assert d.min(axis=0).max() <= TOL_POS
        assert tauto.cp_long_report(ts, tcpl).count("\n") == \
            jauto.cp_long_report(js, jcpl).count("\n")
    else:
        assert tauto.cp_long_report(ts, tcpl) == \
            jauto.cp_long_report(js, jcpl)
    # the very long report prints 10 significant digits of values that
    # agree to ~1e-12 relative: equal up to the last printed digit
    jl = jauto.cp_vlong_report(js, jcpl).splitlines()
    tl = tauto.cp_vlong_report(ts, tcpl).splitlines()
    assert len(jl) == len(tl)
    if name == "cscl_grid":
        return
    for a, b in zip(tl, jl):
        ta, tb = a.split(), b.split()
        assert len(ta) == len(tb)
        for u, v in zip(ta, tb):
            if u != v:
                assert float(u) == pytest.approx(
                    float(v), rel=1e-8,
                    abs=1e-6 if name == "cosine" else 1e-9)


@pytest.mark.parametrize("name", ["cosine", "cscl_grid"])
def test_critshell_matches_jax(runs, name):
    js, ts, jcpl, tcpl = runs[name]
    jd, jn, jw = jauto.critshell(js, jcpl, 4)
    td, tn, tw = tauto.critshell(ts, tcpl, 4)
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-8)
    np.testing.assert_array_equal(tn, jn)
    # a shell of several equidistant CPs records whichever sorts first
    np.testing.assert_array_equal(tw[tn == 1], jw[jn == 1])


def _seed_crystals():
    """A three-atom crystal (triplet seeds need three) in both forms."""
    c = Crystal(m_x2c=m_x2c_from_cellpar([7.0, 7.5, 8.0], [90, 100, 90]),
                x_frac=np.array([[0.1, 0.1, 0.1], [0.6, 0.55, 0.5],
                                 [0.3, 0.8, 0.2]]),
                species_of=np.array([0, 1, 1]),
                species=[Species("Na", 11), Species("Cl", 17)])
    return c, crystal_from_arrays(**crystal_to_arrays(c))


@pytest.mark.parametrize("seed_kw", [
    dict(typ="ws", depth=1), dict(typ="ws", depth=2, rad=0.5),
    dict(typ="ws", depth=1, x0=np.array([0.25, 0.25, 0.25])),
    dict(typ="pair", npts=3), dict(typ="triplet"),
    dict(typ="line", x0=np.zeros(3), x1=np.ones(3) * 0.5, npts=7),
    dict(typ="sphere", x0=np.array([0.5, 0.5, 0.5]), rad=2.0, nr=3,
         ntheta=2, nphi=4),
    dict(typ="oh", x0=np.zeros(3), rad=1.5, nr=2, depth=2),
    dict(typ="point", x0=np.array([0.1, 0.2, 0.3])),
], ids=lambda kw: f"{kw['typ']}{kw.get('depth', '')}")
def test_gen_seeds_equal_jax(seed_kw):
    jc, tc = _seed_crystals()
    ref = jauto.gen_seeds(jc, [jauto.Seed(**seed_kw)])
    got = tauto.gen_seeds(tc, [tauto.Seed(**seed_kw)])
    assert len(got) > 0
    np.testing.assert_array_equal(got, ref)


def test_seed_list_and_init_cplist():
    jc, tc = _seed_crystals()
    both = [dict(typ="ws"), dict(typ="pair")]
    np.testing.assert_array_equal(
        tauto.gen_seeds(tc, [tauto.Seed(**k) for k in both]),
        jauto.gen_seeds(jc, [jauto.Seed(**k) for k in both]))
    assert tauto.gen_seeds(tc, []).shape == (0, 3)
    assert tauto.seed_ws(tc) is tauto.seed_ws(tc)          # cached
    with pytest.raises(ValueError, match="unknown seed type"):
        tauto.gen_seeds(tc, [tauto.Seed(typ="spiral")])
    js, ts = _cscl_grid(n=12)
    ja = cplist_to_arrays(jauto.init_cplist(js))
    ta = cplist_to_arrays(tauto.init_cplist(ts))
    np.testing.assert_array_equal(ta["name"], ja["name"])
    np.testing.assert_array_equal(ta["typ"], [-3, -3])
    np.testing.assert_allclose(ta["f"], ja["f"], rtol=1e-12)
    np.testing.assert_allclose(ta["eig"], ja["eig"], rtol=1e-9, atol=1e-9)
    x1 = ts.crystal.x_frac[1]
    i, d = tauto.init_cplist(ts).nearest(x1 - [0.01, 0, 0])
    assert i == 1 and d == pytest.approx(0.07)


def test_autocp_stays_on_the_systems_device(runs):
    _, ts, _, _ = runs["cosine"]
    assert ts.ref.grid.f.device.type == CPU
    assert isinstance(ts.ref.grd(np.zeros((1, 3))).f, torch.Tensor)
