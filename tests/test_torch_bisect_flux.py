"""The port's bisection (analysis/bisect.py), flux plots (analysis/flux.py),
minisurf (analysis/surface.py), scene writers (io/graphics.py), Lebedev
and radial quadratures against the JAX package, on the CPU.

Bisection radii: every step of both packages classifies the same ray
mid-points by the same traces, so the radii agree exactly unless a trace
flips; they are compared to the bisection tolerance.
"""
import numpy as np
import pytest
import torch

from critic2_tpu import System as JSystem
from critic2_tpu.analysis import bisect as jbis
from critic2_tpu.analysis import flux as jflux
from critic2_tpu.analysis import surface as jsurf
from critic2_tpu.crystal.cell import m_x2c_from_cellpar
from critic2_tpu.crystal.crystal import Crystal, Species
from critic2_tpu.crystal.seed import CrystalSeed
from critic2_tpu.io.graphics import Scene as JScene
from critic2_tpu.ops import lebedev as jleb
from critic2_tpu.ops import quadrature as jquad
from critic2_tpu import param as jparam
from critic2_tpu_torch import param as tparam
from critic2_tpu_torch.analysis import bisect as tbis
from critic2_tpu_torch.analysis import flux as tflux
from critic2_tpu_torch.analysis import surface as tsurf
from critic2_tpu_torch.convert import crystal_to_arrays, system_from_arrays
from critic2_tpu_torch.io.graphics import Scene
from critic2_tpu_torch.ops import lebedev as tleb
from critic2_tpu_torch.ops import quadrature as tquad

# the inputs are tiny: one intra-op thread a process, so that parallel
# test workers do not fight over the cores
torch.set_num_threads(1)

CPU = "cpu"


def _pair(c):
    return JSystem.from_structure(c), \
        system_from_arrays(**crystal_to_arrays(c), device=CPU)


@pytest.fixture(scope="module")
def cscl():
    return _pair(Crystal(
        m_x2c=m_x2c_from_cellpar([7.0, 7.0, 7.0], [90, 90, 90]),
        x_frac=np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]),
        species_of=np.array([0, 1]),
        species=[Species("Cs", 55), Species("Cl", 17)]))


@pytest.fixture(scope="module")
def argon():
    return _pair(Crystal(
        m_x2c=m_x2c_from_cellpar([9.0, 9.0, 9.0], [90, 90, 90]),
        x_frac=np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]),
        species_of=np.array([0, 0]), species=[Species("Ar", 18)]))


# ------------------------------------------------ numpy-only counterparts
@pytest.mark.parametrize("npts", [6, 26, 110, 302])
def test_lebedev_equals_jax(npts):
    for a, b in zip(tleb.lebedev(npts), jleb.lebedev(npts)):
        np.testing.assert_array_equal(a, b)
    assert tleb.available_rules() == jleb.available_rules()
    assert tleb.good_lebedev(npts + 1) == jleb.good_lebedev(npts + 1)


def test_radial_quadratures_equal_jax():
    def fn(pts):
        return np.exp(-np.linalg.norm(pts - 0.1, axis=1))

    sph, _ = tleb.lebedev(26)
    x0 = np.array([0.3, -0.2, 0.1])
    rend = np.linspace(1.0, 2.0, len(sph))
    np.testing.assert_array_equal(
        tquad.radial_gauleg(fn, x0, sph, 0.2, rend, nr=20),
        jquad.radial_gauleg(fn, x0, sph, 0.2, rend, nr=20))
    ta, te, tn = tquad.radial_adaptive(fn, x0, sph, 0.0, rend)
    ja, je, jn = jquad.radial_adaptive(fn, x0, sph, 0.0, rend)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(te, je)
    assert tn == jn
    for a, b in zip(tquad.gauleg(0.5, 2.0, 7), jquad.gauleg(0.5, 2.0, 7)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("gen,level", [("sphere_oct", 2), ("sphere_cub", 1)])
def test_sphere_triangulations_equal_jax(gen, level):
    tv, tf = getattr(tsurf, gen)(level)
    jv, jf = getattr(jsurf, gen)(level)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(np.linalg.norm(tv, axis=1), 1.0, atol=1e-12)


def test_minisurf_nodes_and_int_file_roundtrip(tmp_path):
    for kind in ("lebedev", "gauleg"):
        t = tsurf.MiniSurf.nodes([0.0, 0.0, 0.0], kind=kind, ntheta=6,
                                 nphi=8, npts=50)
        j = jsurf.MiniSurf.nodes([0.0, 0.0, 0.0], kind=kind, ntheta=6,
                                 nphi=8, npts=50)
        np.testing.assert_array_equal(t.verts, j.verts)
        np.testing.assert_array_equal(t.w, j.w)
        assert abs(t.w.sum() - 4 * np.pi) < 1e-10
    srf = tsurf.MiniSurf.triang([1.0, 2.0, 3.0], level=1)
    srf.r = np.linspace(0.5, 1.5, srf.nv)
    path = str(tmp_path / "s.int")
    srf.writeint(path, n1=3, n2=4, meth=1)
    back = jsurf.MiniSurf.triang([0.0, 0.0, 0.0], level=1)
    assert back.readint(path) == (3, 4, 1)
    np.testing.assert_allclose(back.r, srf.r, rtol=1e-14)
    np.testing.assert_allclose(back.n, [1.0, 2.0, 3.0])


@pytest.mark.parametrize("ext", ["obj", "ply", "off"])
def test_scene_files_equal_jax(tmp_path, ext):
    files = []
    for cls, tag in ((Scene, "t"), (JScene, "j")):
        sc = cls()
        sc.ball([0, 0, 0], r=1.0)
        sc.stick([0, 0, 0], [2, 0, 0])
        sc.path(np.array([[0, 0, 0], [1, 1, 1], [2, 2, 2.0]]))
        sc.surface(np.eye(3), [[0, 1, 2]])
        p = tmp_path / f"{tag}.{ext}"
        sc.write(str(p))
        files.append(p.read_text())
    assert files[0] == files[1] and len(files[0]) > 100
    with pytest.raises(ValueError):
        Scene().write(str(tmp_path / "scene.xyz"))


def test_bonds_and_covalent_radius_equal_jax(cscl):
    js, ts = cscl
    assert ts.crystal.bonds() == js.crystal.bonds()
    assert len(ts.crystal.bonds()) > 0
    for z in (1, 6, 17, 55):
        assert tparam.covalent_radius(z) == jparam.covalent_radius(z)


# --------------------------------------------------------------- bisection
def test_basin_rays_equal_jax():
    td, tf = tbis.basin_rays(level=1)
    jd, jf = jbis.basin_rays(level=1)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tf, jf)


def test_sphere_integral_matches_jax(cscl):
    js, ts = cscl
    r = 0.8
    tv = tbis.sphere_integral(ts, [0.0, 0.0, 0.0], r)
    jv = jbis.sphere_integral(js, [0.0, 0.0, 0.0], r)
    assert abs(tv - jv) <= 1e-10 * abs(jv)
    rho_r = float(ts.ref.grd(ts.crystal.x2c(np.array([[r / 7.0, 0, 0]])),
                             nder=0).f[0])
    assert abs(tv - 4 * np.pi * r * r * rho_r) / tv < 0.02


def test_bisect_and_basinplot_match_jax(cscl, tmp_path):
    js, ts = cscl
    tol = 1e-2
    dirs, _ = tbis.basin_rays(level=1)
    tr = tbis.bisect_basin(ts, [0.0, 0.0, 0.0], dirs, tol=tol, maxit=12)
    jr = jbis.bisect_basin(js, [0.0, 0.0, 0.0], dirs, tol=tol, maxit=12)
    np.testing.assert_allclose(tr, jr, rtol=0, atol=tol)
    rmax = float(np.linalg.norm(ts.crystal.ws.vertices, axis=1).max())
    assert np.isfinite(tr).all() and (tr > 0).all() and (tr <= rmax).all()
    # the rays towards the Cl neighbours' side end inside the cell; the
    # rays along the axes run to the next Cs image and stay "inside"
    assert tr.min() < 0.75 * rmax and tr.max() > 0.99 * rmax
    verts, faces, r = tbis.basinplot(ts, [0.0, 0.0, 0.0], level=1,
                                     file=str(tmp_path / "basin.obj"),
                                     tol=tol, maxit=12)
    assert (tmp_path / "basin.obj").exists() and len(faces) == 32
    np.testing.assert_allclose(r, tr, rtol=0, atol=tol)
    np.testing.assert_allclose(np.linalg.norm(verts, axis=1), r, atol=1e-12)


def test_basin_integral_gauleg_matches_jax(cscl, monkeypatch):
    """The radial quadrature above given radii: both packages integrate to
    the same r_IAS (the JAX radii), so the integrals agree to 1e-10."""
    js, ts = cscl
    sph, _ = tleb.lebedev(74)
    r_ias = np.full(len(sph), 2.0) + 0.3 * sph[:, 0]
    monkeypatch.setattr(tbis, "bisect_basin", lambda *a, **k: r_ias)
    monkeypatch.setattr(jbis, "bisect_basin", lambda *a, **k: r_ias)
    for kw in ({"nr": 20}, {"nr": 20, "rbeta": 0.5}):
        tq = tbis.basin_integral(ts, [0.0, 0.0, 0.0], level=1, **kw)
        jq = jbis.basin_integral(js, [0.0, 0.0, 0.0], level=1, **kw)
        assert abs(tq - jq) <= 1e-10 * abs(jq), kw
    assert 30.0 < tq < 55.0          # most of the Cs electrons
    # the adaptive panels (port only: the JAX side compiles anew for every
    # round's batch shape) against the fixed-order rule
    ta = tbis.basin_integral(ts, [0.0, 0.0, 0.0], level=1, radquad="qags",
                             rbeta=0.5, relerr=1e-5)
    assert abs(ta - tq) < 1e-3 * tq


def test_expr_is_not_ported(cscl, monkeypatch):
    """expr= now runs through the port's arithmetic.py: the reference
    field as an expression gives the plain field's integrals exactly
    (the same points and weights)."""
    _, ts = cscl
    ref = f"${ts.iref if ts.iref is not None else 0}"
    assert tbis.sphere_integral(ts, [0.0, 0.0, 0.0], 0.8, expr=ref) == \
        tbis.sphere_integral(ts, [0.0, 0.0, 0.0], 0.8)
    sph, _ = tleb.lebedev(74)
    r_ias = np.full(len(sph), 2.0) + 0.3 * sph[:, 0]
    monkeypatch.setattr(tbis, "bisect_basin", lambda *a, **k: r_ias)
    assert tbis.basin_integral(ts, [0.0, 0.0, 0.0], expr=ref, level=1,
                               nr=8) == \
        tbis.basin_integral(ts, [0.0, 0.0, 0.0], level=1, nr=8)


# -------------------------------------------------------------------- flux
def test_fluxprint_matches_jax(argon, tmp_path):
    js, ts = argon
    seeds = ts.crystal.x_cart[0] + np.array([[2.0, 0, 0], [0, 2.0, 0]])
    tsc = tflux.fluxprint(ts, seeds, iup=1, file=str(tmp_path / "t.obj"),
                          nrec=80)
    jsc = jflux.fluxprint(js, seeds, iup=1, file=str(tmp_path / "j.obj"),
                          nrec=80)
    assert len(tsc.seg) > 4 and len(tsc.seg) == len(jsc.seg)
    for tp, jp in zip(tsc.pathpts, jsc.pathpts):
        np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-9)
        # captured: the last point IS the nucleus
        assert np.linalg.norm(tp[-1] - ts.crystal.x_cart[0]) < 1e-12
    # same scene: the files have as many lines (a -0.000000 may differ)
    assert len((tmp_path / "t.obj").read_text().splitlines()) \
        == len((tmp_path / "j.obj").read_text().splitlines())


def test_fluxprint_cml_equals_jax(tmp_path):
    js, ts = _pair(Crystal(
        m_x2c=np.diag([6.0, 6.0, 6.0]),
        x_frac=np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]),
        species_of=np.array([0, 1]),
        species=[Species("Na", 11), Species("Cl", 17)]))
    seeds = np.array([[1.0, 0.4, 0.2]])
    tflux.fluxprint(ts, seeds, file=str(tmp_path / "t.cml"), nrec=40)
    jflux.fluxprint(js, seeds, file=str(tmp_path / "j.cml"), nrec=40)
    text = (tmp_path / "t.cml").read_text()
    assert 'elementType="Xz"' in text and "xFract" in text
    assert text == (tmp_path / "j.cml").read_text()


def test_fluxprint_downhill_molecule_matches_jax(tmp_path):
    cart = np.array([[0.0, 0.0, 0.22], [0.0, 1.43, -0.89],
                     [0.0, -1.43, -0.89]])
    js, ts = _pair(CrystalSeed(
        x_frac=cart, species_of=np.array([0, 1, 1]),
        species=[Species("O", 8), Species("H", 1)],
        ismolecule=True).to_crystal())
    seeds = ts.crystal.x_cart[0] + np.array([[0.3, 0.2, 0.4]])
    tsc = tflux.fluxprint(ts, seeds, iup=-1, nrec=60,
                          file=str(tmp_path / "t.cml"))
    jsc = jflux.fluxprint(js, seeds, iup=-1, nrec=60,
                          file=str(tmp_path / "j.cml"))
    np.testing.assert_allclose(tsc.pathpts[0], jsc.pathpts[0], rtol=0,
                               atol=1e-9)
    assert 'x3="' in (tmp_path / "t.cml").read_text()


def test_cpreport_scene_writes_structure_cps_and_bond_paths(argon, tmp_path):
    from critic2_tpu_torch.analysis.autocp import Seed, autocp, makegraph

    _, ts = argon
    cpl = autocp(ts, seeds=[Seed(typ="ws", depth=0)])
    makegraph(ts, cpl)
    scene = tflux.cpreport_scene(ts, cpl, str(tmp_path / "cps.ply"))
    assert (tmp_path / "cps.ply").stat().st_size > 500
    nbcp = sum(cp.typ == -1 for cp in cpl.cps)
    assert nbcp > 0 and len(scene.seg) > 2 * nbcp
