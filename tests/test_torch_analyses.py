"""The port's grid and structure analyses - Hirshfeld charges, XDM,
STM images, POINT/LINE/PLANE/CUBE, POWDER/RDF/COMPARE - against the JAX
package, on the CPU.

The bars of tests/test_xdm.py:44-152, test_rhoplot.py,
test_flux_stm.py:57-80 and test_struct.py (:27-55, :207-234, :263-289)
are repeated on the port, and each result is held against the JAX
package's on the same input, at 16^3 or less. Tolerances are stated per
assertion.
"""
import os
import sys
import tempfile

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from critic2_tpu import System as JSystem
from critic2_tpu import param
from critic2_tpu.analysis import hirshfeld as jh
from critic2_tpu.analysis import rhoplot as jrp
from critic2_tpu.analysis import stm as jstm
from critic2_tpu.analysis import struct as jst
from critic2_tpu.analysis import xdm as jxdm
from critic2_tpu.analysis.integration import _rasterize_field as jraster
from critic2_tpu.crystal.cell import m_x2c_from_cellpar
from critic2_tpu.crystal.crystal import Crystal, Species
from critic2_tpu.fields.field import Field as JField
from critic2_tpu.fields.grid3 import Grid3 as JGrid3
from critic2_tpu_torch import System
from critic2_tpu_torch.analysis import hirshfeld as th
from critic2_tpu_torch.analysis import rhoplot as trp
from critic2_tpu_torch.analysis import stm as tstm
from critic2_tpu_torch.analysis import struct as tst
from critic2_tpu_torch.analysis import xdm as txdm
from critic2_tpu_torch.convert import (crystal_from_arrays,
                                       crystal_to_arrays,
                                       system_from_arrays)
from critic2_tpu_torch.fields.grid3 import Grid3

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_molden import H2_MOLDEN  # noqa: E402
from test_xdm import _scalar_newton  # noqa: E402

# the inputs are tiny: one intra-op thread a process, so that parallel
# test workers do not fight over the cores
torch.set_num_threads(1)

CPU = "cpu"


def _port(c):
    return crystal_from_arrays(**crystal_to_arrays(c))


def _grid_pair(c, shape):
    """(JAX system, port system, rho numpy): the JAX package's
    rasterized promolecular density loaded as the reference grid of
    both."""
    js = JSystem.from_structure(c)
    g = np.asarray(jraster(js.fields[0], shape))
    js.load_field(JField.from_grid(c, JGrid3(jnp.asarray(g))))
    return js, system_from_arrays(**crystal_to_arrays(c), grid=g,
                                  device=CPU), g


def _nacl8(a_ang=5.6402, shift=0.0):
    a = a_ang * param.ANGSTROM_TO_BOHR
    base = np.array([[0, 0, 0], [0, .5, .5], [.5, 0, .5], [.5, .5, 0]])
    return Crystal(m_x2c=m_x2c_from_cellpar([a, a, a], [90, 90, 90]),
                   x_frac=(np.vstack([base, (base + [.5, .5, .5]) % 1.0])
                           + shift) % 1.0,
                   species_of=np.array([0] * 4 + [1] * 4),
                   species=[Species("Na", 11), Species("Cl", 17)])


# ---------------------------------------------------------------------------
# Hirshfeld
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("block", [1 << 15, 97])
def test_hirshfeld_nacl(block):
    """tests/test_struct.py:211-232 on the port at 8^3: populations sum
    to the grid integral (1e-8), all Na alike and all Cl alike (1e-6),
    Cl holds more; every population equals the JAX package's to 1e-12
    relative, whatever the block (one pass, or ragged blocks of 97)."""
    js, s, g = _grid_pair(_nacl8(shift=0.013), (8, 8, 8))
    res = th.hirshfeld_charges(s, block=block)
    assert abs(res.pops.sum() - g.sum() * s.crystal.volume / g.size) < 1e-8
    np.testing.assert_allclose(res.pops[:4], res.pops[0], rtol=1e-6)
    np.testing.assert_allclose(res.pops[4:], res.pops[4], rtol=1e-6)
    assert res.pops[4] > res.pops[0] > 0
    jres = jh.hirshfeld_charges(js)
    np.testing.assert_allclose(res.pops, jres.pops, rtol=1e-12)
    np.testing.assert_allclose(res.charges, jres.charges, rtol=1e-11)
    assert res.table().splitlines()[0] == jres.table().splitlines()[0]


# ---------------------------------------------------------------------------
# XDM
# ---------------------------------------------------------------------------
def test_br_inversion_matches_scalar_and_jax():
    """tests/test_xdm.py:44-61 on the port (the scalar Newton, 1e-8) and
    the JAX package's b to 1e-12 relative."""
    rng = np.random.default_rng(0)
    rho = rng.uniform(0.01, 2.0, 64)
    grad = rng.uniform(0.0, 1.0, 64)
    tau = grad ** 2 / (8 * rho) + rng.uniform(0.01, 1.0, 64)
    lap = rng.uniform(-2.0, 2.0, 64)
    b = txdm.br_hole_b(*(torch.as_tensor(v) for v in (rho, grad, lap,
                                                     tau))).numpy()
    for idx in range(0, 64, 7):
        rhos = max(rho[idx], 1e-14) / 2
        ds = tau[idx] / 2 - 0.25 * (grad[idx] / 2) ** 2 / rhos
        qs = (lap[idx] / 2 - 2 * ds) / 6
        x = _scalar_newton((2 / 3) * np.pi ** (2 / 3) * rhos ** (5 / 3) / qs)
        assert abs(b[idx] - x * (np.exp(-x) / (8 * np.pi * rhos))
                   ** (1 / 3)) < 1e-8
    bj = np.asarray(jxdm.br_hole_b(*(jnp.asarray(v) for v in
                                     (rho, grad, lap, tau))))
    np.testing.assert_allclose(b, bj, rtol=1e-12)


def test_xdm_grid_argon_matches_jax():
    """tests/test_xdm.py:64-87 on the port, at 12^3: negative energy,
    symmetric C6 equal over the identical atoms (1e-6), C6 in 5-300,
    positive moments, rvdw > 0.68 rc, forces below 1e-6; C6, C8, C10,
    the moments and the energy equal the JAX package's to 1e-10
    relative."""
    a = 10.0
    c = Crystal(m_x2c=m_x2c_from_cellpar([a, a, a], [90, 90, 90]),
                x_frac=np.array([[0, 0, 0], [0, .5, .5], [.5, 0, .5],
                                 [.5, .5, 0]]),
                species_of=np.array([0] * 4), species=[Species("Ar", 18)])
    js, s, _ = _grid_pair(c, (12, 12, 12))
    res = txdm.xdm_grid(s)
    assert res.energy < 0.0
    np.testing.assert_allclose(res.c6, res.c6.T)
    np.testing.assert_allclose(res.c6, res.c6[0, 0], rtol=1e-6)
    assert 5.0 < res.c6[0, 0] < 300.0 and (res.moments > 0).all()
    assert (res.rvdw > res.rc * 0.68).all()
    assert np.abs(res.forces).max() < 1e-6
    jres = jxdm.xdm_grid(js)
    for k in ("c6", "c8", "c10", "moments", "volumes", "alpha"):
        np.testing.assert_allclose(getattr(res, k), getattr(jres, k),
                                   rtol=1e-10)
    assert abs(res.energy - jres.energy) <= 1e-10 * abs(jres.energy)


def test_xdm_qe_matches_jax(tmp_path):
    """tests/test_xdm.py:90-152: the parsed table and the damped sum
    equal the JAX package's exactly, with and without BETWEEN/AND."""
    c = Crystal(m_x2c=m_x2c_from_cellpar([8.0] * 3, [90] * 3),
                x_frac=np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]),
                species_of=np.array([0, 0]), species=[Species("Ar", 18)])
    c6 = np.array([[64.3, 61.7], [61.7, 60.0]])
    lines = ["some pw.x header", "* XDM dispersion", "  a1 = 0.6836",
             "  junk", "  a2 = 1.5045", "", "+ Dispersion coefficients"]
    for i in range(2):
        for j in range(i + 1):
            lines.append(f" {i + 1} {j + 1} {c6[i, j]} {20 * c6[i, j]} "
                         f"{300 * c6[i, j]} 3.1 4.6")
    path = tmp_path / "pw.out"
    path.write_text("\n".join(lines) + "\n")
    s = System.from_structure(_port(c), device=CPU)
    js = JSystem.from_structure(c)
    for kw in ({}, {"between": [1], "and_": [2]}):
        res = txdm.xdm_qe(s, path=str(path), **kw)
        jres = jxdm.xdm_qe(js, path=str(path), **kw)
        assert res.energy == jres.energy < 0.0
        np.testing.assert_array_equal(res.c6, jres.c6)


def test_xdm_wfn_matches_jax():
    """xdm_wfn on H2/STO-3G over the small Becke mesh: C6, the moments,
    the volumes and the energy equal the JAX package's to 1e-10
    relative; the energy is negative."""
    p = os.path.join(tempfile.mkdtemp(), "h2.molden")
    with open(p, "w") as fh:
        fh.write(H2_MOLDEN)
    s = System.from_structure(p, device=CPU)
    s.load_field(p)
    js = JSystem.from_structure(p)
    js.load_field(p)
    res = txdm.xdm_wfn(s, lvl="small")
    jres = jxdm.xdm_wfn(js, lvl="small")
    assert res.energy < 0.0
    for k in ("c6", "moments", "volumes"):
        np.testing.assert_allclose(getattr(res, k), getattr(jres, k),
                                   rtol=1e-10)
    assert abs(res.energy - jres.energy) <= 1e-10 * abs(jres.energy)


# ---------------------------------------------------------------------------
# STM
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def slab():
    """tests/test_flux_stm.py:57-80: one carbon layer at z = 0.2 of a
    tall cell, rasterized at 12x12x36."""
    c = Crystal(m_x2c=m_x2c_from_cellpar([6.0, 6.0, 20.0], [90, 90, 90]),
                x_frac=np.array([[0.0, 0.0, 0.2], [0.5, 0.5, 0.2]]),
                species_of=np.array([0, 0]), species=[Species("C", 6)])
    return _grid_pair(c, (12, 12, 36))


def test_stm_slab(slab):
    """The bars of tests/test_flux_stm.py:57-80 on the port, and both
    images equal the JAX package's (height 1e-12 relative; the current
    heights bisect the same densities, 1e-12 absolute in fractional
    z)."""
    js, s, _ = slab
    rh = tstm.stm(s, mode="height", npts=(24, 24))
    assert rh.image.shape == (24, 24) and abs(rh.ztop - 0.2) > 0.2
    jrh = jstm.stm(js, mode="height", npts=(24, 24))
    assert rh.ztop == jrh.ztop and rh.extent == jrh.extent
    np.testing.assert_allclose(rh.image, jrh.image, rtol=1e-12)
    rc = tstm.stm(s, mode="current", level=1e-4, npts=(16, 16), block=100)
    assert rc.image.min() > 0.2 and rc.image.max() <= rc.ztop + 1e-9
    assert rc.image.std() > 1e-4
    jrc = jstm.stm(js, mode="current", level=1e-4, npts=(16, 16))
    np.testing.assert_allclose(rc.image, jrc.image, rtol=0, atol=1e-12)


def test_stm_default_level_and_bad_mode(slab):
    """The default current level and its image equal the JAX package's
    (the pixel count of test_stm_slab, so the JAX package reuses its
    compiled bisection); an unknown mode raises."""
    js, s, _ = slab
    rc = tstm.stm(s, npts=(16, 16))
    jrc = jstm.stm(js, npts=(16, 16))
    assert abs(rc.value - jrc.value) <= 1e-15 * jrc.value
    np.testing.assert_allclose(rc.image, jrc.image, rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="unknown STM mode"):
        tstm.stm(s, mode="sideways", npts=(2, 2))


# ---------------------------------------------------------------------------
# POINT / LINE / PLANE / CUBE
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def carbon():
    """tests/test_rhoplot.py: two carbons in an 8 bohr cube, the
    promolecular density."""
    c = Crystal(m_x2c=m_x2c_from_cellpar([8.0, 8.0, 8.0], [90, 90, 90]),
                x_frac=np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]),
                species_of=np.array([0, 0]), species=[Species("C", 6)])
    return JSystem.from_structure(c), System.from_structure(_port(c),
                                                            device=CPU)


def test_point_matches_jax(carbon):
    js, s = carbon
    rep = trp.point(s, [0.25, 0.2, 0.3])
    jrep = jrp.point(js, [0.25, 0.2, 0.3])
    assert rep.f > 0 and rep.eig[0] <= rep.eig[1] + 1e-12 <= \
        rep.eig[2] + 2e-12 and "POINT" in str(rep)
    for k in ("f", "gf", "hf", "gfmod", "del2f", "eig", "ellipticity"):
        np.testing.assert_allclose(getattr(rep, k), getattr(jrep, k),
                                   rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("what", ["f", "gx", "gmod", "xy", "zz", "lap",
                                  "2*$0"])
def test_line_matches_jax(carbon, what):
    """Every selector kind and an expression along a segment, 1e-12
    relative; the density profile between the two atoms is symmetric
    (1e-8, tests/test_rhoplot.py:27-38)."""
    js, s = carbon
    t, dist, vals = trp.line(s, [0, 0, 0], [0.5, 0.5, 0.5], npts=41,
                             what=what)
    jt, jd, jv = jrp.line(js, [0, 0, 0], [0.5, 0.5, 0.5], npts=41,
                          what=what)
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_allclose(vals, jv, rtol=1e-12, atol=1e-14)
    if what == "f":
        np.testing.assert_allclose(vals, vals[::-1], rtol=1e-8)
        assert vals[0] > vals[20]


def test_plane_and_gnuplot_match_jax(carbon, tmp_path):
    """PLANE with a contour emission: values equal the JAX package's
    (1e-12), corners of the periodic plane equal (1e-8), and the .dat
    and .gnu files equal the JAX package's byte for byte."""
    js, s = carbon
    f, jf = tmp_path / "p.dat", tmp_path / "j.dat"
    u, v, vals = trp.plane(s, [0, 0, 0], [1, 0, 0], [0, 1, 0], nx=11, ny=11,
                           file=str(f), emit="contour")
    _, _, jvals = jrp.plane(js, [0, 0, 0], [1, 0, 0], [0, 1, 0], nx=11,
                            ny=11, file=str(jf), emit="contour")
    assert vals.shape == (11, 11)
    np.testing.assert_allclose(vals, jvals, rtol=1e-12)
    np.testing.assert_allclose(vals[0, 0], vals[-1, -1], rtol=1e-8)
    assert f.read_text() == jf.read_text()
    assert (tmp_path / "p.gnu").read_text().replace("p.", "j.") == \
        (tmp_path / "j.gnu").read_text()


@pytest.mark.parametrize("what", ["f", "lap", "gtf(0) - $0:g"])
def test_cube_matches_jax(carbon, what):
    """CUBE on a 9x8x7 box with an origin and lengths: the tensor equals
    the JAX package's array to 1e-12 relative, in ragged blocks; a node
    Laplacian equals grd's (1e-10, tests/test_rhoplot.py:59-65)."""
    js, s = carbon
    kw = dict(n=(9, 8, 7), origin=(0.1, 0.0, 0.2), lengths=(0.9, 1.0, 0.8))
    data = trp.cube(s, what=what, block=100, **kw)
    assert isinstance(data, torch.Tensor) and tuple(data.shape) == (9, 8, 7)
    np.testing.assert_allclose(data.numpy(), jrp.cube(js, what=what, **kw),
                               rtol=1e-12, atol=1e-14)
    if what == "lap":
        d8 = trp.cube(s, n=(8, 8, 8), what="lap")
        x = np.array([[3 / 8, 5 / 8, 7 / 8]]) @ np.asarray(s.crystal.m_x2c).T
        assert abs(float(d8[3, 5, 7]) - float(s.ref.grd(x).del2f[0])) < 1e-10


def test_grid_files_match_jax(carbon, tmp_path):
    """write_grid_file's four formats (tests/test_rhoplot.py:81-118):
    the port's files equal the JAX package's byte for byte (bincube,
    CHGCAR, xsf, cube), and the readers give the data back."""
    c = Crystal(m_x2c=np.diag([8.0, 9.0, 10.0]),
                x_frac=np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]),
                species_of=np.array([0, 1]),
                species=[Species("Na", 11), Species("Cl", 17)])
    data = np.random.default_rng(3).random((6, 5, 4)) + 0.5
    for name in ("t.bincube", "CHGCAR", "t.xsf", "t.cube"):
        (tmp_path / "p").mkdir(exist_ok=True)
        (tmp_path / "j").mkdir(exist_ok=True)
        trp.write_grid_file(_port(c), torch.as_tensor(data),
                            str(tmp_path / "p" / name))
        jrp.write_grid_file(c, data, str(tmp_path / "j" / name))
        assert (tmp_path / "p" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name
    g = Grid3.from_file(str(tmp_path / "p" / "t.bincube"), device=CPU)
    np.testing.assert_array_equal(g.f.numpy(), data)
    js, s = carbon
    out = trp.cube(s, n=(6, 6, 6), file=str(tmp_path / "rho.cube"))
    g = Grid3.read_cube(str(tmp_path / "rho.cube"), device=CPU)
    np.testing.assert_allclose(g.f.numpy(), out.numpy(), rtol=2e-4,
                               atol=1e-12)


def test_grdvec_on_the_port(carbon, tmp_path):
    """GRDVEC from a 2x2 seed grid: the contour is the port's PLANE
    exactly, each of the 8 projected paths (4 seeds, up and down) starts
    at its seed's projection (1e-12 bohr), and the .dat is written. The
    JAX package's GRDVEC test is marked slow (its recorded tracer
    compiles for minutes on a cold cache); PLANE and the recorded tracer
    are held against it in test_plane_and_gnuplot_match_jax and
    tests/test_torch_ode.py."""
    _, s = carbon
    vals, paths = trp.grdvec(s, [0, 0, 0], [1, 0, 0], [0, 1, 0], nseed=2,
                             nx=5, ny=5, nrec=20,
                             file=str(tmp_path / "g.dat"))
    _, _, pvals = trp.plane(s, [0, 0, 0], [1, 0, 0], [0, 1, 0], nx=5, ny=5)
    np.testing.assert_array_equal(vals, pvals)
    assert len(paths) == 8
    a = 8.0
    t = np.linspace(0.1, 0.9, 2)
    starts = sorted((u * a, v * a) for u in t for v in t)
    for p in paths:
        d = min(np.hypot(p[0, 0] - x, p[0, 1] - y) for x, y in starts)
        assert d < 1e-12 and np.isfinite(p).all()
    assert (tmp_path / "g.dat").stat().st_size > 500


def test_cube_states_needs_a_pwc_grid(carbon):
    _, s = carbon
    with pytest.raises(ValueError, match="pwc-loaded"):
        trp.cube_states(s, "unk", 1, ik=1)


# ---------------------------------------------------------------------------
# POWDER / RDF / COMPARE
# ---------------------------------------------------------------------------
def test_powder_matches_jax():
    """tests/test_struct.py:27-34: the strongest peak (200) at 31.70 deg
    and (111) near 27.37 (0.1 deg); pattern and peak list equal the JAX
    package's exactly (the same host numpy)."""
    pat = tst.powder(_port(_nacl8()), th2ini=10, th2end=60, npts=2001)
    jpat = jst.powder(_nacl8(), th2ini=10, th2end=60, npts=2001)
    assert pat.ih.max() == pytest.approx(100.0)
    assert abs(pat.peaks_t[pat.peaks_i.argmax()] - 31.70) < 0.1
    assert np.min(np.abs(pat.peaks_t - 27.37)) < 0.1
    for k in ("t", "ih", "peaks_t", "peaks_i", "peaks_hkl"):
        np.testing.assert_array_equal(getattr(pat, k), getattr(jpat, k))


def test_rdf_matches_jax():
    """tests/test_struct.py:37-43: a peak at the Na-Cl distance a/2
    (0.05 bohr); the curve equals the JAX package's to 1e-12 relative."""
    pat = tst.rdf(_port(_nacl8()), rend=12.0, npts=2001, device=CPU)
    jpat = jst.rdf(_nacl8(), rend=12.0, npts=2001)
    a = 5.6402 * param.ANGSTROM_TO_BOHR
    ih = pat.ih
    peaks = pat.t[1:-1][(ih[1:-1] > ih[:-2]) & (ih[1:-1] > ih[2:])]
    assert np.min(np.abs(peaks - a / 2)) < 0.05
    np.testing.assert_allclose(ih, jpat.ih, rtol=1e-12, atol=1e-300)


@pytest.mark.parametrize("method", ["powder", "rdf"])
def test_compare_crystals_matches_jax(method):
    """tests/test_struct.py:46-53: identical structures at distance
    below 1e-8, a strained one above 0.1 (powder), a symmetric matrix;
    both methods equal the JAX package's to 1e-10 absolute."""
    cs = [_nacl8(), _nacl8(), _nacl8(a_ang=6.2)]
    kw = dict(th2ini=10, th2end=60, npts=2001) if method == "powder" \
        else dict(rend=10.0, npts=1001)
    d = tst.compare([_port(c) for c in cs], method=method, device=CPU, **kw)
    jd = jst.compare(cs, method=method, **kw)
    assert d[0, 1] < 1e-8 and np.allclose(d, d.T)
    if method == "powder":
        assert d[0, 2] > 0.1
    np.testing.assert_allclose(d, jd, rtol=0, atol=1e-10)


def test_compare_molecules_rmsd_matches_jax():
    """tests/test_struct.py:263-288: the rotated and shifted copy at
    RMSD below 1e-8, the distorted one between 0.05 and 0.3; equal to
    the JAX package's to 1e-12."""
    def mol(cls_c, cls_s, coords):
        coords = np.asarray(coords, dtype=float)
        return cls_c(m_x2c=np.diag([30.0] * 3), x_frac=(coords + 15) / 30,
                     species_of=np.arange(len(coords)) % 2,
                     species=[cls_s("O", 8), cls_s("H", 1)],
                     ismolecule=True)

    from critic2_tpu_torch.crystal.crystal import Crystal as TC
    from critic2_tpu_torch.crystal.crystal import Species as TS

    a = np.array([[0, 0, 0], [0, 0, 1.8], [0, 1.7, -0.5], [1.2, 0, -0.6]])
    th = 0.9
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1]])
    b = a @ R.T + [2.0, 1.0, -1.0]
    c = a + [[0, 0, 0], [0, 0, 0.3], [0, 0, 0], [0, 0, 0]]
    d = tst.compare([mol(TC, TS, x) for x in (a, b, c)])
    jd = jst.compare([mol(Crystal, Species, x) for x in (a, b, c)])
    assert d[0, 1] < 1e-8 and 0.05 < d[0, 2] < 0.3
    np.testing.assert_allclose(d, jd, rtol=0, atol=1e-12)


def test_coordination_and_packing_match_jax():
    """COORD and PACKING (tests/test_struct.py:207-208): the same
    numbers as the JAX package."""
    c = _nacl8()
    np.testing.assert_array_equal(tst.coordination(_port(c), 1.6),
                                  jst.coordination(c, 1.6))
    p = tst.packing_ratio(_port(c))
    assert 0 < p < 100 and p == jst.packing_ratio(c)
