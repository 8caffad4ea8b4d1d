"""Crystal tools of the torch port against the JAX package, on the CPU.

Space-group names and settings, Wyckoff letters, point groups, fragments
and molecules, cell transformations, nearest-atom lists and the structure
writers: the same crystals through both packages. Integer results,
symbols and letters must be equal; real arrays within 1e-12 (the code is
the same NumPy, so in practice equal); every writer's file byte for byte
equal. nciplot(molmotif=True) on a molecular crystal is held to
tests/test_torch_nci.py's float64 bound (1e-10 of the cube's largest
magnitude) and writes the same completed-molecule geometry.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from critic2_tpu import param as jparam
from critic2_tpu.analysis.integration import _rasterize_field
from critic2_tpu.analysis.nci import nciplot as jnci
from critic2_tpu.crystal import fragment as jfrag
from critic2_tpu.crystal import library as jlib
from critic2_tpu.crystal import spgs as jspgs
from critic2_tpu.crystal import sympg as jsympg
from critic2_tpu.crystal import transform as jtrans
from critic2_tpu.crystal.cell import m_x2c_from_cellpar
from critic2_tpu.crystal.cell import metric_tensor as jmetric
from critic2_tpu.crystal.cell import reciprocal_vectors as jrecip
from critic2_tpu.crystal.crystal import Crystal as JCrystal
from critic2_tpu.crystal.crystal import Species as JSpecies
from critic2_tpu.crystal.seed import CrystalSeed as JSeed
from critic2_tpu.fields.field import Field as JField
from critic2_tpu.fields.grid3 import Grid3 as JGrid3
from critic2_tpu.io import writers as jwriters
from critic2_tpu.system import System as JSystem
from critic2_tpu_torch import System
from critic2_tpu_torch import param as tparam
from critic2_tpu_torch.analysis.nci import nciplot as tnci
from critic2_tpu_torch.convert import (crystal_from_arrays, crystal_to_arrays,
                                       system_from_arrays)
from critic2_tpu_torch.crystal import fragment as tfrag
from critic2_tpu_torch.crystal import spgs as tspgs
from critic2_tpu_torch.crystal import sympg as tsympg
from critic2_tpu_torch.crystal import transform as ttrans
from critic2_tpu_torch.crystal.cell import metric_tensor as tmetric
from critic2_tpu_torch.crystal.cell import reciprocal_vectors as trecip
from critic2_tpu_torch.io import writers as twriters

import test_fragment
import test_struct

# the inputs are tiny: one intra-op thread a process, so that parallel
# test workers do not fight over the cores
torch.set_num_threads(1)

CPU = "cpu"
TOL = 1e-12


def port(jc):
    return crystal_from_arrays(**crystal_to_arrays(jc))


def assert_same_crystal(jc, tc, tol=TOL):
    ja, ta = crystal_to_arrays(jc), crystal_to_arrays(tc)
    assert ta["species"] == ja["species"]
    np.testing.assert_array_equal(ta["species_of"], ja["species_of"])
    for k in ("m_x2c", "x_frac"):
        assert ta[k].shape == ja[k].shape, k
        np.testing.assert_allclose(ta[k], ja[k], rtol=0, atol=tol)


def _textbook(name):
    """The crystals of the JAX package's space-group and Wyckoff tests."""
    x8 = np.array([[0, 0, 0], [.5, 0, 0], [0, .5, 0], [0, 0, .5],
                   [.5, .5, 0], [.5, 0, .5], [0, .5, .5], [.5, .5, .5]])
    if name == "NaCl":
        return JCrystal(m_x2c=np.diag([5.64] * 3), x_frac=x8,
                        species_of=np.array([0, 1, 1, 1, 0, 0, 0, 1]),
                        species=[JSpecies("Na", 11), JSpecies("Cl", 17)])
    if name == "CsCl":
        return JCrystal(m_x2c=np.diag([4.11] * 3),
                        x_frac=np.array([[0, 0, 0], [.5, .5, .5]]),
                        species_of=np.array([0, 1]),
                        species=[JSpecies("Cs", 55), JSpecies("Cl", 17)])
    if name == "Si":
        xs = [(np.array(b) + f) % 1
              for f in [(0, 0, 0), (0, .5, .5), (.5, 0, .5), (.5, .5, 0)]
              for b in [(0, 0, 0), (.25, .25, .25)]]
        return JCrystal(m_x2c=np.diag([5.43] * 3), x_frac=np.array(xs),
                        species_of=np.zeros(8, dtype=int),
                        species=[JSpecies("Si", 14)])
    if name == "rutile":
        u = 0.305
        xr = np.array([[0, 0, 0], [.5, .5, .5], [u, u, 0],
                       [(-u) % 1, (-u) % 1, 0], [.5 + u, .5 - u, .5],
                       [.5 - u, .5 + u, .5]])
        return JCrystal(m_x2c=np.diag([8.68, 8.68, 5.59]), x_frac=xr,
                        species_of=np.array([0, 0, 1, 1, 1, 1]),
                        species=[JSpecies("Ti", 22), JSpecies("O", 8)])
    if name == "nacl_conventional":
        return test_struct._nacl()
    if name == "triclinic":
        return JCrystal(m_x2c=m_x2c_from_cellpar([7.0, 7.5, 8.0],
                                                 [88.0, 95.0, 91.0]),
                        x_frac=np.array([[0.1, 0.2, 0.3],
                                         [0.6, 0.55, 0.7]]),
                        species_of=np.array([0, 1]),
                        species=[JSpecies("Na", 11), JSpecies("Cl", 17)])
    return test_fragment._co2_crystal()


TEXTBOOK = ["NaCl", "CsCl", "rutile", "triclinic", "co2"]
# symmetry detection in a cubic group of many atoms takes 3 to 66 s for
# both packages together on one core; NaCl above stands for them
SLOW_SYMMETRY = {"sulphur", "magnetite", "spinel", "b1", "mgo", "fluorite",
                 "si", "a4", "a1", "b3"}
LIBRARY = [e[0] for e in jlib.library_entries(mol=False)
           if e[0] not in SLOW_SYMMETRY]


@pytest.mark.parametrize("name", TEXTBOOK)
def test_spg_name_and_wyckoffs_match_jax(name):
    jc = _textbook(name)
    tc = port(jc)
    assert tc.spg_name() == jc.spg_name()
    assert tc.wyckoffs() == jc.wyckoffs()
    np.testing.assert_array_equal(np.asarray(tc.spacegroup.irr_idx),
                                  np.asarray(jc.spacegroup.irr_idx))
    if name == "NaCl":
        assert tc.spg_name()[1] == 225
        assert sorted(tc.wyckoffs()) == ["a", "b"]


@pytest.mark.parametrize("entry", LIBRARY)
def test_library_crystal_symmetry_matches_jax(entry):
    """spg name, ITA number and Wyckoff letters of the crystals of the
    structure library (all but SLOW_SYMMETRY)."""
    jc = jlib.load_library_entry(entry).to_crystal()
    tc = port(jc)
    assert tc.spg_name() == jc.spg_name()
    assert tc.wyckoffs() == jc.wyckoffs()


SIDS = np.arange(1, 307).reshape(17, 18)


@pytest.mark.parametrize("chunk", range(len(SIDS)))
def test_spgs_settings_match_jax(chunk):
    """Every Shmueli setting: fields, rotations, translations, centering
    vectors and the full coset list."""
    assert tspgs.nsettings() == jspgs.nsettings() == 306
    for sid in SIDS[chunk]:
        js, ts = jspgs.setting(int(sid)), tspgs.setting(int(sid))
        for k in ("id", "ita_number", "short", "system", "centering",
                  "centrosymmetric"):
            assert getattr(ts, k) == getattr(js, k), (sid, k)
        for k in ("rotations", "translations", "cenvs"):
            np.testing.assert_array_equal(getattr(ts, k), getattr(js, k))
        for a, b in zip(ts.full_ops(), js.full_ops()):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("symbol", [
    "p 1", "p -1", "p m -3 m", "f m -3 m", "p 63/m m c", "r -3 m",
    "p n m a", "i 41/a m d 1", "f d -3 m 1", "c 2/c", "c 1 2/c 1", "p 21",
    "no such group"])
def test_symbol_to_id_matches_jax(symbol):
    assert tspgs.symbol_to_id(symbol) == jspgs.symbol_to_id(symbol)


def test_identify_from_ops_matches_jax():
    for name in ("NaCl", "Si", "rutile"):
        sg = port(_textbook(name)).spacegroup
        a = tspgs.identify_from_ops(sg.rotations, sg.translations)
        b = jspgs.identify_from_ops(sg.rotations, sg.translations)
        assert (a.id, a.short) == (b.id, b.short)
    assert tspgs.identify_from_ops(np.eye(3)[None] * 2, np.zeros((1, 3))) \
        is None


POINT_GROUPS = {
    "C2v": ([[0, 0, .1173], [0, .7572, -.4692], [0, -.7572, -.4692]],
            [8, 1, 1]),
    "C3v": ([[0, 0, .1], [.94, 0, -.3], [-.47, .814, -.3],
             [-.47, -.814, -.3]], [7, 1, 1, 1]),
    "Td": ([[0, 0, 0]] + [[x, y, z] for x, y, z in
                          [(1, 1, 1), (1, -1, -1), (-1, 1, -1),
                           (-1, -1, 1)]], [6, 1, 1, 1, 1]),
    "Oh": ([[0, 0, 0]] + [list(v) for v in
                          np.vstack([np.eye(3), -np.eye(3)])],
           [16, 9, 9, 9, 9, 9, 9]),
    "Dooh": ([[0, 0, 0], [0, 0, 1.16], [0, 0, -1.16]], [6, 8, 8]),
    "Coov": ([[0, 0, 0], [0, 0, 1.06], [0, 0, -1.16]], [6, 1, 7]),
    "D6h": ([[np.cos(a), np.sin(a), 0] for a in np.arange(6) * np.pi / 3]
            + [[2 * np.cos(a), 2 * np.sin(a), 0]
               for a in np.arange(6) * np.pi / 3], [6] * 6 + [1] * 6),
    "Kh": ([[0.0, 0.0, 0.0]], [2]),
}


@pytest.mark.parametrize("want", sorted(POINT_GROUPS))
def test_point_groups_match_jax(want):
    coords, z = POINT_GROUPS[want]
    coords, z = np.array(coords, float), np.array(z)
    js, jops = jsympg.molecular_point_group(coords, z)
    ts, tops = tsympg.molecular_point_group(coords, z)
    assert ts == js == want
    assert (tops is None) == (jops is None)
    if tops is not None:
        np.testing.assert_array_equal(tops, jops)
        assert tsympg.schoenflies(tops) == jsympg.schoenflies(jops)
    if want not in ("Dooh", "Coov", "Kh"):
        np.testing.assert_array_equal(tsympg.point_ops(coords, z),
                                      jsympg.point_ops(coords, z))


def _polymer():
    return JCrystal(m_x2c=np.diag([2.6, 15.0, 15.0]),
                    x_frac=np.array([[0.0, 0.5, 0.5]]),
                    species_of=np.array([0]), species=[JSpecies("C", 6)])


def _frag_arrays(f):
    return (np.asarray(f.at_idx), np.asarray(f.lvec), f.discrete)


def _same_frag(a, b):
    for x, y in zip(_frag_arrays(a), _frag_arrays(b)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", ["co2", "polymer", "NaCl", "rutile"])
def test_list_molecules_matches_jax(name):
    jc = _polymer() if name == "polymer" else _textbook(name)
    tc = port(jc)
    jfr, jmol = jfrag.list_molecules(jc)
    tfr, tmol = tfrag.list_molecules(tc)
    assert tmol == jmol and len(tfr) == len(jfr)
    for a, b in zip(tfr, jfr):
        _same_frag(a, b)
    if name == "co2":
        assert tmol and [f.n for f in tfr] == [3, 3]
        merged = tfr[0].append(tfr[0]).append(tfr[1])
        _same_frag(merged, jfr[0].append(jfr[0]).append(jfr[1]))
        _same_frag(tfrag.Fragment.merge(tfr), jfrag.Fragment.merge(jfr))
        np.testing.assert_array_equal(tfr[1].centroid_cart(),
                                      jfr[1].centroid_cart())


def test_complete_molmotif_matches_jax():
    jc = _textbook("co2")
    tc = port(jc)
    jf = jfrag.complete_molmotif(jc, jfrag.Fragment(
        crystal=jc, at_idx=np.array([3]), lvec=np.zeros((1, 3), dtype=int)))
    tf = tfrag.complete_molmotif(tc, tfrag.Fragment(
        crystal=tc, at_idx=np.array([3]), lvec=np.zeros((1, 3), dtype=int)))
    assert tf.n == 3
    _same_frag(tf, jf)
    np.testing.assert_array_equal(tf.x_cart, jf.x_cart)
    np.testing.assert_array_equal(tf.z, jf.z)


@pytest.mark.parametrize("kw", [
    {"rsph": 7.3, "xsph": (0.0, 0.0, 0.0)},
    {"rcub": 6.1, "xcub": (0.0, 0.0, 0.0)},
    {"rsph": 5.0, "xsph": (0.25, 0.1, 0.3)}], ids=["sphere", "cube",
                                                  "sphere-off-origin"])
def test_listatoms_sphcub_matches_jax(kw):
    jc = JCrystal(m_x2c=np.diag([5.0] * 3),
                  x_frac=np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]),
                  species_of=np.array([0, 0]), species=[JSpecies("C", 6)])
    _same_frag(tfrag.listatoms_sphcub(port(jc), **kw),
               jfrag.listatoms_sphcub(jc, **kw))


@pytest.mark.parametrize("doborder", [False, True])
def test_listatoms_cells_matches_jax(doborder):
    jc = _textbook("rutile")
    a = tfrag.listatoms_cells(port(jc), (2, 1, 2), doborder=doborder)
    b = jfrag.listatoms_cells(jc, (2, 1, 2), doborder=doborder)
    _same_frag(a, b)


SKEWED = {
    "triclinic": m_x2c_from_cellpar([7.0, 7.5, 8.0], [88.0, 95.0, 91.0]),
    "sheared": np.array([[5.0, 3.0, 7.0], [0.0, 6.0, -4.0],
                         [0.0, 0.0, 7.5]]),
    "long_diagonal": np.array([[4.0, 4.0, 4.0], [0.0, 4.1, 8.1],
                               [0.0, 0.0, 4.2]]),
}


@pytest.mark.parametrize("name", sorted(SKEWED))
def test_niggli_reduce_matches_jax(name):
    m = SKEWED[name]
    tm, tT = ttrans.niggli_reduce(m)
    jm, jT = jtrans.niggli_reduce(m)
    np.testing.assert_array_equal(tT, jT)
    np.testing.assert_array_equal(tm, jm)
    assert abs(round(np.linalg.det(tT))) == 1


@pytest.mark.parametrize("name", ["nacl_conventional", "Si", "CsCl",
                                  "rutile"])
def test_primitive_cell_matches_jax(name):
    jc = _textbook(name)
    tc = port(jc)
    np.testing.assert_array_equal(ttrans.centering_translations(tc),
                                  jtrans.centering_translations(jc))
    assert_same_crystal(jtrans.primitive_cell(jc), ttrans.primitive_cell(tc))


def test_newcell_matches_jax():
    jc = _textbook("rutile")
    M = np.array([[1, 1, 0], [-1, 1, 0], [0, 0, 1]])
    assert_same_crystal(jtrans.newcell(jc, M, origin=(0.1, 0.0, 0.0)),
                        ttrans.newcell(port(jc), M, origin=(0.1, 0.0, 0.0)))
    with pytest.raises(ValueError, match="singular"):
        ttrans.newcell(port(jc), np.zeros((3, 3)))


@pytest.mark.parametrize("kw", [{"up2d": 6.0}, {"up2n": 5},
                                {"up2d": 4.0, "up2n": 30}],
                         ids=["up2d", "up2n", "both"])
def test_list_near_atoms_matches_jax(kw):
    jc = _textbook("rutile")
    tc = port(jc)
    x = np.array([[0.1, 0.2, 0.3], [0.5, 0.5, 0.0]])
    for pts in (x, x[0]):
        a, b = tc.list_near_atoms(pts, **kw), jc.list_near_atoms(pts, **kw)
        if pts.ndim == 1:
            a, b = [[v] for v in a], [[v] for v in b]
        for ta, ja in zip(a, b):
            for u, v in zip(ta, ja):
                np.testing.assert_array_equal(u, v)
    cart = tc.list_near_atoms(tc.x2c(x[0]), icrd=tparam.ICRD_CART,
                              up2d=6.0)
    for u, v in zip(cart, jc.list_near_atoms(jc.x2c(x[0]),
                                             icrd=jparam.ICRD_CART,
                                             up2d=6.0)):
        np.testing.assert_array_equal(u, v)
    with pytest.raises(ValueError):
        tc.list_near_atoms(x)


def test_param_and_cell_helpers_match_jax():
    for name in ("Fe1", "FE_2", "cl", "Xx", "O2-", "C"):
        assert tparam.symbol_to_z(name) == jparam.symbol_to_z(name)
    assert tparam.SYMBOL_TO_Z == jparam.SYMBOL_TO_Z
    assert (tparam.PI, tparam.ICRD_RCRYS) == (jparam.PI, jparam.ICRD_RCRYS)
    for z in (1, 8, 26, 118, 0, 200):
        assert tparam.atomic_mass(z) == jparam.atomic_mass(z)
    r0 = tparam.covalent_radius(6)
    try:
        tparam.set_covalent_radius(6, 1.75)
        assert tparam.covalent_radius(6) == 1.75
    finally:
        tparam._COVRAD_OVERRIDE.pop(6)
    assert tparam.covalent_radius(6) == r0 == jparam.covalent_radius(6)
    m = SKEWED["sheared"]
    np.testing.assert_array_equal(tmetric(m), jmetric(m))
    np.testing.assert_array_equal(trecip(m), jrecip(m))


def _water():
    return JSeed(x_frac=np.array([[0.0, 0.0, 0.22], [0.0, 1.43, -0.89],
                                  [0.0, -1.43, -0.89]]),
                 species_of=np.array([0, 1, 1]),
                 species=[JSpecies("O", 8), JSpecies("H", 1)],
                 ismolecule=True).to_crystal()


WRITE_NAMES = ["s.xyz", "POSCAR", "s.cif", "s.xsf", "s.in", "s.gjf",
               "s.cri", "s.abin", "s.elk.in", "s.gin", "s.lammps", "s.gen",
               "s.d12", "s.m", "s.db", "s.tess", "s.fdf", "s.STRUCT_IN",
               "s.hsd", "s.obj", "s.ply", "s.off"]
WRITE_CRYSTALS = {"rutile": lambda: _textbook("rutile"),
                  "triclinic": lambda: _textbook("triclinic"),
                  "water": _water}


@pytest.mark.parametrize("cname", sorted(WRITE_CRYSTALS))
@pytest.mark.parametrize("fname", WRITE_NAMES)
def test_writers_bytes_equal_jax(tmp_path, cname, fname):
    jc = WRITE_CRYSTALS[cname]()
    tc = port(jc)
    pj, pt = tmp_path / "j", tmp_path / "t"
    pj.mkdir()
    pt.mkdir()
    try:
        jwriters.write_structure(jc, str(pj / fname))
    except Exception as e:          # a format that refuses this crystal
        with pytest.raises(type(e)):
            twriters.write_structure(tc, str(pt / fname))
        return
    twriters.write_structure(tc, str(pt / fname))
    assert sorted(os.listdir(pt)) == sorted(os.listdir(pj))
    for f in os.listdir(pj):
        assert (pt / f).read_bytes() == (pj / f).read_bytes(), f


@pytest.mark.parametrize("fmt", ["xyz", "gjf", "cml"])
def test_write_mol_fragment_bytes_equal_jax(tmp_path, fmt):
    jc = _textbook("co2")
    jfr = jfrag.list_molecules(jc)[0][1]
    tfr = tfrag.list_molecules(port(jc))[0][1]
    pj, pt = tmp_path / f"j.{fmt}", tmp_path / f"t.{fmt}"
    jwriters.write_mol_fragment(jfr, str(pj))
    twriters.write_mol_fragment(tfr, str(pt))
    assert pt.read_bytes() == pj.read_bytes()


def test_write_structure_refuses_unknown_format(tmp_path):
    with pytest.raises(ValueError, match="cannot infer"):
        twriters.write_structure(port(_textbook("CsCl")),
                                 str(tmp_path / "x.unknown"))


def test_nciplot_molmotif_matches_jax(tmp_path):
    """nciplot(molmotif=True) on the CO2 crystal: the box cuts through
    the molecule that crosses the cell boundary; the _cell.xyz files hold
    the completed molecules and are equal as text, the cubes agree to
    1e-10 of their largest magnitude (float64)."""
    jc = _textbook("co2")
    js = JSystem.from_structure(jc)
    g = np.asarray(_rasterize_field(js.fields[0], (16, 18, 20)))
    js.load_field(JField.from_grid(jc, JGrid3(jnp.asarray(g))))
    ts = system_from_arrays(**crystal_to_arrays(jc), grid=g, device=CPU)
    kw = dict(nstep=(15, 13, 11), precision="f64", write_files=True,
              oname="m", molmotif=True)
    jres = jnci(js, outdir=str(tmp_path), **{**kw, "oname": "j"})
    tres = tnci(ts, outdir=str(tmp_path), **{**kw, "oname": "t"})
    for name in ("crho", "cgrad", "cgrad_raw"):
        ref = np.asarray(getattr(jres, name))
        got = getattr(tres, name).numpy()
        assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max(), name
    cells = [(tmp_path / f"{o}_cell.xyz").read_text() for o in "tj"]
    assert cells[0] == cells[1]
    plain = tnci(ts, outdir=str(tmp_path), **{**kw, "oname": "p",
                                              "molmotif": False})
    assert plain.files[-1].endswith("p_cell.xyz")
    nmol = int(cells[0].split()[0])
    nplain = int((tmp_path / "p_cell.xyz").read_text().split()[0])
    assert nmol > nplain


def test_fragment_from_xyz_matches_jax(tmp_path):
    """load_field_as("promolecular", fragment="x.xyz"): the fragment's
    atoms come from the xyz file's positions."""
    jc = _textbook("co2")
    js = JSystem.from_structure(jc)
    ts = System.from_structure(port(jc), device=CPU)
    frag = tmp_path / "frag.xyz"
    cart = np.asarray(jc.x_cart)[[0, 1, 2]] * jparam.BOHR_TO_ANGSTROM
    frag.write_text("3\nCO2\n" + "".join(
        f"{nm} {x:.10f} {y:.10f} {z:.10f}\n"
        for nm, (x, y, z) in zip(["C", "O", "O"], cart)))
    np.testing.assert_array_equal(ts.identify_fragment_from_xyz(str(frag)),
                                  js.identify_fragment_from_xyz(str(frag)))
    jid = js.load_field_as("promolecular", fragment=str(frag),
                           shape=(12, 12, 12))
    tid = ts.load_field_as("promolecular", fragment=str(frag),
                           shape=(12, 12, 12))
    np.testing.assert_allclose(ts.field(tid).grid.f.numpy(),
                               np.asarray(js.field(jid).grid.f),
                               rtol=1e-12, atol=1e-300)
    ts.set_reference(0)
    assert ts.ref.type == "promol"
    bad = tmp_path / "bad.xyz"
    bad.write_text("1\nfar\nC 1.234 5.678 9.1\n")
    with pytest.raises(ValueError, match="not in crystal"):
        ts.identify_fragment_from_xyz(str(bad))
