"""Structure readers of the torch port against the JAX package, on the CPU.

Every text that the JAX package's reader tests write (test_readers.py,
test_struct.py, test_spgs_sympg.py, test_fragment.py), the output of its
writers, the wavefunction files and every entry of both structure
libraries go through `critic2_tpu.crystal.seed.read_structure` and the
port's; the two crystals must be equal array by array: cell and
fractional positions within 1e-12 (both parse the same text with the same
arithmetic, so in practice they are equal), species, species_of and the
molecule flags exactly.
"""
import os

import numpy as np
import pytest
import torch

from critic2_tpu.crystal import library as jlib
from critic2_tpu.crystal import seed as jseed
from critic2_tpu.crystal.crystal import Crystal as JCrystal
from critic2_tpu.crystal.crystal import Species as JSpecies
from critic2_tpu.fields.grid3 import Grid3 as JGrid3
from critic2_tpu.fields.qe import FortranFile
from critic2_tpu.io import cif as jcif
from critic2_tpu.io import writers as jwriters
from critic2_tpu.io.cube import write_cube
from critic2_tpu.system import System as JSystem
from critic2_tpu_torch import System
from critic2_tpu_torch.convert import crystal_to_arrays
from critic2_tpu_torch.crystal import library as tlib
from critic2_tpu_torch.crystal import seed as tseed
from critic2_tpu_torch.io import cif as tcif

import test_elk
import test_fragment
import test_readers
import test_struct
import test_torch_wfn
import test_wien

# the inputs are tiny: one intra-op thread a process, so that parallel
# test workers do not fight over the cores
torch.set_num_threads(1)

TOL = 1e-12          # cell (bohr) and fractional positions


def assert_same_crystal(jc, tc, tol=TOL):
    ja, ta = crystal_to_arrays(jc), crystal_to_arrays(tc)
    assert ta["species"] == ja["species"]
    np.testing.assert_array_equal(ta["species_of"], ja["species_of"])
    assert ta["ismolecule"] == ja["ismolecule"]
    for k in ("m_x2c", "x_frac", "molborder"):
        assert ta[k].shape == ja[k].shape, k
        np.testing.assert_allclose(ta[k], ja[k], rtol=0, atol=tol,
                                   err_msg=k)
    assert (ta["molx0"] is None) == (ja["molx0"] is None)
    if ja["molx0"] is not None:
        np.testing.assert_allclose(ta["molx0"], ja["molx0"], rtol=0,
                                   atol=tol)


# ---------------------------------------------------------------------------
# files: name -> writer(directory) -> path
# ---------------------------------------------------------------------------
def _text(name, text):
    def write(d):
        p = os.path.join(d, name)
        with open(p, "w") as fh:
            fh.write(text)
        return p
    return write


QE_IN_IBRAV2 = """&system
 ibrav=2, celldm(1)=10.2, nat=2, ntyp=1
/
ATOMIC_POSITIONS crystal
 Si 0.0 0.0 0.0
 Si 0.25 0.25 0.25
"""

VASP4_POTCAR = ("PAW_PBE Na 08Apr2002\n"
                "junk line\n"
                "End of Dataset\n"
                "PAW_PBE Cl 06Sep2000\n"
                "End of Dataset\n")
VASP4_POSCAR = ("NaCl v4\n"
                "5.64\n"
                "1.0 0.0 0.0\n"
                "0.0 1.0 0.0\n"
                "0.0 0.0 1.0\n"
                "4 4\n"
                "Direct\n"
                "0.0 0.0 0.0\n0.5 0.5 0.0\n0.5 0.0 0.5\n0.0 0.5 0.5\n"
                "0.5 0.5 0.5\n0.0 0.0 0.5\n0.0 0.5 0.0\n0.5 0.0 0.0\n")

CIF_SYMOPS = """data_nacl
_cell_length_a 5.6402
_cell_length_b 5.6402
_cell_length_c 5.6402
_cell_angle_alpha 90
_cell_angle_beta 90
_cell_angle_gamma 90
loop_
_symmetry_equiv_pos_as_xyz
'x,y,z'
'x,y+1/2,z+1/2'
'x+1/2,y,z+1/2'
'x+1/2,y+1/2,z'
loop_
_atom_site_label
_atom_site_fract_x
_atom_site_fract_y
_atom_site_fract_z
Na1 0.0 0.0 0.0
Cl1 0.5 0.5 0.5
"""

CIF_MESSY = """data_publication
_journal_name 'Acta Mess.'
_publ_author_name
;
 A. Author
;
data_NaCl
_cell_length_a 5.6402(12)
_cell_length_b 5.6402(12)
_cell_length_c 5.6402(12)
_cell_angle_alpha 90
_cell_angle_beta 90.0
_cell_angle_gamma 90
_symmetry_space_group_name_H-M 'F m -3 m'
_chemical_formula_sum ?
loop_
_atom_site_label
_atom_site_type_symbol
_atom_site_fract_x
_atom_site_fract_y
_atom_site_fract_z
_atom_site_occupancy
Na1 ? 0.0 0.0 0.0 1.0
Cl1 Cl 0.5 0.5 0.5 1.0
X9 ? ? ? ? 0.0
"""

CIF_MMCIF = """data_block1
_struct.title
;
 notes: this text mentions
data_fake and loop_ markers
;
_cell.length_a 4.0
_cell.length_b 4.0
_cell.length_c 4.0
_cell.angle_alpha 90
_cell.angle_beta 90
_cell.angle_gamma 90
loop_
_atom_site.label
_atom_site.type_symbol
_atom_site.fract_x
_atom_site.fract_y
_atom_site.fract_z
PO1 O2- 0.0 0.0 0.0
"""

CIF_ITA = """data_x
_cell_length_a 5.0
_cell_length_b 5.0
_cell_length_c 5.0
_cell_angle_alpha 90
_cell_angle_beta 90
_cell_angle_gamma 90
_space_group_IT_number 229
loop_
_atom_site_label
_atom_site_fract_x
_atom_site_fract_y
_atom_site_fract_z
Fe1 0.0 0.0 0.0
"""

CIF_CLEAN = """data_NaCl
_cell_length_a 5.6402(12)
_cell_length_b 5.6402
_cell_length_c 5.6402
_cell_angle_alpha 90
_cell_angle_beta 90
_cell_angle_gamma 90
_symmetry_space_group_name_H-M 'F m -3 m'
loop_
_atom_site_label
_atom_site_fract_x
_atom_site_fract_y
_atom_site_fract_z
Na 0 0 0
Cl 0.5 0.5 0.5
"""

CIF_BAD = """data_bad
_cell_length_a abc
_my_private_tag 1.0
loop_
_atom_site_label
_atom_site_fract_x
Na xyz
"""


def _vasp4(d):
    with open(os.path.join(d, "POTCAR"), "w") as fh:
        fh.write(VASP4_POTCAR)
    return _text("POSCAR", VASP4_POSCAR)(d)


def _abinit(d):
    p = os.path.join(d, "nacl_DEN")
    test_readers._write_abinit_den(
        p, np.diag([10.0, 11.0, 12.0]), [[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]],
        [11.0, 17.0], [1, 2], (6, 8, 10),
        np.random.default_rng(0).random((6, 8, 10)))
    return p


def _triclinic():
    from critic2_tpu.crystal.cell import m_x2c_from_cellpar

    return JCrystal(m_x2c=m_x2c_from_cellpar([10.0, 11.0, 12.0],
                                             [90.0, 80.0, 95.0]),
                    x_frac=np.array([[0.0, 0.0, 0.0], [0.4, 0.5, 0.6]]),
                    species_of=np.array([0, 1]),
                    species=[JSpecies("Na", 11), JSpecies("Cl", 17)])


def _bincube(d):
    import jax.numpy as jnp

    p = os.path.join(d, "t.bincube")
    JGrid3(jnp.asarray(np.arange(24.0).reshape(2, 3, 4))).write_bincube(
        p, crystal=_triclinic())
    return p


def _cube(d):
    c = _triclinic()
    p = os.path.join(d, "t.cube")
    write_cube(p, np.random.default_rng(1).random((4, 5, 6)), np.zeros(3),
               np.asarray(c.m_x2c) / np.array([4, 5, 6]), c.zatoms,
               np.asarray(c.x_cart))
    return p


def _pwc(d):
    at = np.array([[10.0, 0, 0], [0, 12.0, 0], [0, 0, 14.0]]).T
    tau = np.array([[0.0, 0.0, 0.0], [5.0, 6.0, 7.0]]).T
    p = os.path.join(d, "t.pwc")
    with FortranFile(p, "wb") as fh:
        fh.write_record(np.int32(2))
        fh.write_record(np.int32([2, 2]))
        fh.write_record(np.frombuffer(b"Na Cl ", dtype="S1"))
        fh.write_record(np.int32([1, 2]))
        fh.write_record(np.asarray(tau, order="F").tobytes(order="F"))
        fh.write_record(np.asarray(at, order="F").tobytes(order="F"))
    return p


def _written(name, crystal):
    def write(d):
        p = os.path.join(d, name)
        jwriters.write_structure(crystal(), p)
        return p
    return write


def _small_nacl():
    return JCrystal(m_x2c=np.diag([6.0, 7.0, 8.0]),
                    x_frac=np.array([[0, 0, 0], [0.5, 0.5, 0.5]],
                                    dtype=float),
                    species_of=np.array([0, 1]),
                    species=[JSpecies("Na", 11), JSpecies("Cl", 17)])


def _water():
    return jseed.CrystalSeed(
        x_frac=np.array([[0.0, 0.0, 0.22], [0.0, 1.43, -0.89],
                         [0.0, -1.43, -0.89]]),
        species_of=np.array([0, 1, 1]),
        species=[JSpecies("O", 8), JSpecies("H", 1)],
        ismolecule=True).to_crystal()


def _wien(d):
    p = os.path.join(d, "x.struct")
    test_wien._write_struct(p)
    return p


def _elk(d):
    p = os.path.join(d, "GEOMETRY.OUT")
    test_elk._write_geometry(p)
    return p


def _wfn(ext):
    return _text(f"h2.{ext}", test_torch_wfn.TEXTS[ext]())


FILES = {
    "shelx": _text("nacl.res", test_readers.SHELX_NACL),
    "qe_in": _text("nacl.in", test_readers.QE_IN),
    "qe_in_ibrav2": _text("si.in", QE_IN_IBRAV2),
    "qe_out": _text("nacl.out", test_readers.QE_OUT),
    "dftb_gen": _text("nacl.gen", test_readers.DFTB_GEN),
    "abinit_den": _abinit,
    "bincube": _bincube,
    "cube": _cube,
    "pwc": _pwc,
    "siesta_struct_out": _text("t.STRUCT_OUT", test_readers.SIESTA_STRUCT),
    "axsf": _text("t.axsf", test_readers.AXSF),
    "crystal_out": _text("nacl.out", test_readers.CRYSTAL_OUT),
    "gaussian_log": _text("h2o.log", test_readers.GAUSSIAN_LOG),
    "vasp4_potcar": _vasp4,
    "cif_symops": _text("nacl.cif", CIF_SYMOPS),
    "cif_messy": _text("messy.cif", CIF_MESSY),
    "cif_mmcif": _text("mm.cif", CIF_MMCIF),
    "cif_ita": _text("im3m.cif", CIF_ITA),
    "cif_clean": _text("clean.cif", CIF_CLEAN),
    "wien_struct": _wien,
    "elk_geometry": _elk,
    "poscar_written": _written("out.vasp", test_struct._nacl),
    "contcar_written": _written("CONTCAR", _small_nacl),
    "cif_written": _written("out.cif", test_struct._nacl),
    "xyz_written": _written("out.xyz", test_struct._nacl),
    "xyz_molecule": _written("water.xyz", _water),
    "xsf_written": _written("out.xsf", _triclinic),
    "qe_in_written": _written("out.in", _triclinic),
    "gen_written": _written("s.gen", _small_nacl),
    "struct_in_written": _written("s.STRUCT_IN", _small_nacl),
    "co2_poscar": _written("co2.vasp", test_fragment._co2_crystal),
    "wfn": _wfn("wfn"),
    "wfx": _wfn("wfx"),
    "fchk": _wfn("fchk"),
    "molden": _wfn("molden"),
}


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    out = {}
    for name, write in FILES.items():
        d = str(tmp_path_factory.mktemp(name))
        out[name] = write(d)
    return out


@pytest.mark.parametrize("name", sorted(FILES))
def test_read_structure_matches_jax(paths, name):
    p = paths[name]
    assert tseed.detect_format(p) == jseed.detect_format(p)
    assert_same_crystal(jseed.read_structure(p), tseed.read_structure(p))


@pytest.mark.parametrize("name", ["poscar_written", "cif_messy", "molden",
                                  "xyz_molecule", "wien_struct"])
def test_system_from_structure_matches_jax(paths, name):
    """System.from_structure(path) builds the JAX package's crystal, with
    the promolecular density as field 0 on the asked device."""
    p = paths[name]
    js, ts = JSystem.from_structure(p), System.from_structure(p,
                                                              device="cpu")
    assert_same_crystal(js.crystal, ts.crystal)
    assert ts.device.type == "cpu" and ts.fields[0].type == "promol"
    pts = np.asarray(js.crystal.x_cart)[:1] + 0.3
    np.testing.assert_allclose(ts.fields[0].grd(pts).f.numpy(),
                               np.asarray(js.fields[0].grd(pts).f),
                               rtol=1e-12)


def test_from_structure_passes_keywords(paths):
    """kw goes to the reader: border= to the wavefunction formats, mol=
    to read_structure (which, as the JAX package's, ignores it)."""
    p = paths["molden"]
    ts = System.from_structure(p, device="cpu", border=6.0)
    jc = jseed.read_wfn_structure(p, border=6.0).to_crystal()
    assert_same_crystal(jc, ts.crystal)
    ts2 = System.from_structure(paths["shelx"], device="cpu", mol=False)
    assert_same_crystal(jseed.read_structure(paths["shelx"]), ts2.crystal)


def test_cif_block_and_axsf_step(paths):
    assert_same_crystal(
        jcif.read_cif(paths["cif_messy"], block="NaCl").to_crystal(),
        tcif.read_cif(paths["cif_messy"], block="NaCl").to_crystal())
    with pytest.raises(ValueError):
        tcif.read_cif(paths["cif_messy"], block="absent")
    assert_same_crystal(
        jseed.read_axsf_structure(paths["axsf"], step=2).to_crystal(),
        tseed.read_axsf_structure(paths["axsf"], step=2).to_crystal())


@pytest.mark.parametrize("name", ["cif_clean", "cif_messy", "cif_bad"])
def test_validate_cif_matches_jax(tmp_path, name):
    text = {"cif_clean": CIF_CLEAN, "cif_messy": CIF_MESSY,
            "cif_bad": CIF_BAD}[name]
    p = tmp_path / "x.cif"
    p.write_text(text)
    got = tcif.validate_cif(str(p))
    assert got == jcif.validate_cif(str(p))
    assert len(got) == {"cif_clean": 0, "cif_bad": 3}.get(name, len(got))


def test_potcar_and_vasp4(paths):
    d = os.path.dirname(paths["vasp4_potcar"])
    pot = os.path.join(d, "POTCAR")
    assert tseed.read_potcar(pot) == jseed.read_potcar(pot) == ["Na", "Cl"]
    seed = tseed.read_poscar(paths["vasp4_potcar"])
    assert [s.name for s in seed.species] == ["Na", "Cl"]


@pytest.mark.parametrize("name", [
    "POSCAR", "CONTCAR", "x.poscar", "CHGCAR", "CHG", "ELFCAR", "a.cube",
    "a.bincube", "a.xyz", "a.cif", "a.vasp", "a.xsf", "a.axsf",
    "a.STRUCT_OUT", "a.struct_in", "a.log", "a.wfn", "a.wfx", "a.fchk",
    "a.molden", "GEOMETRY.OUT", "a.in", "a.scf", "a.struct", "a.gen",
    "a.res", "a.ins", "a.16", "a.pwc", "o_DEN", "o_POT", "o_GDEN1",
    "a.DEN.nc"])
def test_detect_format_matches_jax(name):
    assert tseed.detect_format(name) == jseed.detect_format(name)


def test_detect_format_refuses_what_jax_refuses():
    for name in ("a.unknownext", "README"):
        with pytest.raises(ValueError):
            jseed.detect_format(name)
        with pytest.raises(ValueError):
            tseed.detect_format(name)


@pytest.mark.parametrize("ibrav", [1, 2, 3, 4, 5, -5, 6, 7, 8, 9, 10, 11,
                                   12, -12, 13, 14])
def test_qe_ibrav_cell_matches_jax(ibrav):
    cd = {1: 10.0, 2: 1.2, 3: 1.5, 4: 0.3, 5: 0.4, 6: 0.2}
    np.testing.assert_array_equal(tseed._qe_ibrav_cell(ibrav, cd),
                                  jseed._qe_ibrav_cell(ibrav, cd))


INLINE = {
    "spg_fm3m": (""" cell 10.658 10.658 10.658 90 90 90
 spg f m -3 m
 neq 0. 0. 0. na
 neq 0.5 0.5 0.5 cl
endcrystal""", False),
    "symm": (""" cell 8 8 8 90 90 90
 symm -x,-y,z
 symm -x,y,-z
 C 0.1 0.2 0.3
end""", False),
    "cartesian": (""" cartesian
 bohr
 8 0 0
 0 8 0
 0 0 8
 endcartesian
 He 4.0 4.0 4.0 bohr
endcrystal""", False),
    "molecule": (""" O 0.0 0.0 0.1173
 H 0.0 0.7572 -0.4692
 H 0.0 -0.7572 -0.4692
endmolecule""", True),
    "molecule_cubic_border": (""" cubic
 border 4.5
 C 0 0 0
 O 0 0 1.128 ang
endmolecule""", True),
}


@pytest.mark.parametrize("name", sorted(INLINE))
def test_inline_environment_matches_jax(name):
    text, mol = INLINE[name]
    js = jseed.parse_crystal_env(iter(text.splitlines()), mol=mol)
    ts = tseed.parse_crystal_env(iter(text.splitlines()), mol=mol)
    assert (ts.ismolecule, ts.cubic, ts.border) == \
        (js.ismolecule, js.cubic, js.border)
    assert_same_crystal(js.to_crystal(), ts.to_crystal())


def _library(mol):
    return [(mol, e[0]) for e in jlib.library_entries(mol=mol)]


LIBRARY = _library(False) + _library(True)


def test_library_entry_lists_match_jax():
    for mol in (False, True):
        assert tlib.library_entries(mol=mol) == \
            jlib.library_entries(mol=mol)
    assert len(LIBRARY) == 44 + 222


@pytest.mark.parametrize("mol, name", LIBRARY,
                         ids=[("mol-" if m else "crys-") + n
                              for m, n in LIBRARY])
def test_library_entry_matches_jax(mol, name):
    try:
        js = jlib.load_library_entry(name, mol=mol)
    except (ValueError, KeyError) as e:
        with pytest.raises(type(e)):
            tlib.load_library_entry(name, mol=mol)
        return
    ts = tlib.load_library_entry(name, mol=mol)
    assert ts.name == js.name and ts.ismolecule == js.ismolecule
    assert_same_crystal(js.to_crystal(), ts.to_crystal())


def test_unknown_library_entry_raises():
    with pytest.raises(ValueError, match="not found"):
        tlib.load_library_entry("no-such-structure")
