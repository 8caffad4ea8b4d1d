"""Grid readers of the torch port against the JAX package, on the CPU.

For each grid format a 12x10x8 grid (non-cubic, so a swapped axis shows)
is written; the JAX and the torch readers must give bitwise equal arrays,
and the torch tensor must be C-contiguous float64 on the asked device.
A VASP charge grid goes through Field.from_file as the reference loads it
(divided by the crystal's volume) and through Grid3.read_vasp with the
volume of its own header. The formats whose fields are not ported raise
NotImplementedError naming the module they wait for.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from critic2_tpu.crystal.cell import m_x2c_from_cellpar
from critic2_tpu.crystal.crystal import Crystal as JCrystal
from critic2_tpu.crystal.crystal import Species as JSpecies
from critic2_tpu.fields.field import Field as JField
from critic2_tpu.fields.grid3 import Grid3 as JGrid3
from critic2_tpu.fields.grid3 import detect_grid_format as jdetect
from critic2_tpu.io import writers as jwriters
from critic2_tpu.io.cube import write_cube
from critic2_tpu.system import System as JSystem
from critic2_tpu_torch import System
from critic2_tpu_torch.convert import crystal_from_arrays, crystal_to_arrays
from critic2_tpu_torch.fields.field import Field
from critic2_tpu_torch.fields.grid3 import Grid3
from critic2_tpu_torch.fields.grid3 import detect_grid_format as tdetect

import test_readers

# the inputs are tiny: one intra-op thread a process, so that parallel
# test workers do not fight over the cores
torch.set_num_threads(1)

SHAPE = (12, 10, 8)
CPU = "cpu"


def _crystal():
    return JCrystal(m_x2c=m_x2c_from_cellpar([7.0, 7.5, 8.0],
                                             [88.0, 95.0, 91.0]),
                    x_frac=np.array([[0.1, 0.2, 0.3], [0.6, 0.55, 0.7]]),
                    species_of=np.array([0, 1]),
                    species=[JSpecies("Na", 11), JSpecies("Cl", 17)])


def _grid():
    return np.random.default_rng(5).random(SHAPE) + 0.05


def _write_chgcar(path, crystal, grid):
    """POSCAR header, blank line, the dimensions, then grid x volume,
    five values a line, first index fastest (the VASP CHGCAR layout)."""
    jwriters.write_poscar(crystal, path)
    vals = (grid * crystal.volume).reshape(-1, order="F")
    with open(path, "a") as fh:
        fh.write("\n" + " ".join(str(n) for n in grid.shape) + "\n")
        for i in range(0, len(vals), 5):
            fh.write(" ".join("%18.11E" % v for v in vals[i:i + 5]) + "\n")
        fh.write("augmentation occupancies 1 12\n 0.1 0.2\n")


def _write_xsf(path, grid):
    """xsf general grid: n+1 points per axis, the last plane repeating
    the first, first index fastest."""
    n = [s + 1 for s in grid.shape]
    per = np.pad(grid, [(0, 1)] * 3, mode="wrap")
    with open(path, "w") as fh:
        fh.write("CRYSTAL\nBEGIN_BLOCK_DATAGRID_3D\ndensity\n"
                 "BEGIN_DATAGRID_3D_rho\n")
        fh.write(" ".join(map(str, n)) + "\n0 0 0\n7 0 0\n0 7 0\n0 0 7\n")
        vals = per.reshape(-1, order="F")
        for i in range(0, len(vals), 6):
            fh.write(" ".join(repr(float(v)) for v in vals[i:i + 6])
                     + "\n")
        fh.write("END_DATAGRID_3D\nEND_BLOCK_DATAGRID_3D\n")


def _write_qub(path, grid):
    with open(path, "w") as fh:
        fh.write(" ".join(map(str, grid.shape)) + "\n")
        for v in grid.reshape(-1, order="F"):
            fh.write(f"{float(v)!r}\n")


def _write_elk(path, grid):
    n = grid.shape
    with open(path, "w") as fh:
        fh.write(" ".join(map(str, n)) + "\n")
        for k in range(n[2]):
            for j in range(n[1]):
                for i in range(n[0]):
                    fh.write(f"{i / n[0]!r} {j / n[1]!r} {k / n[2]!r} "
                             f"{float(grid[i, j, k])!r}\n")


def _write_siesta(path, grid):
    n1, n2, n3 = grid.shape
    with open(path, "wb") as fh:
        def rec(raw):
            fh.write(np.int32(len(raw)).tobytes())
            fh.write(raw)
            fh.write(np.int32(len(raw)).tobytes())
        rec(np.eye(3).tobytes())
        rec(np.asarray([n1, n2, n3, 2], np.int32).tobytes())
        for spin in (0.75, 0.25):
            for iz in range(n3):
                for iy in range(n2):
                    rec((spin * grid[:, iy, iz]).astype(np.float32)
                        .tobytes())


def _write(fmt, d, crystal, grid):
    if fmt == "cube":
        p = os.path.join(d, "g.cube")
        write_cube(p, grid, np.zeros(3),
                   np.asarray(crystal.m_x2c) / np.array(SHAPE),
                   crystal.zatoms, np.asarray(crystal.x_cart))
    elif fmt == "bincube":
        p = os.path.join(d, "g.bincube")
        JGrid3(jnp.asarray(grid)).write_bincube(p, crystal=crystal)
    elif fmt == "vasp":
        p = os.path.join(d, "CHGCAR")
        _write_chgcar(p, crystal, grid)
    elif fmt == "xsf":
        p = os.path.join(d, "g.xsf")
        _write_xsf(p, grid)
    elif fmt == "qub":
        p = os.path.join(d, "g.qub")
        _write_qub(p, grid)
    elif fmt == "elk":
        p = os.path.join(d, "RHO3D.OUT")
        _write_elk(p, grid)
    elif fmt == "siesta":
        p = os.path.join(d, "g.RHO")
        _write_siesta(p, grid)
    else:
        p = os.path.join(d, "g_DEN")
        test_readers._write_abinit_den(
            p, np.asarray(crystal.m_x2c), crystal.x_frac,
            [11.0, 17.0], [1, 2], SHAPE, grid)
    return p


FORMATS = ["cube", "bincube", "vasp", "xsf", "qub", "elk", "siesta",
           "abinit"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    c, g = _crystal(), _grid()
    return {fmt: _write(fmt, str(tmp_path_factory.mktemp(fmt)), c, g)
            for fmt in FORMATS}


@pytest.mark.parametrize("fmt", FORMATS)
def test_grid_reader_bitwise_equals_jax(files, fmt):
    p = files[fmt]
    assert tdetect(p) == jdetect(p) == fmt
    jg = np.asarray(JGrid3.from_file(p).f)
    tg = Grid3.from_file(p, device=CPU).f
    assert tg.is_contiguous() and tg.dtype == torch.float64
    assert tg.device.type == "cpu" and tuple(tg.shape) == SHAPE
    np.testing.assert_array_equal(tg.numpy(), jg)
    # the written grid comes back: exactly, or to the file's precision
    # (cube: 15 significant digits; CHGCAR: 12; siesta: float32)
    rtol = {"cube": 1e-13, "vasp": 1e-10, "siesta": 1e-7}.get(fmt, 0.0)
    np.testing.assert_allclose(tg.numpy(), _grid(), rtol=rtol, atol=0)


@pytest.mark.parametrize("fmt", FORMATS)
def test_field_from_file_matches_jax(files, fmt):
    """Field.from_file as System.load_field calls it: a VASP grid is
    divided by the crystal's volume, not by its header's."""
    jc = _crystal()
    tc = crystal_from_arrays(**crystal_to_arrays(jc))
    jf = JField.from_file(jc, files[fmt])
    tf = Field.from_file(tc, files[fmt], device=CPU)
    assert tf.type == "grid" and tf.name == files[fmt]
    assert tf.grid.f.is_contiguous()
    np.testing.assert_array_equal(tf.grid.f.numpy(), np.asarray(jf.grid.f))


def test_read_vasp_with_and_without_omega(files):
    p = files["vasp"]
    for omega in (None, 123.25):
        np.testing.assert_array_equal(
            Grid3.read_vasp(p, omega=omega, device=CPU).f.numpy(),
            np.asarray(JGrid3.read_vasp(p, omega=omega).f))
    assert Grid3.from_file(p, "vasp", 123.25, device=CPU).f.is_contiguous()


def test_truncated_vasp_grid_raises(tmp_path):
    c = _crystal()
    p = str(tmp_path / "CHGCAR")
    _write_chgcar(p, c, _grid())
    with open(p) as fh:
        lines = fh.read().splitlines()
    with open(p, "w") as fh:
        fh.write("\n".join(lines[:-30]) + "\n")
    with pytest.raises(ValueError, match="numbers"):
        Grid3.read_vasp(p, omega=c.volume, device=CPU)
    # a word among the values: refused, not read as the numbers before it
    lines[12] = lines[12][:5] + " x" + lines[12][7:]
    with open(p, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    with pytest.raises(ValueError, match="numbers"):
        Grid3.read_vasp(p, omega=c.volume, device=CPU)


def test_system_load_field_matches_jax(files):
    """The quick start's first two lines on a CHGCAR beside its POSCAR
    header: the same crystal and the same reference grid."""
    p = files["vasp"]
    js = JSystem.from_structure(p)
    js.load_field(p)
    ts = System.from_structure(p, device=CPU)
    assert ts.load_field(p) == 1 and ts.iref == 1
    np.testing.assert_array_equal(ts.ref.grid.f.numpy(),
                                  np.asarray(js.ref.grid.f))
    np.testing.assert_allclose(ts.crystal.m_x2c, js.crystal.m_x2c,
                               rtol=0, atol=1e-12)
    ts.unload_field(1)
    assert ts.iref is None and list(ts.fields) == [0]


def test_write_bincube_bytes_equal_jax(tmp_path):
    jc = _crystal()
    tc = crystal_from_arrays(**crystal_to_arrays(jc))
    g = _grid()
    pj, pt = str(tmp_path / "j.bincube"), str(tmp_path / "t.bincube")
    JGrid3(jnp.asarray(g)).write_bincube(pj, crystal=jc)
    Grid3(torch.as_tensor(g)).write_bincube(pt, crystal=tc)
    with open(pj, "rb") as a, open(pt, "rb") as b:
        assert a.read() == b.read()
    back = Grid3.read_bincube(pt, device=CPU).f
    assert torch.equal(back, torch.as_tensor(g)) and back.is_contiguous()
    # a read-back tensor owns its memory: writing to it is allowed
    back += 1.0


@pytest.mark.parametrize("name", [
    "a.cube", "a.bincube", "CHGCAR", "CHG", "ELFCAR", "AECCAR0", "a.vasp",
    "a.xsf", "a.axsf", "a.qub", "a.pwc", "o_DEN", "o_VHXC", "a.RHO",
    "a.VT", "RHO3D.OUT", "ELF3D.OUT"])
def test_detect_grid_format_matches_jax(name):
    assert tdetect(name) == jdetect(name)


def test_unported_fields_name_their_module(tmp_path):
    """The formats that once waited for their module (fields/qe.py,
    elk.py, dftb.py, wien.py) are dispatched to it by file name: each
    file of the JAX package's own test writers loads into its type."""
    import test_deloc
    import test_dftb
    import test_elk
    import test_wien

    c = crystal_from_arrays(**crystal_to_arrays(_crystal()))
    test_deloc.write_pwc(str(tmp_path / "x.pwc"), np.eye(3) * 6.0,
                         (2, 1, 1), 2, (8, 8, 8))
    test_elk._write_geometry(tmp_path / "GEOMETRY.OUT")
    test_elk._write_state(tmp_path / "STATE.OUT")
    test_wien._write_struct(tmp_path / "x.struct")
    test_wien._write_clmsum(tmp_path / "x.clmsum")
    test_dftb.write_hsd(tmp_path / "wfc.hsd")
    test_dftb.write_xml(tmp_path / "detailed.xml", [(np.zeros(3), 1.0)],
                        np.full((1, 1, 1), 2.0), True)
    test_dftb.write_bin(tmp_path / "eigenvec.bin", [np.array([1.0])], True)
    h = crystal_from_arrays(np.eye(3) * 4.0, [[0.0, 0.0, 0.0]], [0],
                            [("H", 1)])
    for name, typ, crys, kw in (
            ("x.pwc", "grid", c, {}), ("STATE.OUT", "elk", c, {}),
            ("detailed.xml", "dftb", h,
             {"file3": str(tmp_path / "wfc.hsd")}),
            ("x.clmsum", "wien", c, {})):
        f = Field.from_file(crys, str(tmp_path / name), device=CPU, **kw)
        assert f.type == typ and f.device.type == "cpu"
        assert torch.isfinite(f.grd(np.array([[0.3, 0.2, 0.1]])).f).all()
    g = Grid3.read_pwc(str(tmp_path / "x.pwc"), device=CPU)
    assert g.qe is not None and g.n == (8, 8, 8)
