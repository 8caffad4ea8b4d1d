"""The README quick start on the torch port against the JAX package, on
the CPU at 32^3.

Each package writes a POSCAR with its own writer and a CHGCAR beside it,
then runs, with only the imports changed,

    s = System.from_structure("POSCAR")
    s.load_field("CHGCAR")
    cpl = autocp(s); makegraph(s, cpl)
    res = intgrid(s, method="yt")

The files are equal byte for byte and so are the grids read from them.
The CP lists must agree in counts, types, multiplicities and names, with
positions within 1e-9 bohr of the JAX package's (up to a symmetry image:
which image stands for an orbit hangs on which seed arrives first), the
bond paths must join the same nuclei, and the basin charges and volumes
must agree within 1e-9 e and 1e-9 bohr^3. The field is a smooth model
density with the atoms at cell centres of the grid, so no CP hangs on
which side of a node plane rounding puts it.
"""
import numpy as np
import pytest
import torch

from critic2_tpu.analysis.autocp import autocp as jautocp
from critic2_tpu.analysis.autocp import makegraph as jmakegraph
from critic2_tpu.analysis.integration import intgrid as jintgrid
from critic2_tpu.crystal.cell import m_x2c_from_cellpar
from critic2_tpu.crystal.crystal import Crystal as JCrystal
from critic2_tpu.crystal.crystal import Species as JSpecies
from critic2_tpu.io.writers import write_poscar as jwrite_poscar
from critic2_tpu.system import System as JSystem
from critic2_tpu_torch import System
from critic2_tpu_torch.analysis.autocp import autocp, makegraph
from critic2_tpu_torch.analysis.integration import intgrid
from critic2_tpu_torch.convert import (cplist_to_arrays, crystal_from_arrays,
                                       crystal_to_arrays)
from critic2_tpu_torch.io.writers import write_poscar

# the inputs are tiny: one intra-op thread a process, so that parallel
# test workers do not fight over the cores
torch.set_num_threads(1)

N = 32
TOL_POS = 1e-9       # bohr
TOL_Q = 1e-9         # e (and bohr^3 for the volumes)


def _crystal():
    """CsCl-type cell, atoms at cell centres of the 32^3 grid."""
    return JCrystal(m_x2c=m_x2c_from_cellpar([7.0] * 3, [90] * 3),
                    x_frac=np.array([[2.5 / N] * 3, [2.5 / N + 0.5] * 3]),
                    species_of=np.array([0, 1]),
                    species=[JSpecies("Na", 11), JSpecies("Cl", 17)])


def _density(c):
    x = np.stack(np.meshgrid(*[np.arange(N) / N] * 3, indexing="ij"), -1)
    g = np.zeros((N, N, N))
    for site, amp in zip(c.x_frac, (1.0, 1.6)):
        d = x - site
        d -= np.rint(d)
        g += amp * np.exp(-((d @ c.m_x2c.T) ** 2).sum(-1) / 1.5 ** 2)
    return g


def _write_chgcar(path, poscar_text, grid, volume):
    vals = (grid * volume).reshape(-1, order="F")
    with open(path, "w") as fh:
        fh.write(poscar_text + "\n" + " ".join(map(str, grid.shape)) + "\n")
        for i in range(0, len(vals), 5):
            fh.write(" ".join("%18.11E" % v for v in vals[i:i + 5]) + "\n")


def _quickstart(System, autocp, makegraph, intgrid, d, **kw):
    s = System.from_structure(str(d / "POSCAR"), **kw)
    s.load_field(str(d / "CHGCAR"))
    cpl = autocp(s)
    makegraph(s, cpl)
    res = intgrid(s, method="yt")
    return s, cpl, res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jc = _crystal()
    tc = crystal_from_arrays(**crystal_to_arrays(jc))
    g = _density(jc)
    out = {}
    for tag, c, writer in (("jax", jc, jwrite_poscar),
                           ("torch", tc, write_poscar)):
        d = tmp_path_factory.mktemp(tag)
        writer(c, str(d / "POSCAR"))
        _write_chgcar(d / "CHGCAR", (d / "POSCAR").read_text(), g, c.volume)
        out[tag + "_dir"] = d
    out["jax"] = _quickstart(JSystem, jautocp, jmakegraph, jintgrid,
                             out["jax_dir"])
    out["torch"] = _quickstart(System, autocp, makegraph, intgrid,
                               out["torch_dir"], device="cpu")
    return out


def test_files_and_grids_equal(runs):
    for f in ("POSCAR", "CHGCAR"):
        assert (runs["torch_dir"] / f).read_bytes() == \
            (runs["jax_dir"] / f).read_bytes()
    js, ts = runs["jax"][0], runs["torch"][0]
    ja, ta = crystal_to_arrays(js.crystal), crystal_to_arrays(ts.crystal)
    assert ta["species"] == ja["species"] == [("Na", 11), ("Cl", 17)]
    np.testing.assert_array_equal(ta["species_of"], ja["species_of"])
    np.testing.assert_array_equal(ta["x_frac"], ja["x_frac"])
    np.testing.assert_array_equal(ta["m_x2c"], ja["m_x2c"])
    assert ts.iref == js.iref == 1 and ts.ref.type == "grid"
    f = ts.ref.grid.f
    assert f.is_contiguous() and tuple(f.shape) == (N, N, N)
    np.testing.assert_array_equal(f.numpy(), np.asarray(js.ref.grid.f))
    # the grid read back is the density written, to the file's 12 digits
    g = _density(_crystal())
    assert np.abs(f.numpy() - g).max() <= 1e-10 * g.max()


def test_critical_points_match_jax(runs):
    js, jcpl, _ = runs["jax"]
    ts, tcpl, _ = runs["torch"]
    assert tcpl.counts() == jcpl.counts()
    assert tcpl.poincare_hopf() == jcpl.poincare_hopf() == 0
    ja, ta = cplist_to_arrays(jcpl), cplist_to_arrays(tcpl)
    for key in ("typ", "mult", "isnuc", "name"):
        np.testing.assert_array_equal(ta[key], ja[key])
    sg = ts.crystal.spacegroup
    for xt, xj in zip(ta["x"], ja["x"]):
        imgs = (sg.rotations @ xj + sg.translations) % 1.0
        assert ts.crystal.distmat(xt, imgs).min() <= TOL_POS
    np.testing.assert_allclose(ta["f"], ja["f"], rtol=1e-9, atol=1e-12)
    assert (ta["gfmod"] < 1e-10).all()


def test_bond_paths_match_jax(runs):
    """Every bond point's two paths end at nuclei, the same ones as in
    the JAX package's graph (compared as pairs of atom names: the
    take-off direction of each path is defined up to its sign)."""
    jcpl, tcpl = runs["jax"][1], runs["torch"][1]
    bonds = 0
    for jcp, tcp in zip(jcpl.cps, tcpl.cps):
        if tcp.typ != -1:
            continue
        bonds += 1
        assert min(tcp.ipath) >= 0
        assert all(tcpl.cps[i].isnuc for i in tcp.ipath)
        assert sorted(tcpl.cps[i].name for i in tcp.ipath) == \
            sorted(jcpl.cps[i].name for i in jcp.ipath)
        np.testing.assert_allclose(sorted(tcp.brpathlen),
                                   sorted(jcp.brpathlen), rtol=1e-6)
    assert bonds > 0


def test_basin_charges_match_jax(runs):
    jres, tres = runs["jax"][2], runs["torch"][2]
    assert [r.name for r in tres.rows] == [r.name for r in jres.rows]
    assert [r.atom for r in tres.rows] == [r.atom for r in jres.rows]
    np.testing.assert_allclose(tres.charges, jres.charges, rtol=0,
                               atol=TOL_Q)
    np.testing.assert_allclose(tres.volumes, jres.volumes, rtol=0,
                               atol=TOL_Q)
    ts = runs["torch"][0]
    dv = ts.crystal.volume / N ** 3
    assert abs(tres.charges.sum()
               - float(ts.ref.grid.f.sum()) * dv) <= 1e-9
    assert tres.table().count("\n") == jres.table().count("\n")


def _chip_smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_vectorised_chgcar_writer(tmp_path):
    """chip_smoke.py writes its 256^3 CHGCAR with a vectorised '%18.11E':
    every value reads back within 6e-12 relative of printf's (one unit in
    the last digit at most), zeros and signs included, and both packages
    read the file it writes as the same grid."""
    cs = _chip_smoke()
    rng = np.random.default_rng(3)
    v = rng.random(20000) * 10.0 ** rng.integers(-40, 40, 20000)
    v = np.concatenate([v, -v[:50], [0.0, 1.0, 9.999999999995, 1e-99,
                                     9.99999999999999e98, 0.5]])
    ours = cs.format_e18_11(v).tobytes().decode()
    printf = "".join("%18.11E" % x for x in v)
    assert len(ours) == len(printf) == 18 * len(v)
    a = np.array([float(ours[i:i + 18]) for i in range(0, len(ours), 18)])
    b = np.array([float(printf[i:i + 18]) for i in range(0, len(ours), 18)])
    np.testing.assert_allclose(a, b, rtol=6e-12, atol=0)
    np.testing.assert_allclose(a, v, rtol=6e-12, atol=0)
    assert sum(x != y for x, y in zip(ours, printf)) < len(v) // 100

    c = _crystal()
    g = _density(c)[:, :7, :5]
    write_poscar(crystal_from_arrays(**crystal_to_arrays(c)),
                 str(tmp_path / "POSCAR"))
    (tmp_path / "CHGCAR").write_bytes(cs.chgcar_bytes(
        (tmp_path / "POSCAR").read_text(), g, c.volume))
    from critic2_tpu.fields.grid3 import Grid3 as JGrid3
    from critic2_tpu_torch.fields.grid3 import Grid3

    p = str(tmp_path / "CHGCAR")
    tg = Grid3.read_vasp(p, omega=c.volume, device="cpu").f.numpy()
    np.testing.assert_array_equal(
        tg, np.asarray(JGrid3.read_vasp(p, omega=c.volume).f))
    assert np.abs(tg - g).max() <= 1e-10 * g.max()
