"""analysis/nci and io/cube of the torch port against the JAX package, on
the CPU.

The same structure and grid run through both nciplot functions. float64
cubes agree within 1e-10 (relative to the cube's largest magnitude),
selections are identical; the default float32 fast path is held to the
bounds the JAX package's own tests state for f32 against f64
(tests/test_nci_grid.py). Output grids are incommensurate with the input
grid: the Catmull-Rom second derivative jumps at input nodes, so a
comparison on a node would hang on rounding.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from critic2_tpu.analysis.integration import _rasterize_field
from critic2_tpu.analysis.nci import nciplot as jnci
from critic2_tpu.crystal.cell import m_x2c_from_cellpar
from critic2_tpu.crystal.crystal import Crystal, Species
from critic2_tpu.crystal.seed import CrystalSeed
from critic2_tpu.fields.field import Field as JField
from critic2_tpu.fields.grid3 import Grid3 as JGrid3
from critic2_tpu.io.cube import write_cube as jwrite_cube
from critic2_tpu.system import System as JSystem
from critic2_tpu_torch.analysis.nci import nciplot as tnci
from critic2_tpu_torch.convert import crystal_to_arrays, system_from_arrays
from critic2_tpu_torch.io.cube import write_cube as twrite_cube

# the inputs are tiny: one intra-op thread a process, so that parallel
# test workers do not fight over the cores
torch.set_num_threads(1)

CPU = "cpu"
NSTEP = (15, 13, 11)     # each coprime to its grid axis (16, 18, 20)
TOL64 = 1e-10


@pytest.fixture(scope="module")
def ne2():
    """Two Ne atoms in a triclinic cell, promolecular density on a
    16 x 18 x 20 grid as the reference field, in both packages."""
    c = Crystal(m_x2c=m_x2c_from_cellpar([8.0, 8.5, 9.0], [85, 95, 80]),
                x_frac=np.array([[0.0, 0.0, 0.0], [0.5, 0.45, 0.55]]),
                species_of=np.array([0, 0]), species=[Species("Ne", 10)])
    js = JSystem.from_structure(c)
    g = np.asarray(_rasterize_field(js.fields[0], (16, 18, 20)))
    js.load_field(JField.from_grid(c, JGrid3(jnp.asarray(g))))
    ts = system_from_arrays(**crystal_to_arrays(c), grid=g, device=CPU)
    return js, ts


def _cubes_close(tres, jres, tol=TOL64, off_planes=False):
    """off_planes: leave out the output planes of index 0. They lie on
    input node planes, and a route that takes a point through Cartesian
    coordinates and back may land on either side of the node."""
    sl = (slice(1, None),) * 3 if off_planes else (slice(None),) * 3
    for name in ("crho", "cgrad", "cgrad_raw"):
        ref = np.asarray(getattr(jres, name))
        got = getattr(tres, name).numpy()
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert np.abs(got - ref)[sl].max() <= tol * np.abs(ref).max(), name
    shape = tuple(tres.crho.shape)
    np.testing.assert_array_equal(
        tres.dat_sel.numpy().reshape(shape)[sl],
        np.asarray(jres.dat_sel).reshape(shape)[sl])
    assert tres.ndat > 0
    if not off_planes:
        assert tres.ndat == jres.ndat
        np.testing.assert_allclose(tres.dat, jres.dat, rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(tres.x0, jres.x0)
    np.testing.assert_array_equal(tres.xmat, jres.xmat)


@pytest.fixture(scope="module")
def fast64(ne2):
    js, ts = ne2
    return (jnci(js, nstep=NSTEP, precision="f64"),
            tnci(ts, nstep=NSTEP, precision="f64"))


def test_fast_path_f64_matches_jax(fast64):
    jres, tres = fast64
    assert tres.crho.dtype == torch.float64 and tres.rhoat is None
    _cubes_close(tres, jres)


@pytest.mark.parametrize("kw", [
    dict(onlyneg=True), dict(srhorange=(-0.05, 0.02)),
    dict(rhocut=0.05, dimcut=1.0, rhoplot=0.03), dict(isden=False),
], ids=lambda kw: "-".join(kw))
def test_fast_path_cutoffs_match_jax(ne2, kw):
    js, ts = ne2
    _cubes_close(tnci(ts, nstep=NSTEP, precision="f64", **kw),
                 jnci(js, nstep=NSTEP, precision="f64", **kw))


def test_fast_path_default_grid_reproduces_node_values(ne2):
    """nstep defaults to the field's grid; crho there is +-100 rho."""
    _, ts = ne2
    res = tnci(ts, precision="f64")
    assert tuple(res.crho.shape) == ts.ref.grid.n
    np.testing.assert_allclose(res.crho.abs().numpy() / 100.0,
                               ts.ref.grid.f.numpy(), rtol=1e-14)


def test_fast_path_f32_matches_jax_and_f64_bounds(ne2, fast64):
    js, ts = ne2
    j32, t32 = jnci(js, nstep=NSTEP), tnci(ts, nstep=NSTEP)
    assert t32.crho.dtype == torch.float32
    assert np.asarray(j32.crho).dtype == np.float32
    # the port's f32 against the JAX package's f32 and against f64, with
    # the bounds of tests/test_nci_grid.py
    for ref in (j32, fast64[1]):
        r_crho = np.asarray(ref.crho, dtype=np.float64)
        dcr = np.abs(t32.crho.double().numpy() - r_crho)
        mag = np.abs(r_crho)
        signflip = dcr > 1.9 * mag - 1e-6
        assert np.mean(signflip) < 2e-3
        assert np.max(dcr[~signflip] / (mag[~signflip] + 1e-3)) < 1e-4
        r_cg = np.asarray(ref.cgrad, dtype=np.float64)
        t_cg = t32.cgrad.double().numpy()
        m = (t_cg < 99.0) & (r_cg < 99.0)
        assert np.max(np.abs(t_cg[m] - r_cg[m]) / (r_cg[m] + 1e-3)) < 1e-3
        assert np.mean(t32.dat_sel.numpy()
                       != np.asarray(ref.dat_sel)) < 1e-3


def test_generic_route_matches_jax_and_fast_path(ne2, fast64):
    """usecore with an empty zpsp turns the fast path off and adds no
    core density: the chunked route through eval_fn, blocks of 500 points
    (five whole blocks and a rest)."""
    js, ts = ne2
    for s in (js, ts):
        s.ref.usecore = True
    try:
        jres = jnci(js, nstep=NSTEP, block=500)
        tres = tnci(ts, nstep=NSTEP, block=500)
    finally:
        for s in (js, ts):
            s.ref.usecore = False
    _cubes_close(tres, jres, off_planes=True)
    sel = np.zeros(NSTEP, bool)
    sel[1:, 1:, 1:] = True
    fast = fast64[1]
    np.testing.assert_allclose(fast.crho.numpy()[sel], tres.crho.numpy()[sel],
                               rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(fast.cgrad_raw.numpy()[sel],
                               tres.cgrad_raw.numpy()[sel],
                               rtol=1e-7, atol=1e-10)


@pytest.mark.parametrize("kw", [
    dict(fragments=[[0], [1]]),
    dict(fragments=[[0], [1]], rhoparam=0.8, rhoparam2=0.5),
    dict(rho_void=0.02),
    dict(fragments=[[0], [1]], rho_void=0.05),
], ids=["fragments", "fragments-params", "void", "fragments-void"])
def test_fragments_and_void_match_jax(ne2, kw):
    js, ts = ne2
    jres = jnci(js, nstep=NSTEP, precision="f64", **kw)
    tres = tnci(ts, nstep=NSTEP, precision="f64", **kw)
    _cubes_close(tres, jres)
    np.testing.assert_allclose(tres.rhoat.numpy(), np.asarray(jres.rhoat),
                               rtol=1e-12, atol=1e-300)
    assert 0 < tres.ndat < np.prod(NSTEP)
    if "rho_void" in kw:
        assert set(tres.void) == {"charge", "pcharge", "volume"}
        for k, v in jres.void.items():
            assert tres.void[k] == pytest.approx(v, rel=1e-10)
        assert 0 < tres.void["volume"] < ts.crystal.volume
    else:
        assert tres.void is None


def test_promolecular_molecule_matches_jax(tmp_path):
    """A molecule takes the generic route on the promolecular field, in a
    box around the atoms; all five files come out the same."""
    cart = np.array([[0.0, 0.0, 0.22], [0.0, 1.43, -0.89],
                     [0.0, -1.43, -0.89], [0.0, 0.0, 5.5]])
    c = CrystalSeed(x_frac=cart, species_of=np.array([0, 1, 1, 0]),
                    species=[Species("O", 8), Species("H", 1)],
                    ismolecule=True).to_crystal()
    js = JSystem.from_structure(c)
    ts = system_from_arrays(**crystal_to_arrays(c), device=CPU)
    kw = dict(nstep=(12, 10, 14), write_files=True, oname="w")
    jres = jnci(js, outdir=str(tmp_path / "j"), **_mk(tmp_path / "j"), **kw)
    tres = tnci(ts, outdir=str(tmp_path / "t"), **_mk(tmp_path / "t"), **kw)
    _cubes_close(tres, jres)
    assert [os.path.basename(f) for f in tres.files] == \
        [os.path.basename(f) for f in jres.files] == \
        ["w-dens.cube", "w-grad.cube", "w.dat", "w.vmd", "w_cell.xyz"]
    for ft, fj in zip(tres.files, jres.files):
        with open(ft) as a, open(fj) as b:
            ta, tb = a.read(), b.read()
        if ft.endswith((".vmd", ".xyz")):
            assert ta == tb
            continue
        # numbers printed with up to 14 digits of values equal to ~1e-12
        la, lb = ta.split(), tb.split()
        assert len(la) == len(lb) > 100
        skip = 2 if ft.endswith(".cube") else 0      # the comment lines
        assert ta.splitlines()[:skip] == tb.splitlines()[:skip]
        va = np.array([float(v) for v in ta.split("\n", skip)[-1].split()])
        vb = np.array([float(v) for v in tb.split("\n", skip)[-1].split()])
        assert np.abs(va - vb).max() <= TOL64 * np.abs(vb).max()


def _mk(path):
    os.makedirs(path)
    return {}


def test_periodic_promolecular_box_from_xinc(ne2):
    """No grid field as reference: the box comes from xinc, the route is
    the generic one."""
    js, ts = ne2
    for s in (js, ts):
        s.iref = 0
    try:
        jres = jnci(js, xinc=0.9)
        tres = tnci(ts, xinc=0.9)
    finally:
        for s in (js, ts):
            s.iref = 1
    assert tuple(tres.crho.shape) == (9, 10, 10)
    _cubes_close(tres, jres)


@pytest.mark.parametrize("precise", [True, False, None])
def test_write_cube_equals_jax_package(tmp_path, precise):
    rng = np.random.default_rng(0)
    data = rng.normal(size=(3, 4, 7)) * 10.0 ** rng.integers(-30, 30,
                                                             size=(3, 4, 7))
    args = (np.array([0.1, -0.2, 0.3]), rng.normal(size=(3, 3)), [8, 1],
            rng.normal(size=(2, 3)))
    jwrite_cube(tmp_path / "j.cube", data, *args, precise=precise)
    twrite_cube(tmp_path / "t.cube", torch.as_tensor(data), *args,
                precise=precise)
    assert (tmp_path / "t.cube").read_text() == \
        (tmp_path / "j.cube").read_text()
