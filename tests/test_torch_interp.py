"""ops/interp, Grid3.interp and the grid Field of the torch port against
the JAX package, on the CPU.

Same numpy-seeded grids and points through both. Tolerances, relative to
the largest magnitude of the reference array: 1e-12 in float64, 1e-5 in
float32. Grids have unequal axes; points include negative coordinates,
exact nodes and coordinates at and just below a cell edge (where
x - floor(x) rounds to 1 and the base index equals n).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from critic2_tpu.crystal.cell import m_x2c_from_cellpar
from critic2_tpu.crystal.crystal import Crystal, Species
from critic2_tpu.fields.field import Field as JField
from critic2_tpu.fields.grid3 import Grid3 as JGrid3
from critic2_tpu.ops import interp as jinterp
from critic2_tpu_torch.convert import crystal_from_arrays, crystal_to_arrays
from critic2_tpu_torch.fields.field import Field
from critic2_tpu_torch.fields.grid3 import Grid3
from critic2_tpu_torch.ops import interp as tinterp

# the inputs are tiny: one intra-op thread a process, so that parallel
# test workers do not fight over the cores
torch.set_num_threads(1)

SHAPE = (12, 15, 18)
TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _grid(shape=SHAPE, seed=0):
    """A smooth periodic field plus a little noise, order one."""
    rng = np.random.default_rng(seed)
    i, j, k = np.meshgrid(*[np.arange(n) / n for n in shape], indexing="ij")
    f = (np.cos(2 * np.pi * i) * np.sin(4 * np.pi * j) + np.cos(2 * np.pi * k)
         + 0.3 * np.sin(2 * np.pi * (i + j + k)))
    return f + 0.05 * rng.random(shape)


def _points(n=150, seed=1):
    """(3, n + edge cases) fractional points."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.5, 2.5, size=(3, n))
    below = np.nextafter(1.0, 0.0)
    edge = np.array([
        [0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [below, below, below],
        [-1e-18, 0.5, 0.25], [0.3, -1e-18, below], [2.0 / 12, 5.0 / 15, 0.5],
        [-2.0 / 12, 1.0 + 7.0 / 15, -1.0], [below, 0.0, -below],
    ]).T
    return np.concatenate([x, edge], axis=1)


def _close(got, ref, dt):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype == dt
    scale = max(float(np.abs(ref).max()), 1e-300)
    assert float(np.abs(got - ref).max()) <= TOL[dt] * scale


def _both(name, dt, *, kw, pts=None):
    f = _grid().astype(dt)
    args_j = [jnp.asarray(f)]
    args_t = [torch.as_tensor(f)]
    if pts is not None:
        args_j.append(jnp.asarray(pts))
        args_t.append(torch.as_tensor(pts))
    ref = getattr(jinterp, name)(*args_j, **kw)
    got = getattr(tinterp, name)(*args_t, **kw)
    return [g.numpy() for g in got], [np.asarray(r) for r in ref]


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("nder", [0, 1, 2])
@pytest.mark.parametrize("mode", ["nearest", "trilinear", "tricubic"])
def test_interp_soa_matches_jax(mode, nder, dt):
    got, ref = _both("interp_soa", dt, kw=dict(mode=mode, nder=nder),
                     pts=_points())
    for g, r in zip(got, ref):
        _close(g, r, dt)
    if mode != "tricubic" or nder < 2:
        assert not got[2].any()


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("nder", [0, 1, 2])
def test_interp_soa_rows_matches_jax_and_interp_soa(nder, dt):
    pts = _points()
    got, ref = _both("interp_soa_rows", dt, kw=dict(nder=nder, chunk=64),
                     pts=pts)            # 158 points: two chunks and a rest
    for g, r in zip(got, ref):
        _close(g, r, dt)
    one = tinterp.interp_soa_rows(torch.as_tensor(_grid().astype(dt)),
                                  torch.as_tensor(pts), nder=nder)
    soa = tinterp.interp_soa(torch.as_tensor(_grid().astype(dt)),
                             torch.as_tensor(pts), nder=nder)
    for a, g, s in zip(one, got, soa):
        _close(a.numpy(), g, dt)         # chunking does not change values
        _close(g, s.numpy(), dt)         # both routes, one interpolant


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("nder", [0, 1, 2])
def test_interp_grid_soa_matches_jax(nder, dt):
    """Output grid incommensurate with the input, non-zero origin and
    non-unit lengths. The JAX side runs its banded-matrix engine in f32
    and its take engine in f64; the port has the take engine alone."""
    kw = dict(nout=(7, 11, 13), origin=(0.013, -0.41, 0.77),
              lengths=(1.0, 0.5, 1.7), nder=nder)
    got, ref = _both("interp_grid_soa", dt, kw=kw)
    for g, r in zip(got, ref):
        _close(g, r, dt)


def test_interp_grid_soa_matches_scattered_route_and_nodes():
    f = torch.as_tensor(_grid())
    nout, origin, lengths = (7, 11, 13), (0.013, -0.41, 0.77), (1.0, 0.5, 1.7)
    y, yp, ypp6 = tinterp.interp_grid_soa(f, nout, origin, lengths)
    ax = [origin[a] + np.arange(nout[a]) / nout[a] * lengths[a]
          for a in range(3)]
    pts = np.stack(np.meshgrid(*ax, indexing="ij")).reshape(3, -1)
    ys, yps, ypp6s = tinterp.interp_soa(f, torch.as_tensor(pts))
    _close(y.reshape(-1).numpy(), ys.numpy(), np.float64)
    _close(yp.reshape(3, -1).numpy(), yps.numpy(), np.float64)
    _close(ypp6.reshape(6, -1).numpy(), ypp6s.numpy(), np.float64)
    # at nout = grid shape the node values come back exactly
    y0, _, _ = tinterp.interp_grid_soa(f, SHAPE, nder=0)
    assert torch.equal(y0, f)


def test_batch_first_wrappers_match_jax():
    f, pts = _grid(), _points().T
    ref = jinterp.interp_batch(jnp.asarray(f), jnp.asarray(pts))
    got = tinterp.interp_batch(torch.as_tensor(f), torch.as_tensor(pts))
    for g, r in zip(got, ref):
        _close(g.numpy(), r, np.float64)
    h6 = tinterp.mat_to_sym6(got[2])
    assert torch.equal(tinterp.sym6_to_mat(h6), got[2])
    idx = np.array([[0, 0, 0], [-1, 15, 40], [11, 14, 17], [12, -16, 18]])
    np.testing.assert_array_equal(
        tinterp.eval_at_nodes(torch.as_tensor(f),
                              torch.as_tensor(idx)).numpy(),
        np.asarray(jinterp.eval_at_nodes(jnp.asarray(f), jnp.asarray(idx))))


@pytest.mark.parametrize("mode", ["nearest", "trilinear", "tricubic"])
def test_grid3_interp_matches_jax(mode):
    f, pts = _grid(), _points().T
    jg = JGrid3(jnp.asarray(f))
    tg = Grid3(torch.as_tensor(f))
    assert tg.mode == jg.mode == "tricubic"
    jg.setmode(mode)
    tg.setmode(mode)
    for g, r in zip(tg.interp(pts), jg.interp(pts)):
        _close(g.numpy(), r, np.float64)
    with pytest.raises(ValueError, match="unknown interpolation mode"):
        tg.setmode("quintic")


# ---------------------------------------------------------------------------
# the grid Field on a triclinic cell
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def triclinic_fields():
    c = Crystal(m_x2c=m_x2c_from_cellpar([7.0, 8.0, 9.0], [80, 95, 70]),
                x_frac=np.array([[0.1, 0.2, 0.3], [0.6, 0.55, 0.45]]),
                species_of=np.array([0, 1]),
                species=[Species("Na", 11), Species("Cl", 17)])
    f = _grid(seed=2) + 2.0
    jf = JField.from_grid(c, JGrid3(jnp.asarray(f)))
    tf = Field.from_grid(crystal_from_arrays(**crystal_to_arrays(c)),
                         Grid3(torch.as_tensor(f)))
    rng = np.random.default_rng(6)
    pts = rng.uniform(-5.0, 12.0, size=(60, 3))
    pts[:2] = c.x_cart                       # on the nuclei
    pts[2] = c.x_cart[0] + c.m_x2c @ [1, -1, 2]   # on a periodic image
    return jf, tf, pts


@pytest.mark.parametrize("nder", [0, 1, 2])
@pytest.mark.parametrize("core", [False, True])
def test_field_grd_matches_jax(triclinic_fields, core, nder):
    jf, tf, pts = triclinic_fields
    for fld in (jf, tf):
        fld.set_options(core=core, zpsp={11: 1, 17: 7})
    try:
        ref = jf.grd(pts, nder=nder)
        got = tf.grd(pts, nder=nder)
    finally:
        for fld in (jf, tf):
            fld.set_options(core=False, zpsp={})
    # the core density's Hessian is singular on a nucleus (1/r, r clamped
    # at 1e-14): compare it away from the nuclei
    off = slice(3, None) if core else slice(None)
    for name in ("f", "gf", "hf", "fval", "gfmod", "del2f"):
        sl = off if name in ("hf", "del2f") else slice(None)
        _close(getattr(got, name).numpy()[sl],
               np.asarray(getattr(ref, name))[sl], np.float64)
    np.testing.assert_array_equal(got.isnuc.numpy(), np.asarray(ref.isnuc))
    assert got.isnuc[:3].all() and not got.isnuc[3:].any()
    assert (got.f != got.fval).any() == core
    _close(tf.grd0(pts).numpy(), jf.grd0(pts), np.float64)


@pytest.mark.parametrize("clamp", [True, False])
@pytest.mark.parametrize("mode", ["tricubic", "trilinear"])
def test_field_eval_fn_matches_jax(triclinic_fields, mode, clamp):
    jf, tf, pts = triclinic_fields
    for fld in (jf, tf):
        fld.set_options(interp=mode)
    try:
        ref = jf.eval_fn(nder=2, clamp_nuclei=clamp)(jnp.asarray(pts.T))
        fn = tf.eval_fn(nder=2, clamp_nuclei=clamp)
        got = fn(torch.as_tensor(pts.T))
        assert tf.eval_fn(nder=2, clamp_nuclei=clamp) is fn     # cached
    finally:
        for fld in (jf, tf):
            fld.set_options(interp="tricubic")
    for g, r in zip(got, ref):
        _close(g.numpy(), r, np.float64)
    assert (got[1][:, :3] == 0).all() == clamp
    assert not hasattr(fn, "_c2t_raw") and not hasattr(fn, "_c2t_consts")
