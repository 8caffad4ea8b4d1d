"""The port's FFT grid operators and FFT-derived fields against the JAX
package on the CPU (both transform in complex128 there), plus the JAX
tests' analytic plane-wave bars."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from critic2_tpu import System as JSystem
from critic2_tpu.crystal import cell
from critic2_tpu.crystal.crystal import Crystal, Species
from critic2_tpu.fields.field import Field as JField
from critic2_tpu.fields.grid3 import Grid3 as JGrid3
from critic2_tpu.ops import fft as jfft
from critic2_tpu_torch.convert import crystal_to_arrays, system_from_arrays
from critic2_tpu_torch.ops import fft as tfft

# the inputs are tiny: one intra-op thread a process, so that parallel
# test workers do not fight over the cores
torch.set_num_threads(1)

CPU = "cpu"
RTOL = 1e-10        # FFT grids: port against JAX, relative to the grid's max


def _planewave(n=(18, 20, 24),
               cellpar=([6.0, 7.0, 8.0], [80.0, 95.0, 102.0])):
    m = cell.m_x2c_from_cellpar(*cellpar)
    frac = np.stack(np.meshgrid(*[np.arange(k) / k for k in n],
                                indexing="ij"), axis=-1)
    cart = frac @ m.T
    G = cell.reciprocal_vectors(m) @ np.array([1.0, 2.0, -1.0])
    return m, np.cos(cart @ G), G, cart


def _random_field(seed=0, n=(12, 10, 14)):
    rng = np.random.default_rng(seed)
    m = cell.m_x2c_from_cellpar([5.0, 6.0, 7.0], [85.0, 95.0, 100.0])
    return m, rng.random(n)


def _close(t, j, rtol=RTOL):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=0,
                               atol=rtol * np.abs(j).max())


@pytest.mark.parametrize("op", ["laplacian", "gradrho", "pot",
                                "grad_components"])
def test_operator_matches_jax(op):
    m, f = _random_field()
    _close(getattr(tfft, op)(torch.as_tensor(f), m),
           getattr(jfft, op)(jnp.asarray(f), m))


@pytest.mark.parametrize("ix", [0, 1, 2])
def test_hxx_matches_jax(ix):
    m, f = _random_field(1)
    _close(tfft.hxx(torch.as_tensor(f), m, ix),
           jfft.hxx(jnp.asarray(f), m, ix))


def test_gvectors_match_jax():
    m, f = _random_field()
    np.testing.assert_allclose(tfft.gvectors(f.shape, m).numpy(),
                               jfft.gvectors(f.shape, m), rtol=0,
                               atol=1e-13)


def test_even_grid_nyquist_plane_matches_jax():
    """Even axes carry a Nyquist plane; the odd operator i G f_k must
    treat it as the reference does (full fftn + real part)."""
    m, f = _random_field(2, n=(8, 8, 6))
    _close(tfft.grad_components(torch.as_tensor(f), m),
           jfft.grad_components(jnp.asarray(f), m))


def test_laplacian_planewave():
    m, f, G, _ = _planewave()
    lap = tfft.laplacian(torch.as_tensor(f), m).numpy()
    np.testing.assert_allclose(lap, -(G @ G) * f, atol=1e-9)


def test_gradrho_planewave():
    m, f, G, cart = _planewave()
    gr = tfft.gradrho(torch.as_tensor(f), m).numpy()
    np.testing.assert_allclose(
        gr, np.abs(np.sin(cart @ G)) * np.linalg.norm(G), atol=1e-9)


def test_hxx_planewave_and_trace():
    m, f, G, _ = _planewave()
    ft = torch.as_tensor(f)
    hs = [tfft.hxx(ft, m, ix) for ix in range(3)]
    for ix in range(3):
        np.testing.assert_allclose(hs[ix].numpy(), -G[ix] ** 2 * f,
                                   atol=1e-9)
    lap = tfft.laplacian(ft, m)
    np.testing.assert_allclose((hs[0] + hs[1] + hs[2]).numpy(), lap.numpy(),
                               rtol=0, atol=1e-10 * float(lap.abs().max()))


def test_pot_poisson():
    m, rho, _, _ = _planewave()
    v = tfft.pot(torch.as_tensor(rho), m)
    lap = tfft.laplacian(v, m).numpy()
    np.testing.assert_allclose(lap, -4 * np.pi * rho, atol=1e-8)
    v2 = tfft.pot(torch.as_tensor(rho), m, isry=True)
    np.testing.assert_allclose(v2.numpy(), 2 * v.numpy(), atol=1e-12)
    assert abs(float(v.mean())) < 1e-10        # V(G = 0) = 0


def test_transform_keeps_the_grid_dtype():
    """No complex64 downcast: an f64 grid comes back f64 at f64 accuracy,
    an f32 grid comes back f32."""
    m, f, G, _ = _planewave()
    assert tfft.laplacian(torch.as_tensor(f), m).dtype == torch.float64
    lap32 = tfft.laplacian(torch.as_tensor(f, dtype=torch.float32), m)
    assert lap32.dtype == torch.float32
    np.testing.assert_allclose(lap32.numpy(), -(G @ G) * f, atol=2e-3)


# ---------------------------------------------------------------- load_as
@pytest.fixture(scope="module")
def systems():
    c = Crystal(m_x2c=cell.m_x2c_from_cellpar([6.0, 6.5, 7.0], [90, 95, 90]),
                x_frac=np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]),
                species_of=np.array([0, 1]),
                species=[Species("Na", 11), Species("Cl", 17)])
    g = np.random.default_rng(4).random((10, 12, 8)) + 0.5
    js = JSystem.from_structure(c)
    js.load_field(JField.from_grid(c, JGrid3(jnp.asarray(g)), name="g"))
    ts = system_from_arrays(**crystal_to_arrays(c), grid=g, device=CPU)
    return js, ts


@pytest.mark.parametrize("kind", ["lap", "grad", "pot", "hxx1", "hxx2",
                                  "hxx3"])
def test_load_field_as_fft_kinds_match_jax(systems, kind):
    js, ts = systems
    jf = js.field(js.load_field_as(kind, src=1, fid=50))
    tf = ts.field(ts.load_field_as(kind, src=1, fid=50))
    assert tf.type == "grid" and tf.name == jf.name
    _close(tf.grid.f, jf.grid.f)


@pytest.mark.parametrize("kind", ["clm add", "clm sub"])
def test_load_field_as_clm_matches_jax(systems, kind):
    js, ts = systems
    js.load_field_as("lap", src=1, fid=60)
    ts.load_field_as("lap", src=1, fid=60)
    jf = js.field(js.load_field_as(kind, src=1, src2=60, fid=61))
    tf = ts.field(ts.load_field_as(kind, src=1, src2=60, fid=61))
    _close(tf.grid.f, jf.grid.f)


def test_load_field_as_promolecular_and_core_match_jax(systems):
    js, ts = systems
    jf = js.field(js.load_field_as("promolecular", shape=(8, 8, 8), fid=70))
    tf = ts.field(ts.load_field_as("promolecular", shape=(8, 8, 8), fid=70))
    _close(tf.grid.f, jf.grid.f, rtol=1e-12)
    jf = js.field(js.load_field_as("promolecular", shape=(8, 8, 8), fid=71,
                                   fragment=[1]))
    tf = ts.field(ts.load_field_as("promolecular", shape=(8, 8, 8), fid=71,
                                   fragment=[1]))
    _close(tf.grid.f, jf.grid.f, rtol=1e-12)
    js.zpsp = {11: 9, 17: 7}
    ts.zpsp = {11: 9, 17: 7}
    jf = js.field(js.load_field_as("core", shape=(8, 8, 8), fid=72))
    tf = ts.field(ts.load_field_as("core", shape=(8, 8, 8), fid=72))
    _close(tf.grid.f, jf.grid.f, rtol=1e-12)


def test_load_field_as_copy_and_errors(systems):
    _, ts = systems
    fid = ts.load_field_as("copy", src=1, fid=80)
    assert ts.field(fid).grid is ts.field(1).grid
    assert ts.field(fid).name == "<copy:1>"
    with pytest.raises(ValueError):
        ts.load_field_as("lap", src=0)            # not a grid field
    with pytest.raises(ValueError):
        ts.load_field_as("nonsense", src=1)
