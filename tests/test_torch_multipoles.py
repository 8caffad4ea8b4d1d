"""The port's solid harmonics (ops/rlm.py) and atomic multipoles against
the JAX package on the CPU (multipoles to 1e-8), with the JAX tests' own
analytic bars."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from critic2_tpu import System as JSystem
from critic2_tpu.analysis.integration import intgrid as jintgrid
from critic2_tpu.analysis.integration import multipoles as jmultipoles
from critic2_tpu.crystal.cell import m_x2c_from_cellpar
from critic2_tpu.crystal.crystal import Crystal, Species
from critic2_tpu.fields.field import Field as JField
from critic2_tpu.fields.grid3 import Grid3 as JGrid3
from critic2_tpu.ops import rlm as jrlm
from critic2_tpu_torch.analysis.integration import intgrid, multipoles
from critic2_tpu_torch.convert import crystal_to_arrays, system_from_arrays
from critic2_tpu_torch.ops import rlm as trlm
from critic2_tpu_torch.ops.lebedev import lebedev

# the inputs are tiny: one intra-op thread a process, so that parallel
# test workers do not fight over the cores
torch.set_num_threads(1)

CPU = "cpu"


@pytest.mark.parametrize("lmax", [0, 2, 4])
def test_solid_harmonics_match_jax(lmax):
    x = np.random.default_rng(0).normal(0, 1, (3, 64))
    x[:, 0] = 0.0                                   # finite at r = 0
    t = trlm.solid_harmonics(torch.as_tensor(x), lmax)
    j = np.asarray(jrlm.solid_harmonics(jnp.asarray(x), lmax))
    assert tuple(t.shape) == (trlm.nlm(lmax), 64) == j.shape
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-13, atol=1e-13)


def test_solid_harmonics_lowl():
    x = np.random.default_rng(1).normal(0, 1, (3, 64))
    rl = trlm.solid_harmonics(torch.as_tensor(x), 2).numpy()
    xx, yy, zz = x
    r2 = xx**2 + yy**2 + zz**2
    np.testing.assert_allclose(rl[0], np.sqrt(1 / (4 * np.pi)), rtol=1e-12)
    c1 = np.sqrt(3 / (4 * np.pi))
    np.testing.assert_allclose(rl[1], c1 * yy, rtol=1e-10)   # m=-1
    np.testing.assert_allclose(rl[2], c1 * zz, rtol=1e-10)   # m=0
    np.testing.assert_allclose(rl[3], c1 * xx, rtol=1e-10)   # m=+1
    np.testing.assert_allclose(
        rl[6], np.sqrt(5 / (16 * np.pi)) * (3 * zz**2 - r2), rtol=1e-10)
    np.testing.assert_allclose(
        rl[8], np.sqrt(15 / (16 * np.pi)) * (xx**2 - yy**2), rtol=1e-10)


def test_orthonormality_on_sphere():
    pts, w = lebedev(110)
    rl = trlm.solid_harmonics(torch.as_tensor(pts.T.copy()), 3).numpy()
    G = (rl * w[None, :]) @ rl.T * 4 * np.pi
    np.testing.assert_allclose(G, np.eye(len(G)), atol=1e-9)


def _gaussians(amps):
    c = Crystal(m_x2c=m_x2c_from_cellpar([10.0] * 3, [90] * 3),
                x_frac=np.array([[0.25, 0.25, 0.25], [0.75, 0.75, 0.75]]),
                species_of=np.array([0, 0]), species=[Species("He", 2)])
    shape = (24, 24, 24)
    g = np.stack(np.meshgrid(*[np.arange(n) / n for n in shape],
                             indexing="ij"), axis=-1)
    rho = np.zeros(shape)
    for site, amp in zip(c.x_frac, amps):
        d = g - site
        d -= np.rint(d)
        rho += amp * np.exp(-2.0 * ((d @ np.asarray(c.m_x2c).T) ** 2).sum(-1))
    js = JSystem.from_structure(c)
    js.load_field(JField.from_grid(c, JGrid3(jnp.asarray(rho))))
    ts = system_from_arrays(**crystal_to_arrays(c), grid=rho, device=CPU)
    return js, ts


@pytest.mark.parametrize("method", ["yt", "bader"])
def test_multipoles_match_jax(method):
    js, ts = _gaussians((1.0, 0.7))
    jr, tr = jintgrid(js, method=method), intgrid(ts, method=method)
    jq, tq = jmultipoles(js, jr, lmax=2), multipoles(ts, tr, lmax=2)
    assert tq.shape == jq.shape == (2, 9)
    np.testing.assert_allclose(tq, jq, rtol=0, atol=1e-8)


def test_basin_multipoles_symmetric():
    _, ts = _gaussians((1.0, 1.0))
    res = intgrid(ts, method="yt")
    q = multipoles(ts, res, lmax=2)
    # monopole = S00 * pop; dipoles vanish by symmetry
    np.testing.assert_allclose(q[:, 0], np.sqrt(1 / (4 * np.pi))
                               * res.charges, rtol=1e-10)
    assert np.abs(q[:, 1:4]).max() < 1e-3
