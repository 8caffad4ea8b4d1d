"""ops/newton of the torch port against the JAX package, on the CPU.

The same seeds run through both newton_batch functions over the same
grid field (tricubic interpolation in both): final positions within
1e-10 bohr, convergence masks identical. The port's active-lane packing
is forced at a small batch through its internal stepper and must change
nothing.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from critic2_tpu.crystal.crystal import Crystal
from critic2_tpu.fields.field import Field as JField
from critic2_tpu.fields.grid3 import Grid3 as JGrid3
from critic2_tpu.ops.newton import newton_batch as jnewton
from critic2_tpu_torch.convert import crystal_from_arrays, crystal_to_arrays
from critic2_tpu_torch.fields.field import Field
from critic2_tpu_torch.fields.grid3 import Grid3
from critic2_tpu_torch.ops import newton as tnewton

# the inputs are tiny: one intra-op thread a process, so that parallel
# test workers do not fight over the cores
torch.set_num_threads(1)

A = 6.0
N = 16
TOL_POS = 1e-10      # bohr


def _fields(dims):
    """Cubic cell, f = sum of cos(2 pi x_a) over the axes in `dims`."""
    c = Crystal(m_x2c=np.eye(3) * A, x_frac=np.zeros((0, 3)),
                species_of=np.zeros(0, dtype=int), species=[])
    ax = np.meshgrid(*[np.arange(N) / N] * 3, indexing="ij")
    f = sum(np.cos(2 * np.pi * ax[a]) for a in dims)
    jf = JField.from_grid(c, JGrid3(jnp.asarray(f)))
    tf = Field.from_grid(crystal_from_arrays(**crystal_to_arrays(c)),
                         Grid3(torch.as_tensor(f)))
    return jf.eval_fn(nder=2), tf.eval_fn(nder=2)


def _seeds_near_cps(n, seed=0):
    """Cartesian seeds scattered within 0.15 (fractional) of the eight
    critical points of the 3-D cosine field; the first eight sit exactly
    on them. Newton from there converges without wandering, so rounding
    cannot send a lane to another critical point."""
    rng = np.random.default_rng(seed)
    cps = np.array([[i, j, k] for i in (0, .5) for j in (0, .5)
                    for k in (0, .5)])
    x = cps[rng.integers(0, 8, size=n)] + rng.uniform(-.15, .15, size=(n, 3))
    x[:8] = cps
    return x * A


@pytest.fixture(scope="module")
def cosine3():
    jfn, tfn = _fields((0, 1, 2))
    x0 = _seeds_near_cps(4500)
    xr, cr, _ = jnewton(jfn, jnp.asarray(x0))     # packs lanes: N >= 4096
    return tfn, x0, np.asarray(xr), np.asarray(cr)


def test_newton_batch_matches_jax(cosine3):
    tfn, x0, xr, cr = cosine3
    x0t = torch.as_tensor(x0)
    keep = x0t.clone()
    # segments of 2 iterations: lanes settle at different segments, so
    # the packing (N >= COMPACT_MIN) really happens
    xt, ct, nit = tnewton.newton_batch(tfn, x0t, chunk=2)
    assert x0.shape[0] >= tnewton.COMPACT_MIN
    assert torch.equal(x0t, keep)                    # seeds not overwritten
    assert cr.all() and nit < 200
    np.testing.assert_array_equal(ct.numpy(), cr)
    assert np.abs(xt.numpy() - xr).max() <= TOL_POS
    # the default segment length gives the same answer
    xd, cd, _ = tnewton.newton_batch(tfn, x0t[:300])
    assert cd.all()
    assert np.abs(xd.numpy() - xr[:300]).max() <= TOL_POS
    # converged means converged: |grad| below the threshold afterwards
    _, gf, _ = tfn(xt.T.contiguous())
    assert float((gf * gf).sum(0).sqrt().max()) < 1e-12


@pytest.mark.parametrize("chunk", [1, 2, 7])
def test_packing_changes_nothing(cosine3, chunk):
    tfn, x0, xr, cr = cosine3
    xT = torch.as_tensor(x0[:300].T.copy())
    never = 10 ** 9
    xa, ca, ita = tnewton._newton_run(tfn, xT.clone(), 1e-12, 200, chunk, 16)
    xb, cb, itb = tnewton._newton_run(tfn, xT.clone(), 1e-12, 200, chunk,
                                      never)
    # lanes are independent; only the library's rounding of a reduction
    # may depend on the batch width
    assert torch.equal(ca, cb) and ita == itb
    assert float((xa - xb).abs().max()) <= 1e-13
    assert np.abs(xa.T.numpy() - xr[:300]).max() <= TOL_POS


def _bowl_or_ramp(xp):
    """An analytic evaluator for either array module: the bowl
    f = |x|^2 / 2 where y > -1 (one Newton step lands on the origin) and
    the ramp f = x elsewhere (zero Hessian: singular at once)."""
    def fn(xT):
        bowl = xT[1] > -1.0
        one, zero = xp.ones_like(xT[0]), xp.zeros_like(xT[0])
        ramp_g = xp.stack([one, zero, zero])
        f = xp.where(bowl, 0.5 * (xT * xT).sum(0), xT[0])
        gf = xp.where(bowl[None, :], xT, ramp_g)
        d = xp.where(bowl, one, zero)
        return f, gf, xp.stack([d, d, d, zero, zero, zero])
    return fn


def test_singular_hessian_fails_as_in_jax():
    rng = np.random.default_rng(1)
    x0 = rng.uniform(-3, 3, size=(64, 3))
    x0[0] = 0.0                                     # converged at once
    ramp = x0[:, 1] <= -1.0
    assert 8 < ramp.sum() < 56
    xr, cr, _ = jnewton(_bowl_or_ramp(jnp), jnp.asarray(x0), maxit=30)
    xt, ct, _ = tnewton.newton_batch(_bowl_or_ramp(torch),
                                     torch.as_tensor(x0), maxit=30)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cr))
    np.testing.assert_array_equal(ct.numpy(), ~ramp)
    assert np.abs(xt.numpy() - np.asarray(xr)).max() <= TOL_POS
    np.testing.assert_array_equal(xt.numpy()[ramp], x0[ramp])   # frozen
    assert np.abs(xt.numpy()[~ramp]).max() == 0.0


def test_maxit_exhausted_is_not_converged():
    _, tfn = _fields((0, 1, 2))
    x0 = torch.as_tensor(_seeds_near_cps(32, seed=3)[8:])
    _, c1, it1 = tnewton.newton_batch(tfn, x0, maxit=1)
    _, c9, it9 = tnewton.newton_batch(tfn, x0, maxit=25, chunk=4)
    assert it1 == 1 and not c1.any()
    assert c9.all() and it9 % 4 == 0 and it9 < 25
