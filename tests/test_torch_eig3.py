"""ops/eig3 of the torch port against the JAX package, on the CPU.

Same numpy-seeded matrices through both; float64 results must agree to
1e-12 (absolute, on matrices of order one), degenerate and isotropic
matrices included.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from critic2_tpu.ops import eig3 as jeig
from critic2_tpu_torch.ops import eig3 as teig

# the inputs are tiny: one intra-op thread a process, so that parallel
# test workers do not fight over the cores
torch.set_num_threads(1)

TOL = 1e-12


def _sym_batch():
    """(M, 3, 3) symmetric matrices: random ones, then the hard cases."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(40, 3, 3))
    a = a + a.transpose(0, 2, 1)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    special = [
        np.eye(3),                              # isotropic
        np.zeros((3, 3)),                       # null
        np.diag([2.0, 2.0, -1.0]),              # degenerate pair
        q @ np.diag([1.0, 1.0, 3.0]) @ q.T,     # rotated degenerate pair
        q @ np.diag([-0.5, 0.7, 0.7]) @ q.T,
        1e-18 * np.eye(3) + 1e-19 * (a[0] + a[0].T),   # near-isotropic tiny
        np.diag([1.0, 2.0, 3.0]),
    ]
    return np.concatenate([a, np.stack(special)])


def _sym6(m):
    return np.stack([m[:, 0, 0], m[:, 1, 1], m[:, 2, 2],
                     m[:, 0, 1], m[:, 0, 2], m[:, 1, 2]])


def _t(x):
    return torch.as_tensor(x, dtype=torch.float64)


@pytest.mark.parametrize("name", ["det3", "inv3", "eigvalsh3"])
def test_matrix_functions_match_jax(name):
    m = _sym_batch()
    if name == "inv3":
        m = m[:40] + 3.0 * np.eye(3)            # well away from singular
    ref = np.asarray(getattr(jeig, name)(jnp.asarray(m)))
    got = getattr(teig, name)(_t(m)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("name", ["det3s", "eigvalsh3s"])
def test_sym6_functions_match_jax(name):
    h6 = _sym6(_sym_batch())
    ref = np.asarray(getattr(jeig, name)(jnp.asarray(h6)))
    got = getattr(teig, name)(_t(h6)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    assert np.isfinite(got).all()


def test_solve3s_matches_jax_and_solves():
    m = _sym_batch()[:40]
    g = np.random.default_rng(4).normal(size=(3, 40))
    xr, dr = jeig.solve3s(jnp.asarray(_sym6(m)), jnp.asarray(g))
    xt, dt = teig.solve3s(_t(_sym6(m)), _t(g))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xr), rtol=0, atol=TOL)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dr), rtol=0, atol=TOL)
    sol = (xt / dt).numpy()
    np.testing.assert_allclose(np.einsum("nij,jn->in", m, sol), g, atol=1e-9)


def test_eigh3_matches_jax_and_diagonalises():
    m = _sym_batch()
    wr, vr = jeig.eigh3(jnp.asarray(m))
    wt, vt = teig.eigh3(_t(m))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wr), rtol=0, atol=TOL)
    v = vt.numpy()
    # orthonormal basis everywhere; vectors equal to JAX's wherever the
    # spectrum is non-degenerate (inside a degenerate subspace the choice
    # hangs on rounding)
    np.testing.assert_allclose(np.einsum("nji,njk->nik", v, v),
                               np.broadcast_to(np.eye(3), v.shape),
                               atol=1e-10)
    w = np.asarray(wr)
    simple = np.min(np.diff(w, axis=1), axis=1) > 1e-3
    assert simple.sum() >= 40
    np.testing.assert_allclose(v[simple], np.asarray(vr)[simple], rtol=0,
                               atol=1e-10)
    recon = np.einsum("nik,nk,njk->nij", v, wt.numpy(), v)
    np.testing.assert_allclose(recon[simple], m[simple], atol=1e-10)


@pytest.mark.parametrize("eps", [1e-12, 1e-8])
def test_rsindex_matches_jax(eps):
    m = _sym_batch()
    wr, rr, sr = jeig.rsindex(jnp.asarray(m), eps=eps)
    wt, rt, st = teig.rsindex(_t(m), eps=eps)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wr), rtol=0, atol=TOL)
    # rank and signature agree wherever no eigenvalue sits within
    # rounding of +-eps (the closed form leaves ~1e-16 there)
    w = np.asarray(wr)
    clear = (np.abs(np.abs(w) - eps) > 1e-13).all(axis=1)
    assert clear.sum() >= 44
    np.testing.assert_array_equal(rt.numpy()[clear], np.asarray(rr)[clear])
    np.testing.assert_array_equal(st.numpy()[clear], np.asarray(sr)[clear])
    assert rt.numpy()[40] == 3 and st.numpy()[40] == 3      # identity


def test_sym6_rotation_and_linmap_match_jax():
    rng = np.random.default_rng(5)
    M = rng.normal(size=(3, 3))
    M[0, 2] = 0.0                                # linmap skips zeros
    R = teig.sym6_rotation(M)
    np.testing.assert_array_equal(R, jeig.sym6_rotation(M))
    h6 = _sym6(_sym_batch())
    ref = np.asarray(jeig.linmap(R, jnp.asarray(h6)))
    got = teig.linmap(R, _t(h6)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    # R really is the congruence M^T H M
    m = _sym_batch()
    np.testing.assert_allclose(got, _sym6(np.einsum("ki,nkl,lj->nij", M, m,
                                                    M)), atol=1e-10)
    assert teig.linmap(np.zeros((2, 3)), _t(h6[:3])).abs().max() == 0


def test_float32_near_isotropic_stays_finite():
    """The element-wise normalisation by p keeps f32 near-isotropic
    matrices from 0/0 (p^3 flushes to zero in f32)."""
    h6 = np.array([[1.0], [1.0], [1.0], [1e-18], [2e-18], [0.0]],
                  dtype=np.float32)
    ref = np.asarray(jeig.eigvalsh3s(jnp.asarray(h6)))
    got = teig.eigvalsh3s(torch.as_tensor(h6)).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
