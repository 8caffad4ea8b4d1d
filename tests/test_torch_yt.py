"""The torch port's YT decomposition against the JAX package's, on the CPU.

Same inputs from a numpy seed through `critic2_tpu.analysis.yt` and
`critic2_tpu_torch.analysis.yt`; the cases follow tests/test_yt.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from critic2_tpu.analysis import yt as jyt
from critic2_tpu.crystal.cell import m_x2c_from_cellpar
from critic2_tpu.crystal.crystal import Crystal, Species
from critic2_tpu_torch.analysis import yt as tyt
from critic2_tpu_torch.convert import crystal_from_arrays, crystal_to_arrays
from critic2_tpu_torch.utils import trace

# the inputs are tiny: one intra-op thread a process, so that parallel
# test workers do not fight over the cores
torch.set_num_threads(1)


def _port(c):
    return crystal_from_arrays(**crystal_to_arrays(c))


def _problem(shape, seed=3, cell=([8.0, 8.0, 8.0], [90, 90, 90])):
    c = Crystal(m_x2c=m_x2c_from_cellpar(*cell),
                x_frac=np.array([[0.25, 0.25, 0.25], [0.75, 0.7, 0.6]]),
                species_of=np.array([0, 0]), species=[Species("C", 6)])
    g = np.stack(np.meshgrid(*[np.arange(s) / s for s in shape],
                             indexing="ij"), axis=-1)
    rho = np.zeros(shape)
    for site, amp in zip(c.x_frac, (1.0, 0.8)):
        d = g - site
        d -= np.rint(d)
        rho += amp * np.exp(-((d @ np.asarray(c.m_x2c).T) ** 2).sum(-1))
    rng = np.random.default_rng(seed)
    rho += 1e-3 * rng.random(shape)     # break plateaus irregularly
    return c, rho


@pytest.mark.parametrize("shape", [(24, 24, 24), (32, 28, 24)])
def test_yt_integrate_matches_jax(shape):
    c, rho = _problem(shape)
    rj = jyt.yt_integrate(c, jnp.asarray(rho))
    rt = tyt.yt_integrate(_port(c), torch.as_tensor(rho))
    assert rt.nattr == rj.nattr
    np.testing.assert_array_equal(rt.iattr, np.asarray(rj.iattr))
    np.testing.assert_array_equal(rt.xattr, np.asarray(rj.xattr))
    assert rt._offs == rj._offs
    np.testing.assert_allclose(rt._chiP.numpy(), np.asarray(rj._chiP),
                               rtol=0, atol=1e-14)
    # one integrand and a stack
    for f in (rho.reshape(-1), np.stack([np.ones(rho.size),
                                         rho.reshape(-1)])):
        qj = np.asarray(rj.integrate(jnp.asarray(f)))
        qt = rt.integrate(torch.as_tensor(f))
        assert qt.shape == qj.shape
        np.testing.assert_allclose(qt, qj, rtol=1e-12,
                                   atol=1e-12 * np.abs(qj).max())


def test_yt_labels_and_weights_match_jax():
    c, rho = _problem((16, 12, 10))
    rj = jyt.yt_integrate(c, jnp.asarray(rho))
    rt = tyt.yt_integrate(_port(c), torch.as_tensor(rho))
    np.testing.assert_array_equal(rt.labels, np.asarray(rj.labels))
    assert rt.nboundary == rj.nboundary
    b = int(np.argmax(rt.integrate(rho.reshape(-1))))
    np.testing.assert_allclose(rt.weights(b), np.asarray(rj.weights(b)),
                               rtol=0, atol=1e-12)
    it, wt = rt.basin_support(b)
    ij, wj = rj.basin_support(b)
    np.testing.assert_array_equal(it, ij)


def test_yt_two_attractors_integral():
    c, rho = _problem((20, 20, 20))
    res = tyt.yt_integrate(_port(c), torch.as_tensor(rho))
    q = res.integrate(rho.reshape(-1))
    assert abs(q.sum() - rho.sum()) < 1e-8
    top2 = np.argsort(-q)[:2]
    for b in top2:
        d = res.xattr[b] - c.x_frac
        d -= np.rint(d)
        dc = np.linalg.norm(d @ np.asarray(c.m_x2c).T, axis=1)
        assert dc.min() < 1.0


def test_yt_charges_parity_native():
    """Basin charges vs the exact sequential fractional-weight sweep
    (native C++ of the JAX package): the parity bar is 1e-6 e."""
    from critic2_tpu import native

    if not native.available():
        pytest.skip("native library unavailable")
    c, rho = _problem((12, 10, 8))
    res = tyt.yt_integrate(_port(c), torch.as_tensor(rho))
    q = np.sort(res.integrate(rho.reshape(-1)))
    offs, wts = tyt._grid_ws_neighbors(_port(c), rho.shape)
    _, q_seq = native.yt_charges(rho, offs, wts, rho)
    assert len(q) == len(q_seq)
    assert np.max(np.abs(q - np.sort(q_seq))) < 1e-9


CUBIC = ([8.0, 8.0, 8.0], [90, 90, 90])
TRICLINIC = ([8.0, 7.0, 6.5], [75, 80, 70])
# anthracene's cell (X23, P2_1/a); at 24 x 17 x 32 its grid lattice has
# the 8 neighbours of the benchmark's 384 x 270 x 504
ANTHRACENE = ([15.901, 11.320, 20.967], [90, 125.293, 90])


@pytest.mark.parametrize("cell, shape, axis", [
    (CUBIC, (24, 24, 24), 0),
    # 6 neighbours of 14 step across the planes and within them, along
    # either axis: the tie keeps axis 0
    (TRICLINIC, (14, 12, 10), 0),
    (ANTHRACENE, (24, 17, 32), 1)], ids=["cubic", "triclinic",
                                          "anthracene"])
def test_sweep_axis_follows_the_grid_lattice(cell, shape, axis):
    c, rho = _problem(shape, cell=cell)
    rt = tyt.yt_integrate(_port(c), torch.as_tensor(rho))
    assert tyt._sweep_axis(rt._offs) == axis
    if cell is ANTHRACENE:
        assert sorted(rt._offs) == sorted(
            [(1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 0, 1), (-1, 0, 0),
             (0, -1, 0), (0, 0, -1), (-1, 0, -1)])


@pytest.mark.parametrize("cell", [CUBIC, TRICLINIC, ANTHRACENE],
                         ids=["cubic", "triclinic", "monoclinic"])
@pytest.mark.parametrize("adjoint", [True, False])
def test_kernel_route_matches_jax_xla_sweep(cell, adjoint):
    """_solve_sweep's kernel route (f32 Gauss-Seidel + one f64 refinement
    with the yt_pass residual), run here with the plain kernels along the
    axis yt_integrate picks on the flag-stepped schedule, against the JAX
    package's f64 Jacobi fixpoint; a solve along axis 1 counts one
    yt.off_axis_solves."""
    shape = (24, 17, 32) if cell is ANTHRACENE else (14, 12, 10)
    c, rho = _problem(shape, cell=cell)
    rt = tyt.yt_integrate(_port(c), torch.as_tensor(rho))
    chi, offs = rt._chiP, rt._offs
    axis = tyt._sweep_axis(offs)
    assert axis == (cell is ANTHRACENE)
    if adjoint:
        chi32 = tyt._shifted(chi, offs, torch.float32)
        chiR = tyt._shifted(chi, offs, torch.float64)
    else:
        chi32, chiR = chi.to(torch.float32), chi
    f3 = np.stack([np.ones(shape), rho])
    with trace.recording() as rec:
        s = tyt._solve_sweep(chi, chi32, chiR, torch.as_tensor(f3), offs,
                             adjoint=adjoint, axis=axis)
        # the f64 Jacobi route sweeps along no axis
        tyt._solve_sweep(chi, None, None, torch.as_tensor(f3), offs,
                         adjoint=adjoint, axis=axis)
    counters = rec.read()["counters"]
    assert counters["yt.solves"] == 2
    assert counters.get("yt.off_axis_solves", 0) == axis
    ref = np.asarray(jyt._xla_sweep(jnp.asarray(chi.numpy()),
                                    jnp.asarray(f3), offs=offs,
                                    adjoint=adjoint))
    assert s.dtype == torch.float64
    np.testing.assert_allclose(s.numpy(), ref, rtol=1e-10,
                               atol=1e-10 * np.abs(ref).max())


def _gauss_cell(n, tilt=0.0, clip=None, amp=3.0, alpha=0.9):
    """Two-Gaussian test cell of tests/test_yt.py (optional sub-f32 tilt
    and plateau clip: the adversarial case for the f32 guard)."""
    a = 8.0
    c = Crystal(m_x2c=np.diag([a, a, a]),
                x_frac=np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]),
                species_of=np.array([0, 1]),
                species=[Species("Na", 11), Species("Cl", 17)])
    ii, jj, kk = np.meshgrid(*[np.arange(n) / n] * 3, indexing="ij")
    xf = np.stack([ii, jj, kk], axis=-1)

    def gauss(center):
        d = xf - center
        d -= np.round(d)
        return amp * np.exp(-alpha * ((d * a) ** 2).sum(-1))

    rho = gauss(np.zeros(3)) + gauss(np.full(3, 0.5)) + 1e-3
    if clip is not None:
        rho = np.maximum(rho, clip)
        rho = np.asarray(np.asarray(rho, np.float32), np.float64)
        if tilt:
            rho = rho + tilt * ii
    return c, rho


def test_yt_f32_guard_benign_matches_jax():
    c, rho = _gauss_cell(32, amp=2.0, alpha=0.5)
    dv = c.volume / rho.size
    res, audit = tyt.yt_f32_guarded(_port(c), torch.as_tensor(rho))
    _, ja = jyt.yt_f32_guarded(c, rho)
    assert not audit["tripped"] and not ja["tripped"], (audit, ja)
    assert audit["dtype"] == "f32" and res._chiP.dtype == torch.float32
    assert (audit["nattr32"], audit["nattr64"]) == (ja["nattr32"],
                                                    ja["nattr64"])
    # the estimate is a small difference of two f64 solves on the same
    # f32 partition; the two packages sum in different orders
    assert abs(audit["drift_est_e"] - ja["drift_est_e"]) \
        <= 1e-3 * ja["drift_est_e"] + 1e-14, (audit, ja)
    q32 = np.sort(res.integrate(rho.reshape(-1))) * dv
    q64 = np.sort(tyt.yt_integrate(_port(c), torch.as_tensor(rho))
                  .integrate(rho.reshape(-1))) * dv
    dq = float(np.abs(q32 - q64).max())
    assert dq <= 4.0 * audit["drift_est_e"] + 1e-12, (dq, audit)
    assert dq < 1e-6


def test_yt_f32_guard_trips_adversarial_matches_jax():
    c, rho = _gauss_cell(32, tilt=1e-9, clip=1.0)
    dv = c.volume / rho.size
    res, audit = tyt.yt_f32_guarded(_port(c), torch.as_tensor(rho))
    rj, ja = jyt.yt_f32_guarded(c, rho)
    assert audit["tripped"] and ja["tripped"], (audit, ja)
    assert audit["dtype"] == "f64" and res._chiP.dtype == torch.float64
    assert audit["reason"].split("(")[0] == ja["reason"].split("(")[0]
    assert res.nattr == rj.nattr
    q = np.sort(res.integrate(rho.reshape(-1))) * dv
    qj = np.sort(np.asarray(rj.integrate(jnp.asarray(rho)))) * dv
    np.testing.assert_allclose(q, qj, rtol=0, atol=1e-12)
