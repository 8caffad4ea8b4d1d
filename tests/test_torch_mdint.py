"""The port's molecular integrals (ops/mdint.py), the BR-hole inversions
(ops/brhole.py) and the hole functions of fields/wfn.py against the JAX
package and against exact quadrature, on the CPU.

tests/test_mdint.py and the data legs of tests/test_holefuncs.py skip
here, since they need the reference's fchk/wfx files; their synthetic
cases are repeated on the port: Boys against Gauss-Legendre quadrature,
g and h overlaps against Gauss-Hermite quadrature, the g-shell ERI
symmetry and its (ss|ss) closed form, and the H2 hole fixture. RHF
energies of the H2/STO-3G molden text and of its tiles equal the JAX
package's to 1e-10 Ha. Tolerances are stated per assertion.
"""
import os
import sys
import tempfile

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from critic2_tpu import System as JSystem
from critic2_tpu.fields.wfn import Wavefunction as JWfn
from critic2_tpu.ops import brhole as jbr
from critic2_tpu.ops import mdint as jm
from critic2_tpu_torch import System
from critic2_tpu_torch.analysis.molcalc import molcalc_hf
from critic2_tpu_torch.convert import (wavefunction_from_arrays,
                                       wavefunction_to_arrays)
from critic2_tpu_torch.fields.wfn import _LI, Wavefunction
from critic2_tpu_torch.ops import brhole as tbr
from critic2_tpu_torch.ops import mdint as tm

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_molden import H2_MOLDEN  # noqa: E402

# the inputs are tiny: one intra-op thread a process, so that parallel
# test workers do not fight over the cores
torch.set_num_threads(1)

CPU = "cpu"


def _port(w):
    return wavefunction_from_arrays(**wavefunction_to_arrays(w))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def h2_molden():
    d = tempfile.mkdtemp()
    p = os.path.join(d, "h2.molden")
    with open(p, "w") as fh:
        fh.write(H2_MOLDEN)
    return p


@pytest.fixture(scope="module")
def h2(h2_molden):
    jw = JWfn.read_molden(h2_molden)
    return jw, _port(jw)


# ---------------------------------------------------------------------------
# Boys
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("T", [0.0, 0.3, 2.0, 10.0, 17.9, 18.1, 40.0,
                               300.0])
def test_boys_vs_quadrature_and_jax(T):
    """F_n(T), n = 0..8, against 400-point Gauss-Legendre quadrature to
    1e-13 absolute (tests/test_mdint.py:17) and the JAX package's to
    1e-15 absolute."""
    x, wq = np.polynomial.legendre.leggauss(400)
    t = 0.5 * (x + 1)
    wq = 0.5 * wq
    F = tm.boys(8, torch.tensor([T], dtype=torch.float64))[:, 0].numpy()
    Fj = np.asarray(jm.boys(8, jnp.array([T])))[:, 0]
    for n in range(9):
        ref = float((t ** (2 * n) * np.exp(-T * t * t) * wq).sum())
        assert abs(F[n] - ref) < 1e-13
    np.testing.assert_allclose(F, Fj, rtol=0, atol=1e-15)


# ---------------------------------------------------------------------------
# one-electron integrals at high l
# ---------------------------------------------------------------------------
def _s1d(li, xg, wg, i, j, a, b, A, B, d):
    p = a + b
    mu = (a * A[d] + b * B[d]) / p
    t = mu + xg / np.sqrt(p)
    poly = (t - A[d]) ** li[i][d] * (t - B[d]) ** li[j][d]
    k = np.exp(-a * b / p * (A[d] - B[d]) ** 2)
    return k * poly @ wg / np.sqrt(p)


HIGH_L = {
    # tests/test_mdint.py:74-145 (g) and :182-230 (h)
    "g": (np.array([[0.0, 0.0, 0.0], [0.9, -0.4, 0.7]]),
          np.array([1, 21, 24, 30, 33, 2]), np.array([0, 0, 1, 1, 0, 1]),
          np.array([1.1, 0.8, 0.6, 1.4, 0.9, 1.2]), 40, 1e-12),
    "h": (np.array([[0.0, 0.0, 0.0], [0.8, -0.5, 0.6]]),
          np.array([56, 43, 37, 50, 21, 1]), np.array([0, 0, 1, 1, 0, 1]),
          np.array([1.0, 0.9, 0.7, 1.3, 0.8, 1.1]), 48, 1e-11),
}


@pytest.mark.parametrize("shell", ["g", "h"])
def test_high_l_one_electron_integrals(shell):
    """S against exact Gauss-Hermite quadrature (rtol as in the JAX
    tests), T symmetric with a positive diagonal, V of a far nucleus at
    the monopole limit (atol 2e-5), and S, T, V equal to the JAX
    package's to 1e-12 relative."""
    atpos, ityp, icen, alph, nq, rtol = HIGH_L[shell]
    kw = dict(atpos=atpos, icenter=icen, itype=ityp, e=alph,
              cmo=np.ones((1, len(ityp))), occ=np.array([2.0]),
              atz=np.array([6, 6]))
    w = Wavefunction(**kw)
    S, T, V = (m.numpy() for m in tm.overlap_kinetic_nuclear(w, device=CPU))
    li = _LI[ityp - 1]
    xg, wg = np.polynomial.hermite.hermgauss(nq)
    for i in range(len(ityp)):
        for j in range(len(ityp)):
            A, B = atpos[icen[i]], atpos[icen[j]]
            s_ref = np.prod([_s1d(li, xg, wg, i, j, alph[i], alph[j], A, B,
                                  d) for d in range(3)])
            np.testing.assert_allclose(S[i, j], s_ref, rtol=rtol,
                                       atol=1e-14)
    assert np.allclose(T, T.T, atol=1e-12) and (np.diag(T) > 0).all()
    Sj, Tj, Vj = (np.asarray(m) for m in
                  jm.overlap_kinetic_nuclear(JWfn(**kw)))
    for a, b in ((S, Sj), (T, Tj), (V, Vj)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-14)
    far = dict(kw, atpos=np.vstack([atpos, [[500.0, 0.0, 0.0]]]),
               atz=np.array([0, 0, 1]))
    _, _, V_far = tm.overlap_kinetic_nuclear(Wavefunction(**far),
                                             device=CPU)
    np.testing.assert_allclose(V_far.numpy(), -S / 500.0, atol=2e-5)


def test_g_shell_eri_symmetry_and_closed_form():
    """tests/test_mdint.py:148-179 on the port: (pq|rs) = (rs|pq) to
    1e-10, a positive diagonal, and (ss|ss) = 2 pi^(5/2) / (p q
    sqrt(p+q)) to 1e-12 relative."""
    atpos = np.array([[0.0, 0.0, 0.0], [1.0, 0.2, -0.3]])
    alph = np.array([1.0, 0.7, 1.3])
    w = Wavefunction(atpos=atpos, atz=np.array([2, 2]),
                     icenter=np.array([0, 1, 0]),
                     itype=np.array([1, 21, 30]), e=alph,
                     cmo=np.ones((1, 3)), occ=np.array([2.0]))
    M = tm.eri_matrix(w, device=CPU).numpy()
    iu, ju = np.triu_indices(3)
    np.testing.assert_allclose(M, M.T, rtol=1e-10, atol=1e-12)
    assert (np.diag(M) > 0).all()
    k = int(np.flatnonzero((iu == 0) & (ju == 0))[0])
    pp = 2.0 * alph[0]
    ref = 2.0 * np.pi ** 2.5 / (pp * pp * np.sqrt(pp + pp))
    np.testing.assert_allclose(M[k, k], ref, rtol=1e-12)


def _mixed_wfn(cls):
    """Two centres, s and p primitives (the unrolled block; the JAX
    package compiles its unrolled block slowly beyond l = 1)."""
    return cls(atpos=np.array([[0.0, 0.0, 0.0], [1.1, -0.4, 0.5]]),
               atz=np.array([3, 2]), icenter=np.array([0, 0, 1, 1, 0]),
               itype=np.array([1, 3, 2, 4, 1]),
               e=np.array([1.3, 0.6, 0.9, 0.5, 1.7]),
               cmo=np.ones((1, 5)), occ=np.array([2.0]))


def test_eri_matches_jax_and_the_gathered_block():
    """eri_matrix on s/p primitives equals the JAX package's to 1e-12
    relative, and the gathered block (the route above l = 4) computes
    the same matrix as the unrolled one to 1e-12."""
    tw = _mixed_wfn(Wavefunction)
    M = tm.eri_matrix(tw, device=CPU).numpy()
    Mj = np.asarray(jm.eri_matrix(_mixed_wfn(JWfn)))
    np.testing.assert_allclose(M, Mj, rtol=1e-12, atol=1e-14)
    iu, ju, p, Ppos, om, comps, _ = tm._pair_data(tw, torch.device(CPU))
    gathered = tm._make_eri_block_gather(comps)(p, Ppos, om, p, Ppos, om)
    np.testing.assert_allclose(gathered.numpy(), M, rtol=1e-12,
                               atol=1e-14)


# ---------------------------------------------------------------------------
# RHF energies
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reps", [None, (2, 1, 1)], ids=["h2", "tile2"])
def test_rhf_energy_matches_jax(h2, reps):
    """E_total and every part within 1e-10 Ha of the JAX package's, on
    the H2/STO-3G molden text and on its 2x1x1 tile."""
    jw, tw = h2
    if reps is not None:
        jw, tw = jw.tile(reps), tw.tile(reps)
    ej = jm.rhf_energy(jw)
    et = tm.rhf_energy(tw, device=CPU)
    for k in ("E_total", "E1", "E_J", "E_K", "E_nn"):
        assert abs(et[k] - ej[k]) < 1e-10, (k, et[k], ej[k])
    assert -1.2 < et["E_total"] / tw.nelec * 2 < -1.0


def test_rhf_energy_uhf_matches_jax(h2):
    """The UHF branch (alpha MOs first, same-spin exchange) on H2 with
    one alpha and one beta orbital, within 1e-10 Ha of the JAX
    package's; for a closed shell it equals the RHF energy (1e-10)."""
    jw, _ = h2
    arr = wavefunction_to_arrays(jw)
    arr.update(cmo=np.vstack([arr["cmo"], arr["cmo"]]),
               occ=np.array([1.0, 1.0]), wfntyp="uhf", nalpha=1)
    tu = wavefunction_from_arrays(**arr)
    ju = JWfn(**{k: arr[k] for k in ("atpos", "atz", "icenter", "itype",
                                     "e", "cmo", "occ", "wfntyp",
                                     "nalpha")})
    et = tm.rhf_energy(tu, device=CPU)
    ej = jm.rhf_energy(ju)
    assert abs(et["E_total"] - ej["E_total"]) < 1e-10
    assert abs(et["E_total"] - jm.rhf_energy(jw)["E_total"]) < 1e-10


def test_molcalc_hf_runs_on_the_system_device(h2_molden):
    """molcalc_hf on a molden system equals rhf_energy of its
    wavefunction (exactly: the same route) and the JAX molcalc_hf to
    1e-10 Ha."""
    from critic2_tpu.analysis.molcalc import molcalc_hf as jmolcalc_hf

    s = System.from_structure(h2_molden, device=CPU)
    s.load_field(h2_molden)
    js = JSystem.from_structure(h2_molden)
    js.load_field(h2_molden)
    e = molcalc_hf(s)
    assert e == tm.rhf_energy(s.ref.wfn, block=96, device=CPU)
    assert abs(e["E_total"] - jmolcalc_hf(js)["E_total"]) < 1e-10


# ---------------------------------------------------------------------------
# rinv integrals, BR-hole inversions and the hole functions
# ---------------------------------------------------------------------------
def _hole_fixture(cls):
    """tests/test_holefuncs.py:16-31: H2-like, one doubly occupied MO of
    two s gaussians per atom, normalized with the package's own S."""
    w = cls(atpos=np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 1.4]]),
            atz=np.array([1, 1]), icenter=np.array([0, 0, 1, 1]),
            itype=np.ones(4, dtype=int), e=np.array([1.2, 0.3, 1.2, 0.3]),
            cmo=np.array([[0.6, 0.4, 0.6, 0.4]]), occ=np.array([2.0]),
            wfntyp="rhf")
    return w


@pytest.fixture(scope="module")
def holes():
    """The fixture normalized with the port's S (equal to the JAX
    package's to 1e-12, test_high_l_one_electron_integrals), both
    packages then holding the same coefficients."""
    jw = _hole_fixture(JWfn)
    S, _, _ = tm.overlap_kinetic_nuclear(_port(jw), device=CPU)
    jw.cmo = jw.cmo / np.sqrt(float(jw.cmo[0] @ S.numpy() @ jw.cmo[0]))
    jw._dev.clear()
    return jw, _port(jw)


def test_rinv_pairs_matches_jax(holes):
    """(B, P, P) rinv integrals at 24 seeded points (three chunks of 8),
    1e-12 relative; a ragged tail of 5 points gives the same numbers as
    whole chunks (exactly)."""
    jw, tw = holes
    pts = np.random.default_rng(3).normal(size=(24, 3))
    got = tm.rinv_pairs(tw, pts, device=CPU)
    assert tuple(got.shape) == (24, 4, 4)
    assert torch.equal(tm.rinv_pairs(tw, pts[:21], device=CPU), got[:21])
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jm.rinv_pairs(jw, pts)), rtol=1e-12, atol=1e-15)


def test_hole_functions_match_jax(holes):
    """mep, uslater (with nheff) and xhole at 64 seeded points equal the
    JAX package's to 1e-10 relative."""
    jw, tw = holes
    pts = np.random.default_rng(4).normal(size=(64, 3)) + [0, 0, 0.7]
    np.testing.assert_allclose(_np(tw.mep(pts, device=CPU)),
                               np.asarray(jw.mep(pts)), rtol=1e-10)
    ux, nh = tw.uslater(pts, want_nheff=True, device=CPU)
    uxj, nhj = jw.uslater(pts, want_nheff=True)
    np.testing.assert_allclose(_np(ux), np.asarray(uxj), rtol=1e-10)
    np.testing.assert_allclose(_np(nh), np.asarray(nhj), rtol=1e-10)
    xr = np.array([0.1, 0.0, 0.6])
    np.testing.assert_allclose(_np(tw.xhole(pts, xr, device=CPU)),
                               np.asarray(jw.xhole(pts, xr)), rtol=1e-10)


def test_hole_function_anchors(holes):
    """tests/test_holefuncs.py:34-68 on the port: the MEP is ~0 far
    away (1e-3) and large near a nucleus; U_x = -V_el/4 for one doubly
    occupied MO (1e-10); the exchange hole at its reference point is
    -rho/2 (1e-10); 0 < nheff <= 2."""
    _, w = holes
    assert abs(float(w.mep(np.array([[25.0, 0.0, 0.7]]), device=CPU)[0])) \
        < 1e-3
    assert float(w.mep(w.atpos[0:1] + [0.02, 0, 0], device=CPU)[0]) > 10.0
    pts = np.array([[0.3, 0.2, 0.5], [1.0, -0.4, 1.1]])
    D = torch.as_tensor((w.cmo.T * w.occ) @ w.cmo)
    vel = torch.einsum("bmn,mn->b", tm.rinv_pairs(w, pts, device=CPU), D)
    np.testing.assert_allclose(_np(w.uslater(pts, device=CPU)),
                               -vel.numpy() / 4.0, rtol=1e-10)
    p = np.array([[0.1, 0.0, 0.6]])
    rho = w.rho_eval_soa(p.T, nder=0, device=CPU)[0]
    np.testing.assert_allclose(_np(w.xhole(p, p[0], device=CPU)),
                               -0.5 * rho.numpy(), rtol=1e-10)
    _, nh = w.uslater(np.array([[0.2, 0.1, 0.7]]), want_nheff=True,
                      device=CPU)
    assert 0.0 < float(nh[0]) <= 2.0


def test_bhole_and_xlnorm_match_jax():
    """bhole (tests/test_holefuncs.py:71-85: 8 pi A / alf^3 = 1 and the
    transcendental equation, 1e-8) and xlnorm on 200 seeded points of
    either curvature sign, both equal to the JAX package's to 1e-11
    relative."""
    rng = np.random.default_rng(9)
    rho = 10.0 ** rng.uniform(-4, 0.5, 200)
    quad = rng.normal(size=200) * rho
    b, alf, a = tbr.bhole(torch.as_tensor(rho), torch.as_tensor(quad), 1.0)
    bj, alfj, aj = jbr.bhole(jnp.asarray(rho), jnp.asarray(quad), 1.0)
    for x, y in ((b, bj), (alf, alfj), (a, aj)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-11)
    np.testing.assert_allclose(8.0 * np.pi * a.numpy() / alf.numpy() ** 3,
                               1.0, rtol=1e-8)
    x = (b * alf).numpy()
    rhs = (2.0 / 3.0) * (np.pi * rho) ** (2.0 / 3.0) * rho / quad
    np.testing.assert_allclose(x * np.exp(-2.0 * x / 3.0) / (x - 2.0), rhs,
                               rtol=1e-8)
    ux = -np.abs(rng.normal(size=200)) - 0.1
    quad2 = np.abs(quad) + 1e-3
    got = tbr.xlnorm(torch.as_tensor(rho), torch.as_tensor(quad2),
                     torch.as_tensor(ux))
    ref = jbr.xlnorm(jnp.asarray(rho), jnp.asarray(quad2), jnp.asarray(ux))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-11)
