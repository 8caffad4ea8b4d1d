"""The port's WIEN2k and elk LAPW evaluators against the JAX package.

The synthetic fields of tests/test_wien.py (rho = 2 + cos(q z)) and
tests/test_elk.py (rho = 2 + cos(q x)) go through both packages' readers
and evaluators on the same points; one JAX evaluation at nder=2 per field
feeds every comparison. Tolerances, port against JAX: values 1e-12
relative, gradients 1e-10, Hessians 1e-9 (both modules' own row order
[xx, xy, xz, yy, yz, zz]). At the Field level the port's Hessian must be
the exact one in the package's SYM6 order: -q^2 cos(q z) at hf[2, 2] for
the WIEN2k field (where the JAX package's Field puts it at hf[1, 2]), and
central differences of the port's own gradient for both fields.
"""
import math

import jax
import numpy as np
import pytest
import torch

import test_elk
import test_wien
from critic2_tpu.fields.elk import ElkField as JaxElk
from critic2_tpu.fields.wien import WienField as JaxWien
from critic2_tpu_torch import System
from critic2_tpu_torch.fields.elk import ElkField
from critic2_tpu_torch.fields.wien import WienField

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _no_jax_cache_writes():
    """The JAX package's eager calls here compile a few hundred one-op
    programs; the suite's compile cache stores every compile, and on a
    cold cache writing them costs several times the compiles. This
    module's compiles skip the writes (reads and every check are as
    before)."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    yield
    jax.config.update(key, old)

A0 = test_wien.A0
Q = 2.0 * math.pi / A0


def _points(rng, rmt):
    """Interstitial points, muffin-tin points (away from the nucleus and
    the sphere) and a periodic image, for both fields."""
    inter = rng.uniform(2.5, 5.5, (6, 3))
    u = rng.normal(size=(6, 3))
    u /= np.linalg.norm(u, axis=1)[:, None]
    mt = u * rng.uniform(0.3, 0.85 * rmt, (6, 1))
    far = np.array([[0.5, 0.1, 0.7]]) + np.array([[2 * A0, -A0, 3 * A0]])
    return np.concatenate([inter, mt, far])


@pytest.fixture(scope="module")
def wien(tmp_path_factory):
    d = tmp_path_factory.mktemp("wien")
    test_wien._write_struct(d / "syn.struct")
    test_wien._write_clmsum(d / "syn.clmsum")
    files = (str(d / "syn.clmsum"), str(d / "syn.struct"))
    pts = _points(np.random.default_rng(11), test_wien.RMT)
    jf = JaxWien.from_files(*files)
    ref = [np.asarray(a) for a in jf.grd(pts, nder=2)]
    return {"dir": d, "files": files, "pts": pts, "jax": jf, "ref": ref,
            "port": WienField.from_files(*files, device="cpu")}


@pytest.fixture(scope="module")
def elk(tmp_path_factory):
    d = tmp_path_factory.mktemp("elk")
    test_elk._write_geometry(d / "GEOMETRY.OUT")
    test_elk._write_state(d / "STATE.OUT")
    files = (str(d / "STATE.OUT"), str(d / "GEOMETRY.OUT"))
    pts = _points(np.random.default_rng(12), test_elk.RMT)
    jf = JaxElk.from_files(*files)
    ref = [np.asarray(a) for a in jf.grd(pts, nder=2)]
    return {"dir": d, "files": files, "pts": pts, "jax": jf, "ref": ref,
            "port": ElkField.from_files(*files, device="cpu")}


def _rel(a, b):
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def test_wien_tables_match(wien):
    j, t = wien["jax"], wien["port"]
    np.testing.assert_array_equal(t.krec.numpy(), np.asarray(j.krec))
    np.testing.assert_array_equal(t.a_re.numpy(), np.asarray(j.a_re))
    np.testing.assert_array_equal(t.M.numpy(), np.asarray(j.M))
    for pj, pt in zip(j.mt, t.mt):
        np.testing.assert_array_equal(pt["CRT"].numpy(), np.asarray(pj["CRT"]))
        np.testing.assert_array_equal(pt["A"].numpy(), np.asarray(pj["A"]))
        assert (pt["rnot"], pt["dx"], pt["jri"]) == \
            (pj["rnot"], pj["dx"], pj["jri"])


@pytest.mark.parametrize("kind", ["wien", "elk"])
def test_values_gradients_hessians_match_jax(kind, wien, elk):
    """One port evaluation at nder=2 against the JAX module's, in the
    module's own Hessian row order."""
    fx = wien if kind == "wien" else elk
    f, g, h6 = (a.numpy() for a in fx["port"].grd(fx["pts"], nder=2))
    jf, jg, jh = fx["ref"]
    assert _rel(f, jf) <= 1e-12
    np.testing.assert_allclose(g, jg, rtol=0, atol=1e-10)
    np.testing.assert_allclose(h6, jh, rtol=0, atol=1e-9)
    # lower orders give the same numbers
    f0, g0, h0 = fx["port"].grd(fx["pts"], nder=0)
    assert g0 is None and h0 is None and torch.equal(f0, torch.as_tensor(f))
    f1, g1, h1 = fx["port"].grd(fx["pts"], nder=1)
    assert h1 is None
    np.testing.assert_allclose(g1.numpy(), jg, rtol=0, atol=1e-10)


@pytest.mark.parametrize("kind", ["wien", "elk"])
def test_exact_field_values(kind, wien, elk):
    """The port reproduces the analytic field: exactly in the
    interstitial, to the radial interpolation's 1e-6 inside spheres."""
    fx = wien if kind == "wien" else elk
    pts = fx["pts"]
    f = fx["port"].grd(pts, nder=0)[0].numpy()
    axis = 2 if kind == "wien" else 0
    exact = 2.0 + np.cos(Q * pts[:, axis])
    np.testing.assert_allclose(f[:6], exact[:6], atol=1e-10)
    np.testing.assert_allclose(f[6:], exact[6:], atol=1e-6)


def _system(kind, fx):
    d = fx["dir"]
    if kind == "wien":
        s = System.from_structure(str(d / "syn.struct"), device="cpu")
        s.load_field(str(d / "syn.clmsum"))
    else:
        s = System.from_structure(str(d / "GEOMETRY.OUT"), device="cpu")
        s.load_field(str(d / "STATE.OUT"))
    return s


def _central_hessian(field, x, h=1e-4):
    """(N, 3, 3) central differences of the Field's own gradient."""
    H = np.zeros((len(x), 3, 3))
    for k in range(3):
        e = np.zeros(3)
        e[k] = h
        gp = field.grd(x + e, nder=1).gf.numpy()
        gm = field.grd(x - e, nder=1).gf.numpy()
        H[:, :, k] = (gp - gm) / (2 * h)
    return H


def test_wien_field_hessian_is_exact_in_package_order(wien):
    """The cosine field at Cartesian (4, 4, 3) and beside it: d2rho/dz2 =
    -q^2 cos(q z) sits at hf[2, 2] (the JAX package's Field puts it at
    hf[1, 2] and hf[2, 1] and leaves hf[2, 2] = 0), and the whole Hessian
    equals central differences of the gradient; eval_fn carries the same
    numbers in slots [xx, yy, zz, xy, xz, yz]."""
    s = _system("wien", wien)
    assert s.ref.type == "wien" and s.ref.device.type == "cpu"
    x = np.array([[4.0, 4.0, 3.0], [3.5, 4.5, 2.2], [0.4, 0.3, 0.9]])
    res = s.ref.grd(x, nder=2)
    hf = res.hf.numpy()
    exact = -Q * Q * np.cos(Q * x[:, 2])
    assert abs(hf[0, 2, 2] - exact[0]) < 1e-8
    np.testing.assert_allclose(hf[:2, 2, 2], exact[:2], atol=1e-8)
    np.testing.assert_allclose(hf[:2, :2, :], 0.0, atol=1e-8)
    fd = _central_hessian(s.ref, x)
    np.testing.assert_allclose(hf, fd, rtol=0,
                               atol=1e-6 * np.abs(fd).max())
    f, gf, h6 = s.ref.eval_fn(nder=2)(torch.as_tensor(x.T))
    mat = hf[:, [0, 1, 2, 0, 0, 1], [0, 1, 2, 1, 2, 2]].T
    np.testing.assert_allclose(h6.numpy(), mat, rtol=0, atol=1e-12)
    np.testing.assert_allclose(gf.numpy(), res.gf.numpy().T, atol=1e-14)


def test_elk_field_hessian_matches_differences(elk):
    """Elk twin: d2rho/dx2 = -q^2 cos(q x) at hf[0, 0], zero elsewhere in
    the interstitial, and central differences everywhere."""
    s = _system("elk", elk)
    assert s.ref.type == "elk"
    x = np.array([[4.0, 3.0, 4.5], [3.1, 4.6, 2.7], [0.9, 0.3, 0.2]])
    hf = s.ref.grd(x, nder=2).hf.numpy()
    exact = -Q * Q * np.cos(Q * x[:, 0])
    np.testing.assert_allclose(hf[:2, 0, 0], exact[:2], atol=1e-8)
    np.testing.assert_allclose(hf[:2, 1:, :], 0.0, atol=1e-8)
    fd = _central_hessian(s.ref, x)
    np.testing.assert_allclose(hf, fd, rtol=0,
                               atol=1e-6 * np.abs(fd).max())


def test_wien_nucleus_signal_on_the_diagonal(wien):
    """Within rnot of a nucleus the Hessian diagonal carries -1e15 and
    the gradient is zero, in both the module's and the Field's order."""
    t = wien["port"]
    _, g, h6 = t.grd(np.array([[0.0, 0.0, 1e-6]]), nder=2)
    assert g.abs().max() == 0.0
    assert h6[[0, 3, 5], 0].tolist() == [-1e15] * 3
    assert h6[[1, 2, 4], 0].tolist() == [0.0] * 3
    s = _system("wien", wien)
    hf = s.ref.grd(np.array([[0.0, 0.0, 1e-6]]), nder=2).hf[0].numpy()
    np.testing.assert_array_equal(hf, np.diag([-1e15] * 3))


def test_elk_muffin_tin_branch_matches_jax(elk):
    """The muffin-tin branch alone (its four-node radial gather and the
    solid harmonics) equals the JAX evaluation inside the sphere."""
    t = elk["port"]
    x = torch.as_tensor(elk["pts"][6:12].T)
    iat, d0, r, ins = t._assign(x)
    assert bool(ins.all())
    mt = t._mt(iat, d0, r).numpy()
    np.testing.assert_allclose(mt, elk["ref"][0][6:12], rtol=1e-12)
    assert t.C.shape[2] == test_elk.NR
