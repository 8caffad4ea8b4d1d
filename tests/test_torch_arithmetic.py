"""The port's expression engine (arithmetic.py), ghost fields, Ewald sums
and the drivers that take expressions (intgrid discard= and INTEGRABLE,
expr= of basin_integral / sphere_integral, molcalc expressions) against
the JAX package, on the CPU.

The bars of tests/test_arithmetic.py and tests/test_ewald.py are
repeated on the port, and every evaluation is held against the JAX
package on the same inputs, made from numpy seeds. Ghost-field
derivatives come from torch.autograd: the test checks that they flow
through every field evaluator the port has (promolecular, tricubic,
trispline and tristar grids, the GTO wavefunction) against central
differences of the ghost value and against the JAX package's jvp.
Tolerances are stated per assertion.
"""
import os
import sys
import tempfile

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from critic2_tpu import System as JSystem
from critic2_tpu import arithmetic as jar
from critic2_tpu.analysis import ewald as jew
from critic2_tpu.analysis.bisect import basin_integral as jbasin_integral
from critic2_tpu.analysis.bisect import sphere_integral as jsphere_integral
from critic2_tpu.analysis.integration import _rasterize_field as jraster
from critic2_tpu.analysis.integration import intgrid as jintgrid
from critic2_tpu.analysis.molcalc import molcalc_integral as jmolcalc
from critic2_tpu.crystal.cell import m_x2c_from_cellpar
from critic2_tpu.crystal.crystal import Crystal, Species
from critic2_tpu.fields.field import Field as JField
from critic2_tpu.fields.grid3 import Grid3 as JGrid3
from critic2_tpu_torch import System
from critic2_tpu_torch import arithmetic as tar
from critic2_tpu_torch.analysis import ewald as tew
from critic2_tpu_torch.analysis.bisect import basin_integral, sphere_integral
from critic2_tpu_torch.analysis.integration import intgrid
from critic2_tpu_torch.analysis.molcalc import molcalc_integral
from critic2_tpu_torch.convert import (crystal_from_arrays,
                                       crystal_to_arrays,
                                       system_from_arrays)
from critic2_tpu_torch.fields.field import Field

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_molden import H2_MOLDEN  # noqa: E402

# the inputs are tiny: one intra-op thread a process, so that parallel
# test workers do not fight over the cores
torch.set_num_threads(1)

CPU = "cpu"
CTF = (3.0 / 10.0) * (3.0 * np.pi ** 2) ** (2.0 / 3.0)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _port(c):
    return crystal_from_arrays(**crystal_to_arrays(c))


def _lif():
    return Crystal(m_x2c=m_x2c_from_cellpar([9.0, 9.0, 9.0], [90, 90, 90]),
                   x_frac=np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]),
                   species_of=np.array([0, 1]),
                   species=[Species("Li", 3), Species("F", 9)])


def _nacl2():
    return Crystal(m_x2c=np.diag([6.0, 6.0, 6.0]),
                   x_frac=np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]),
                   species_of=np.array([0, 1]),
                   species=[Species("Na", 11), Species("Cl", 17)])


@pytest.fixture(scope="module")
def lif():
    """(JAX system, port system, 32 seeded Cartesian points), the
    promolecular LiF density as field 0 (tests/test_arithmetic.py)."""
    c = _lif()
    pts = np.random.default_rng(5).random((32, 3)) @ np.asarray(c.m_x2c).T
    return (JSystem.from_structure(c),
            System.from_structure(_port(c), device=CPU), pts)


# ---------------------------------------------------------------------------
# the compiler
# ---------------------------------------------------------------------------
def test_math_and_precedence(lif):
    _, s, pts = lif
    assert float(tar.eval_expr("2^3 + sqrt(16) - abs(-1)", s, pts[:1])[0]) \
        == 11.0
    assert float(tar.eval_expr("min(3, max(1, 2))", s, pts[:1])[0]) == 2.0
    v = tar.eval_expr("atan2(1, 1) * 4", s, pts[:1])
    np.testing.assert_allclose(float(v[0]), np.pi, rtol=1e-12)
    # half to even, as jnp.round
    assert _np(tar.eval_expr("round(2.5) + round(3.5)", s, pts[:1]))[0] \
        == 6.0


MATH_EXPRS = ["exp(-$0) + log($0 + 1) * log10($0 + 2)",
              "sin($0) * cos(2 * $0) - tan($0 / 3) + asin($0 / 1e3)",
              "acos($0 / 1e3) + atan($0) + sinh($0 / 10) + cosh($0 / 10)",
              "erf($0) - erfc($0) + floor(3 * $0) + ceil($0) + ceiling(2)",
              "max($0, 0.01) + min($0, 0.01) + $0 % 0.3 - +$0 * -2",
              "($0 >= 0.01) + ($0 <= 0.01) * 2 + ($0 == $0) + ($0 != 1)",
              "abs($0:x) ^ 1.5 + sqrt($0:g) + pi + e"]


@pytest.mark.parametrize("expr", MATH_EXPRS)
def test_math_functions_match_jax(lif, expr):
    """Every entry of the math table, on the promolecular field at 32
    seeded points, 1e-12 relative to the JAX package."""
    js, s, pts = lif
    np.testing.assert_allclose(_np(tar.eval_expr(expr, s, pts)),
                               np.asarray(jar.eval_expr(expr, js, pts)),
                               rtol=1e-12, atol=1e-300)


MOD_EXPRS = ["$0", "$0:v", "$0:c", "$0:x", "$0:y", "$0:z", "$0:g", "$0:l",
             "$0:xx", "$0:xy", "$0:xz", "$0:yx", "$0:yy", "$0:yz", "$0:zx",
             "$0:zy", "$0:zz", "$0 * 2 + $0:l / 4"]


@pytest.mark.parametrize("expr", MOD_EXPRS)
def test_field_modifiers_match_jax_and_grd(lif, expr):
    """Modifiers against the JAX package (1e-12) and, for the bare field,
    the gradient norm, the Laplacian and a Hessian entry, against the
    port's own grd (tests/test_arithmetic.py:32-45 bars)."""
    js, s, pts = lif
    got = _np(tar.eval_expr(expr, s, pts))
    np.testing.assert_allclose(got, np.asarray(jar.eval_expr(expr, js, pts)),
                               rtol=1e-12, atol=1e-15)
    res = s.ref.grd(pts)
    own = {"$0": res.f, "$0:g": res.gfmod, "$0:l": res.del2f,
           "$0:xy": res.hf[:, 0, 1]}
    if expr in own:
        np.testing.assert_allclose(got, _np(own[expr]), rtol=1e-10)


def test_comparison_and_vars(lif):
    js, s, pts = lif
    s.vars["athr"] = 0.01
    js.vars["athr"] = 0.01
    v = _np(tar.eval_expr("($0 > athr) * $0", s, pts))
    f = _np(s.ref.grd(pts).f)
    np.testing.assert_allclose(v, np.where(f > 0.01, f, 0.0), rtol=1e-12)


CHEM = ["gtf(0)", "vtf(0)", "htf(0)", "gtf_kir(0)", "vtf_kir(0)",
        "htf_kir(0)", "lol_kir(0)", "lag(0)"]


@pytest.mark.parametrize("expr", CHEM)
def test_chemical_functions_of_a_density(lif, expr):
    """The density-only chemical functions against the JAX package
    (1e-12 relative), gtf/vtf/gtf_kir/lag also against their closed
    forms (1e-9, tests/test_arithmetic.py:57-76)."""
    js, s, pts = lif
    got = _np(tar.eval_expr(expr, s, pts))
    np.testing.assert_allclose(got, np.asarray(jar.eval_expr(expr, js, pts)),
                               rtol=1e-12, atol=1e-15)
    res = s.ref.grd(pts)
    f, lap, gm = _np(res.f), _np(res.del2f), _np(res.gfmod)
    gtf = CTF * np.maximum(f, 0) ** (5 / 3)
    closed = {"gtf(0)": gtf, "vtf(0)": 0.25 * lap - 2 * gtf,
              "gtf_kir(0)": gtf + gm ** 2 / (72 * np.maximum(f, 1e-30))
              + lap / 6, "lag(0)": -0.25 * lap}
    if expr in closed:
        np.testing.assert_allclose(got, closed[expr], rtol=1e-9)


@pytest.mark.parametrize("expr, error", [
    ("elf(0)", tar.ExprError),          # promolecular has no k.e.d.
    ("$0:lv", tar.ExprError), ("$0:up", tar.ExprError),
    ("$0:qq", tar.ExprError), ("@nope", tar.ExprError),
    ("mep(0)", tar.ExprError), ("stress(0)", tar.ExprError),
    ("brhole_a(0)", tar.ExprError), ("xc($0)", tar.ExprError),
    ("$7", KeyError)])
def test_refused_expressions(lif, expr, error):
    _, s, pts = lif
    with pytest.raises(error):
        tar.eval_expr(expr, s, pts)


@pytest.mark.parametrize("expr", [
    "__import__('os').system('id')", "[1 for _ in range(3)]",
    "().__class__", "x.y", "lambda: 1", "$0 if 1 else 2", "{1: 2}",
    "open('/etc/passwd')", "(1, 2)", "f'{1}'", "abs(-1)[0]"])
def test_rejects_malicious(lif, expr):
    """tests/test_arithmetic.py:110-126: the AST whitelist refuses
    anything but arithmetic, comparisons and the known calls."""
    _, s, pts = lif
    with pytest.raises(tar.ExprError):
        tar.eval_expr(expr, s, pts)


def test_eval_const_rejects_keywords_and_fields():
    with pytest.raises(tar.ExprError):
        tar.eval_const("abs(x=().__class__.__mro__[1].__subclasses__())")
    with pytest.raises(tar.ExprError):
        tar.eval_const("__import__('os')")
    with pytest.raises(tar.ExprError):
        tar.eval_const("$1 + 1")
    assert abs(tar.eval_const("2^3 + sqrt(4)") - 10.0) < 1e-12
    assert abs(tar.eval_const("a*2", {"a": 3.5}) - 7.0) < 1e-12
    assert tar.eval_const("min(2, 3) * e") == jar.eval_const("min(2, 3) * e")


SVARS = ["dnuc", "xnucx", "ynucx", "znucx", "xnucc", "ynucc", "znucc",
         "xx", "yx", "zx", "xc", "yc", "zc", "xm", "ym", "zm", "xxr", "yxr",
         "zxr", "idnuc", "nidnuc", "rho0nuc", "spcnuc", "zatnuc",
         "dnuc:2", "idnuc:1"]


@pytest.mark.parametrize("var", SVARS)
def test_structural_variables_match_jax(var):
    """Every structural variable on the NaCl pair cell, at two hand
    points and 30 seeded ones, 1e-12 relative to the JAX package."""
    c = _nacl2()
    js = JSystem.from_structure(c)
    s = System.from_structure(_port(c), device=CPU)
    pts = np.vstack([[[1.0, 0.5, 0.3], [3.2, 3.0, 2.8]],
                     np.random.default_rng(8).random((30, 3)) * 6.0])
    np.testing.assert_allclose(_np(s.eval_expr(f"@{var}", pts)),
                               np.asarray(js.eval_expr(f"@{var}", pts)),
                               rtol=1e-12, atol=1e-15)


def test_structural_variables_bars():
    """tests/test_arithmetic.py:129-157 on the port."""
    s = System.from_structure(_port(_nacl2()), device=CPU)
    pts = np.array([[1.0, 0.5, 0.3], [3.2, 3.0, 2.8]])
    d = _np(s.eval_expr("@dnuc", pts))
    np.testing.assert_allclose(d[0], np.linalg.norm(pts[0]), rtol=1e-12)
    np.testing.assert_allclose(d[1], np.linalg.norm(pts[1] - 3.0),
                               rtol=1e-12)
    np.testing.assert_allclose(_np(s.eval_expr("@idnuc", pts)), [1, 2])
    np.testing.assert_allclose(_np(s.eval_expr("@zatnuc", pts)), [11, 17])
    np.testing.assert_allclose(_np(s.eval_expr("@xx", pts)),
                               pts[:, 0] / 6.0)
    rho0 = _np(s.eval_expr("@rho0nuc", pts))
    assert (rho0 > 0).all() and rho0[1] > rho0[0]
    assert np.isfinite(_np(s.eval_expr("@dnuc * $0 + @zatnuc", pts))).all()


# ---------------------------------------------------------------------------
# Ewald
# ---------------------------------------------------------------------------
def _nacl8(a=10.66):
    base = np.array([[0, 0, 0], [0, .5, .5], [.5, 0, .5], [.5, .5, 0]])
    return Crystal(m_x2c=m_x2c_from_cellpar([a, a, a], [90, 90, 90]),
                   x_frac=np.vstack([base, (base + [.5, .5, .5]) % 1]),
                   species_of=np.array([0] * 4 + [1] * 4),
                   species=[Species("Na", 11), Species("Cl", 17)])


def test_madelung_constants():
    """tests/test_ewald.py:21-44 on the port: NaCl 1.747564594633 and
    CsCl 1.762674773071, 1e-8; the energy equals the JAX package's to
    1e-12 Ha."""
    q = np.array([1.0] * 4 + [-1.0] * 4)
    e = tew.ewald_energy(_port(_nacl8()), q, device=CPU)
    assert abs(-e * (10.66 / 2) / 4.0 - 1.747564594633) < 1e-8
    assert abs(e - jew.ewald_energy(_nacl8(), q)) < 1e-12
    a = 7.0
    cscl = Crystal(m_x2c=m_x2c_from_cellpar([a, a, a], [90, 90, 90]),
                   x_frac=np.array([[0, 0, 0], [.5, .5, .5]]),
                   species_of=np.array([0, 1]),
                   species=[Species("Cs", 55), Species("Cl", 17)])
    e = tew.ewald_energy(_port(cscl), np.array([1.0, -1.0]), device=CPU)
    assert abs(-e * a * np.sqrt(3) / 2 - 1.762674773071) < 1e-8


def test_ewald_potential_matches_jax_and_energy():
    """The site potentials give the energy back (1e-8), a point 1e-8
    bohr off a nucleus has the on-site value (1e-5;
    tests/test_ewald.py:47-67), and the potential at 40 seeded points
    equals the JAX package's to 1e-12 absolute."""
    c = _nacl8()
    tc = _port(c)
    q = np.array([1.0] * 4 + [-1.0] * 4)
    e = tew.ewald_energy(tc, q, device=CPU)
    v = _np(tew.ewald_potential(tc, np.asarray(c.x_cart), q, device=CPU))
    assert abs(e - 0.5 * float(q @ v)) < 1e-8
    at = np.asarray(c.x_cart)[0]
    v_on = float(tew.ewald_potential(tc, at[None], q, device=CPU)[0])
    v_off = float(tew.ewald_potential(tc, at[None] + 1e-8, q,
                                      device=CPU)[0])
    assert abs(v_on - v_off) < 1e-5
    pts = np.random.default_rng(6).random((40, 3)) * 10.66
    np.testing.assert_allclose(
        _np(tew.ewald_potential(tc, pts, q, device=CPU)),
        np.asarray(jew.ewald_potential(c, pts, q)), rtol=0, atol=1e-12)


def test_ewald_special_field():
    """$ewald equals ewald_potential with the atomic numbers as charges
    (1e-12 relative, tests/test_arithmetic.py:160-174)."""
    c = _nacl2()
    s = System.from_structure(_port(c), device=CPU)
    pts = np.array([[1.0, 0.5, 0.3], [2.0, 1.0, 0.8]])
    np.testing.assert_allclose(
        _np(s.eval_expr("$ewald", pts)),
        _np(tew.ewald_potential(s.crystal, pts, device=CPU)), rtol=1e-12)
    np.testing.assert_allclose(
        _np(s.eval_expr("$ewald", pts)),
        np.asarray(JSystem.from_structure(c).eval_expr("$ewald", pts)),
        rtol=1e-12)


# ---------------------------------------------------------------------------
# ghost fields
# ---------------------------------------------------------------------------
def _smooth_grid(c, n=12):
    """A smooth periodic density on an n^3 grid: Gaussians at the atoms
    (minimum image), so the interpolants are smooth between nodes."""
    g = np.stack(np.meshgrid(*[np.arange(n) / n] * 3, indexing="ij"), -1)
    rho = np.zeros((n, n, n))
    for site in np.asarray(c.x_frac):
        d = g - site
        d -= np.rint(d)
        dc = d @ np.asarray(c.m_x2c).T
        rho += np.exp(-0.4 * (dc ** 2).sum(-1))
    return rho


def _ghost_pair(kind):
    """(JAX system or None, port system, fid, points) with field `fid`
    of the kind asked for; the ghost 2*$fid is loaded as 'g2' (in the
    JAX system too where there is one: tricubic and wfn)."""
    js = None
    if kind == "wfn":
        p = os.path.join(tempfile.mkdtemp(), "h2.molden")
        with open(p, "w") as fh:
            fh.write(H2_MOLDEN)
        js = JSystem.from_structure(p)
        js.load_field(p)
        s = System.from_structure(p, device=CPU)
        s.load_field(p)
        fid = 1
        pts = np.asarray(s.crystal.x_cart).mean(0) + \
            np.random.default_rng(2).normal(size=(24, 3)) * 0.8
    else:
        c = _lif()
        if kind == "tricubic":
            js = JSystem.from_structure(c)
        if kind == "promol":
            s = System.from_structure(_port(c), device=CPU)
            fid = 0
        else:
            g = _smooth_grid(c)
            s = system_from_arrays(**crystal_to_arrays(c), grid=g,
                                   device=CPU, interp=kind)
            if js is not None:
                js.load_field(JField.from_grid(c, JGrid3(jnp.asarray(g))))
            fid = 1
        # off the grid node planes, where the tricubic second derivative
        # is continuous
        pts = (np.random.default_rng(3).random((24, 3)) * 0.9 + 0.05) \
            @ np.asarray(c.m_x2c).T
    if js is not None:
        js.load_field_expr(f"${fid} * 2", name="g2", ghost=True)
    s.load_field_expr(f"${fid} * 2", name="g2", ghost=True)
    return js, s, fid, pts


@pytest.mark.parametrize("kind", ["promol", "tricubic", "trispline",
                                  "tristar", "wfn"])
def test_ghost_field_autograd(kind):
    """A ghost 2*$f over every evaluator: the value is twice the field's
    (1e-12); the autograd gradient equals central differences of the
    ghost value, and the autograd Hessian central differences of the
    autograd gradient (h = 1e-5, 5e-6 relative,
    tests/test_arithmetic.py:79-97); eval_fn gives grd's numbers. On the
    tricubic grid and the wavefunction the gradient and Hessian also
    equal the JAX package's jvp route (1e-10 relative; its compile time
    keeps the other kinds to the difference checks)."""
    js, s, fid, pts = _ghost_pair(kind)
    g = s.field("g2")
    assert g.type == "ghost" and g.device.type == "cpu"
    res = g.grd(pts)
    res0 = s.field(fid).grd(pts)
    np.testing.assert_allclose(_np(res.f), 2 * _np(res0.f), rtol=1e-12)
    h = 1e-5
    for d in range(3):
        pp, pm = pts.copy(), pts.copy()
        pp[:, d] += h
        pm[:, d] -= h
        fd = (_np(g.grd(pp, nder=0).f) - _np(g.grd(pm, nder=0).f)) / (2 * h)
        np.testing.assert_allclose(_np(res.gf[:, d]), fd, rtol=5e-6,
                                   atol=1e-10)
        fdh = (_np(g.grd(pp, nder=1).gf) - _np(g.grd(pm, nder=1).gf)) \
            / (2 * h)
        np.testing.assert_allclose(_np(res.hf[:, :, d]), fdh, rtol=5e-6,
                                   atol=1e-9)
    if kind in ("tricubic", "wfn"):
        jres = js.field("g2").grd(pts)
        np.testing.assert_allclose(_np(res.gf), np.asarray(jres.gf),
                                   rtol=1e-10, atol=1e-13)
        np.testing.assert_allclose(_np(res.hf), np.asarray(jres.hf),
                                   rtol=1e-10, atol=1e-12)
    f, gf, h6 = g.eval_fn(nder=2)(torch.as_tensor(pts.T))
    np.testing.assert_allclose(_np(gf).T, _np(res.gf), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(_np(h6[3]), _np(res.hf[:, 0, 1]),
                               rtol=1e-12, atol=1e-15)


def test_ghost_of_a_ghost_and_constant_ghost(lif):
    """A ghost over a ghost differentiates through the inner autograd
    (gradient and Laplacian of the outer = 1.5x those of the inner, to
    1e-12 and 1e-9 relative: the nested graph sums in another order); a
    ghost that ignores the points has zero derivatives."""
    _, s, pts = lif
    s.load_field_expr("$0 * 2", name="in2", ghost=True)
    s.load_field_expr("$in2 * 1.5", name="out3", ghost=True)
    s.load_field_expr("3.5", name="const", ghost=True)
    r = s.field("out3").grd(pts)
    r2 = s.field("in2").grd(pts)
    np.testing.assert_allclose(_np(r.gf), 1.5 * _np(r2.gf), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(_np(r.del2f), 1.5 * _np(r2.del2f),
                               rtol=1e-9, atol=1e-15)
    rc = s.field("const").grd(pts)
    assert float(rc.f[0]) == 3.5
    assert not rc.gf.abs().any() and not rc.hf.abs().any()


@pytest.mark.parametrize("expr", ["@dnuc * $0", "$ewald + $0"])
def test_host_evaluated_parts_refuse_a_gradient(lif, expr):
    """Host-evaluated structural variables and $ewald have no
    derivative: a ghost over them evaluates its value but raises
    ExprError for a gradient, as the JAX package does."""
    _, s, pts = lif
    fid = s.load_field_expr(expr, ghost=True)
    assert np.isfinite(_np(s.field(fid).grd(pts, nder=0).f)).all()
    with pytest.raises(tar.ExprError, match="host-evaluated"):
        s.field(fid).grd(pts, nder=1)


def test_load_field_expr_grid_matches_jax(lif):
    """LOAD AS "expr" on a 16^3 grid: node (3,5,7) equals the direct
    Laplacian there (1e-10, tests/test_arithmetic.py:100-107), and the
    whole grid the JAX package's to 1e-12 relative."""
    js, s, _ = lif
    fid = s.load_field_expr("$0:l", name="lap0", shape=(16, 16, 16))
    g = s.field(fid).grid.f
    assert tuple(g.shape) == (16, 16, 16) and g.is_contiguous()
    x = np.asarray(s.crystal.m_x2c) @ np.array([3 / 16, 5 / 16, 7 / 16])
    direct = float(s.field(0).grd(x[None]).del2f[0])
    assert abs(float(g[3, 5, 7]) - direct) < 1e-10
    jfid = js.load_field_expr("$0:l", name="lap0", shape=(16, 16, 16))
    np.testing.assert_allclose(_np(g), np.asarray(js.field(jfid).grid.f),
                               rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------
def _nacl4():
    return Crystal(m_x2c=m_x2c_from_cellpar([10.66] * 3, [90] * 3),
                   x_frac=np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5],
                                    [0.5, 0.5, 0.0], [0.0, 0.0, 0.5]]),
                   species_of=np.array([0, 1, 0, 1]),
                   species=[Species("Na", 11), Species("Cl", 17)])


@pytest.fixture(scope="module")
def nacl16():
    c = _nacl4()
    js = JSystem.from_structure(c)
    g = np.asarray(jraster(js.fields[0], (16, 16, 16)))
    js.load_field(JField.from_grid(c, JGrid3(jnp.asarray(g))))
    s = system_from_arrays(**crystal_to_arrays(c), grid=g, device=CPU)
    return js, s


@pytest.mark.parametrize("method", ["yt", "bader"])
def test_intgrid_integrables_match_jax(nacl16, method):
    """INTEGRABLE "$1 * 2" (tests/test_integration.py:95-101: twice the
    charge, 1e-8), a labelled gtf(1) entry and @xx, equal to the JAX
    package's per row (1e-10 e)."""
    js, s = nacl16
    items = ["$1 * 2", ("gtf(1)", "kinetic"), "@xx"]
    s.integrables[:] = items
    js.integrables[:] = items
    try:
        res = intgrid(s, method=method)
        jres = jintgrid(js, method=method)
    finally:
        s.integrables.clear()
        js.integrables.clear()
    assert len(res.rows) == len(jres.rows) == 4
    for r, jr in zip(res.rows, jres.rows):
        assert abs(r.extra["$1 * 2"] - 2 * r.pop) < 1e-8
        for k in ("$1 * 2", "kinetic", "@xx"):
            assert abs(r.extra[k] - jr.extra[k]) < 1e-10
    assert "$1 * 2" in res.table() and "kinetic" in res.table()


def test_intgrid_discard_matches_jax(nacl16):
    """discard= (tests/test_integration.py:136-142): always false keeps
    every row, rho above 1e-6 at the attractor drops them all, and a
    species condition drops the Cl basins as in the JAX package; the
    kept rows' charges equal the JAX package's (1e-10 e) and the
    discarded attractors map to -1."""
    js, s = nacl16
    full = intgrid(s, method="yt")
    assert len(intgrid(s, method="yt", discard="$1 < 0").rows) == 4
    assert len(intgrid(s, method="yt", discard="$1 > 1e-6").rows) == 0
    res = intgrid(s, method="yt", discard="@zatnuc > 11")
    jres = jintgrid(js, method="yt", discard="@zatnuc > 11")
    assert [r.name for r in res.rows] == [r.name for r in jres.rows] \
        == ["Na", "Na"]
    for r, jr in zip(res.rows, jres.rows):
        assert abs(r.pop - jr.pop) < 1e-10
    assert res.attr_map.count(-1) == 2
    kept = {r.atom: r.pop for r in full.rows}
    assert all(abs(r.pop - kept[r.atom]) < 1e-12 for r in res.rows)


def test_basin_and_sphere_integral_expressions(nacl16, monkeypatch):
    """expr= of basin_integral and sphere_integral: the JAX package's
    numbers (1e-9 relative; the basin over the same given radii, as in
    tests/test_torch_bisect_flux.py, since the two tracers settle r_IAS
    within the bisection tolerance only), and expr='$1' equal to the
    plain field's (exactly: the same points and weights)."""
    from critic2_tpu.analysis import bisect as jbis
    from critic2_tpu_torch.analysis import bisect as tbis
    from critic2_tpu_torch.ops import lebedev as tleb

    js, s = nacl16
    x0 = [0.0, 0.0, 0.0]
    for expr in ("$1", "gtf(1) + @dnuc"):
        v = sphere_integral(s, x0, 1.5, expr=expr, deg=9)
        jv = jsphere_integral(js, x0, 1.5, expr=expr, deg=9)
        np.testing.assert_allclose(v, jv, rtol=1e-9)
    assert sphere_integral(s, x0, 1.5, expr="$1", deg=9) == \
        sphere_integral(s, x0, 1.5, deg=9)
    sph, _ = tleb.lebedev(74)
    r_ias = np.full(len(sph), 2.0) + 0.3 * sph[:, 0]
    monkeypatch.setattr(tbis, "bisect_basin", lambda *a, **k: r_ias)
    monkeypatch.setattr(jbis, "bisect_basin", lambda *a, **k: r_ias)
    kw = dict(level=1, nr=6)
    v = basin_integral(s, x0, expr="$1 * 3", **kw)
    jv = jbasin_integral(js, x0, expr="$1 * 3", **kw)
    np.testing.assert_allclose(v, jv, rtol=1e-9)
    np.testing.assert_allclose(v, 3 * basin_integral(s, x0, **kw),
                               rtol=1e-12)


@pytest.fixture(scope="module")
def h2_systems():
    p = os.path.join(tempfile.mkdtemp(), "h2.molden")
    with open(p, "w") as fh:
        fh.write(H2_MOLDEN)
    js = JSystem.from_structure(p)
    js.load_field(p)
    s = System.from_structure(p, device=CPU)
    s.load_field(p)
    return js, s


# ELF and the BR-hole parameters are ill-conditioned in the far tail of
# the mesh (ratios of cancelling 1e-30-scale terms), so their integrals
# are weighted by the density; they are compared point by point below
MOLCALC = ["xc($1, $1:g, 101) + xc($1, $1:g, 130)", "elf(1) * $1",
           "gkin(1)", "xc($1, $1:g, $1:l, 0.5 * gkin(1), 202)",
           "kkin(1) + vir(1)", "lol(1) * he(1)", "xhcurv(1) + dsigs(1)",
           "stress(1)", "$1:up - $1:dn + $1:sp", "$1 * @xm"]


@pytest.mark.parametrize("expr", MOLCALC)
def test_molcalc_expressions_match_jax(h2_systems, expr):
    """molcalc_integral of an expression over the H2 small Becke mesh
    (f64 weights) equals the JAX package's to 1e-10 relative (absolute
    1e-12 where the integral vanishes)."""
    js, s = h2_systems
    kw = dict(lvl="small", weights_dtype=np.float64)
    v = molcalc_integral(s, expr, **kw)
    jv = jmolcalc(js, expr, **kw)
    assert abs(v - jv) <= 1e-10 * abs(jv) + 1e-12, (v, jv)


@pytest.mark.parametrize("expr", ["mep(1)", "uslater(1)", "nheff(1)",
                                  "xhole(1, 0.1, 0.2, 0.3)",
                                  "brhole_a(1) * brhole_alf(1)",
                                  "brhole_b(1) + elf(1)"])
def test_hole_expressions_match_jax(h2_systems, expr):
    """The one-electron potentials, the holes and ELF as expressions, at
    40 seeded points around the molecule: the JAX package's values to
    1e-10 relative."""
    js, s = h2_systems
    pts = np.asarray(s.crystal.x_cart).mean(0) + \
        np.random.default_rng(12).normal(size=(40, 3))
    np.testing.assert_allclose(_np(s.eval_expr(expr, pts)),
                               np.asarray(js.eval_expr(expr, pts)),
                               rtol=1e-10)


def test_hole_expressions_refuse_a_ghost_gradient(h2_systems):
    """mep builds rinv integrals per point and has no derivative."""
    _, s = h2_systems
    fid = s.load_field_expr("mep(1)", ghost=True)
    pts = np.asarray(s.crystal.x_cart)[:1] + 0.3
    assert np.isfinite(_np(s.field(fid).grd(pts, nder=0).f)).all()
    with pytest.raises(tar.ExprError, match="host-evaluated"):
        s.field(fid).grd(pts, nder=2)
    s.unload_field(fid)


def test_new_fields_of_the_system():
    """vars, pointprops and integrables exist on a fresh System, each its
    own container."""
    a = System.from_structure(_port(_lif()), device=CPU)
    b = System.from_structure(_port(_lif()), device=CPU)
    assert a.vars == {} and a.pointprops == [] and a.integrables == []
    a.integrables.append("$0")
    assert b.integrables == []
    assert isinstance(Field.ghost(a.crystal, lambda x: x[0], device=CPU),
                      Field)
