"""The port's molecular-wavefunction path (fields/wfn.py, the wfn field,
molcalc, the screened Newton and tracer) against the JAX package, on the
CPU.

Inputs are written here: H2/STO-3G as molden (the text of
tests/test_molden.py), the same primitives as .wfn and .wfx texts (the
.wfx with a synthetic EDF core block), an .fchk with an SP and a
spherical-d shell, and the spherical-g Ne molden. Tolerances are stated
per assertion.
"""
import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from critic2_tpu import System as JSystem
from critic2_tpu.analysis.autocp import autocp as jautocp
from critic2_tpu.analysis.autocp import makegraph as jmakegraph
from critic2_tpu.analysis.molcalc import molcalc_integral as jmolcalc
from critic2_tpu.analysis.molcalc import molcalc_nelec as jnelec
from critic2_tpu.fields.wfn import Wavefunction as JWfn
from critic2_tpu.ops import ode as jode
from critic2_tpu_torch import System
from critic2_tpu_torch.analysis import molcalc
from critic2_tpu_torch.analysis.autocp import autocp, makegraph
from critic2_tpu_torch.convert import (cplist_to_arrays, crystal_to_arrays,
                                       wavefunction_from_arrays,
                                       wavefunction_to_arrays)
from critic2_tpu_torch.fields.wfn import Wavefunction
from critic2_tpu_torch.ops import ode as tode

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_molden import H2_MOLDEN, NE_G_MOLDEN  # noqa: E402
from test_torch_ode import _same_takeoff_sign  # noqa: E402

# the inputs are tiny: one intra-op thread a process, so that parallel
# test workers do not fight over the cores
torch.set_num_threads(1)

CPU = "cpu"
ARRAYS = ("atpos", "atz", "icenter", "itype", "e", "cmo", "occ")


def _h2_primitives():
    """(atpos, icenter 1-based, exponents, cmo row) of the H2 molden."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "h2.molden")
        with open(p, "w") as fh:
            fh.write(H2_MOLDEN)
        w = JWfn.read_molden(p)
    return w.atpos, w.icenter + 1, w.e, w.cmo[0]


def _fmt(v):
    return f"{v: .10E}".replace("E", "D")


def _h2_wfn_text():
    atpos, ic, e, c = _h2_primitives()
    lines = ["H2 STO-3G",
             f"GAUSSIAN              1 MOL ORBITALS    {len(e)} PRIMITIVES"
             f"        {len(atpos)} NUCLEI"]
    for i, x in enumerate(atpos, 1):
        lines.append(f"  H    {i}    (CENTRE  {i})  {x[0]:12.8f}"
                     f"{x[1]:12.8f}{x[2]:12.8f}  CHARGE =  1.0")
    lines.append("CENTRE ASSIGNMENTS  " + "".join(f"{v:3d}" for v in ic))
    lines.append("TYPE ASSIGNMENTS    " + "".join("  1" for _ in ic))
    lines.append("EXPONENTS " + " ".join(_fmt(v) for v in e[:5]))
    lines.append("EXPONENTS " + " ".join(_fmt(v) for v in e[5:]))
    lines.append("MO    1     MO 0.0        OCC NO =    2.0000000  "
                 "ORB. ENERGY =   -0.578000")
    lines.append(" ".join(_fmt(v) for v in c[:5]))
    lines.append(" ".join(_fmt(v) for v in c[5:]))
    lines.append("END DATA")
    return "\n".join(lines) + "\n"


def _h2_wfx_text():
    """The H2 primitives as .wfx, with a synthetic EDF core block (two
    primitives: an s and a p_x, raw coefficients)."""
    atpos, ic, e, c = _h2_primitives()

    def tag(name, body):
        return f"<{name}>\n{body}\n</{name}>"

    return "\n".join([
        tag("Number of Nuclei", "2"),
        tag("Atomic Numbers", "1\n1"),
        tag("Nuclear Cartesian Coordinates",
            "\n".join(" ".join(f"{v:.12E}" for v in x) for x in atpos)),
        tag("Primitive Centers", " ".join(str(v) for v in ic)),
        tag("Primitive Types", " ".join("1" for _ in ic)),
        tag("Primitive Exponents", " ".join(f"{v:.12E}" for v in e)),
        tag("Molecular Orbital Occupation Numbers", "2.0"),
        tag("Molecular Orbital Primitive Coefficients",
            "<MO Number>\n1\n</MO Number>\n"
            + " ".join(f"{v:.14E}" for v in c)),
        tag("EDF Primitive Centers", "1 2"),
        tag("EDF Primitive Types", "1 2"),
        tag("EDF Primitive Exponents", "2.5 1.3"),
        tag("EDF Primitive Coefficients", "0.3 0.05"),
    ]) + "\n"


def _fchk_line(name, typ, val=None, arr=None):
    if arr is None:
        return [f"{name:<43}{typ}{val:17d}"]
    out = [f"{name:<43}{typ}   N={len(arr):12d}"]
    per = 5 if typ == "R" else 6
    for lo in range(0, len(arr), per):
        row = arr[lo:lo + per]
        out.append("".join(f"{v:16.8E}" if typ == "R" else f"{v:12d}"
                           for v in row))
    return out


def _h2_fchk_text():
    """H2/STO-3G s shells plus an SP shell on atom 1 and a spherical d
    (5D) shell on atom 2, one occupied MO and one virtual."""
    s_e = [3.42525091, 0.62391373, 0.16885540]
    s_c = [0.15432897, 0.53532814, 0.44463454]
    nbas = 1 + 1 + 4 + 5
    mo_occ = [0.54893404, 0.54893404, 0.05, 0.02, -0.03, 0.04,
              0.01, -0.02, 0.03, 0.015, -0.01]
    mo_vir = [1.21146407, -1.21146407] + [0.0] * 9
    lines = ["H2 test", "SP        RHF                                  "
             "STO-3G"]
    lines += _fchk_line("Number of atoms", "I", 2)
    lines += _fchk_line("Number of electrons", "I", 2)
    lines += _fchk_line("Number of alpha electrons", "I", 1)
    lines += _fchk_line("Number of beta electrons", "I", 1)
    lines += _fchk_line("Number of basis functions", "I", nbas)
    lines += _fchk_line("Atomic numbers", "I", arr=[1, 1])
    lines += _fchk_line("Current cartesian coordinates", "R",
                        arr=[0.0, 0.0, 0.0, 0.0, 0.0, 1.4])
    lines += _fchk_line("Shell types", "I", arr=[0, 0, -1, -2])
    lines += _fchk_line("Number of primitives per shell", "I",
                        arr=[3, 3, 1, 1])
    lines += _fchk_line("Shell to atom map", "I", arr=[1, 2, 1, 2])
    lines += _fchk_line("Primitive exponents", "R",
                        arr=s_e + s_e + [0.8, 1.1])
    lines += _fchk_line("Contraction coefficients", "R",
                        arr=s_c + s_c + [1.0, 1.0])
    lines += _fchk_line("P(S=P) Contraction coefficients", "R",
                        arr=[0.0] * 6 + [1.0, 0.0])
    lines += _fchk_line("Alpha Orbital Energies", "R", arr=[-0.578, 0.671])
    lines += _fchk_line("Alpha MO coefficients", "R", arr=mo_occ + mo_vir)
    return "\n".join(lines) + "\n"


TEXTS = {"wfn": _h2_wfn_text, "wfx": _h2_wfx_text, "fchk": _h2_fchk_text,
         "molden": lambda: H2_MOLDEN}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("wfn")
    out = {}
    for ext, text in list(TEXTS.items()) + [("ne.molden",
                                             lambda: NE_G_MOLDEN)]:
        p = d / (f"h2.{ext}" if "." not in ext else ext)
        p.write_text(text())
        out[ext] = str(p)
    return out


def _pair(path):
    return JWfn.from_file(path), Wavefunction.from_file(path)


def _points(n=200, seed=0, scale=1.5, center=(0.0, 0.0, 0.7)):
    return np.random.default_rng(seed).normal(0.0, scale, (n, 3)) \
        + np.asarray(center)


@pytest.mark.parametrize("fmt", ["wfn", "wfx", "fchk", "molden",
                                 "ne.molden"])
def test_reader_arrays_equal_jax(files, fmt):
    jw, tw = _pair(files[fmt])
    for k in ARRAYS + ("edf_icenter", "edf_itype", "edf_e", "edf_c"):
        a, b = getattr(jw, k), getattr(tw, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=k)
    assert (jw.wfntyp, jw.nalpha, jw.nmo, jw.npri, jw.nelec) == \
        (tw.wfntyp, tw.nalpha, tw.nmo, tw.npri, tw.nelec)
    if fmt in ("wfn", "wfx"):
        # the same primitives as the molden file, written out with 11
        # significant digits
        _, ref = _pair(files["molden"])
        np.testing.assert_allclose(tw.cmo, ref.cmo, rtol=1e-10)


def _eval_both(jw, tw, pts, nder, dtype=None):
    jo = jw.rho_eval_soa(jnp.asarray(pts.T), nder=nder,
                         dtype=None if dtype is None else jnp.float32)
    to = tw.rho_eval_soa(pts.T, nder=nder, dtype=dtype, device=CPU)
    return [np.asarray(v) for v in jo], [v.numpy() for v in to]


@pytest.mark.parametrize("fmt", ["fchk", "ne.molden", "wfx"])
@pytest.mark.parametrize("nder", [0, 1, 2])
def test_dense_evaluator_matches_jax(files, fmt, nder):
    """rho to 1e-13 relative, gradient and Hessian to 1e-11 absolute
    (s, p, spherical d, spherical g and an EDF core block between
    them)."""
    jw, tw = _pair(files[fmt])
    (jf, jg, jh), (tf, tg, th) = _eval_both(jw, tw, _points(), nder)
    assert np.abs(tf - jf).max() <= 1e-13 * np.abs(jf).max()
    np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-11)
    np.testing.assert_allclose(th, jh, rtol=0, atol=1e-11)
    if nder == 0:
        assert not tg.any() and not th.any()


def test_extras_match_jax(files):
    """gkin, vir, stress6 with rho, grad and h6: 1e-11 absolute."""
    jw, tw = _pair(files["fchk"])
    pts = _points(64, seed=1)
    je = jw.extras_soa(jnp.asarray(pts.T))
    te = tw.extras_soa(pts.T, device=CPU)
    assert set(je) == set(te)
    for k in je:
        np.testing.assert_allclose(te[k].numpy(), np.asarray(je[k]),
                                   rtol=0, atol=1e-11, err_msg=k)


def test_edf_core_density_is_exact(files):
    """The EDF block of the .wfx adds c x^l e^{-a r^2} with analytic
    derivatives: the port's rho minus the same wavefunction without EDF
    equals the closed form (1e-13 absolute)."""
    _, tw = _pair(files["wfx"])
    bare = wavefunction_from_arrays(**{
        **wavefunction_to_arrays(tw), "edf_icenter": None,
        "edf_itype": None, "edf_e": None, "edf_c": None})
    pts = _points(32, seed=2)
    f1, g1, _ = tw.rho_eval_soa(pts.T, nder=1, device=CPU)
    f0, g0, _ = bare.rho_eval_soa(pts.T, nder=1, device=CPU)
    d0 = pts - tw.atpos[0]
    d1 = pts - tw.atpos[1]
    ref = 0.3 * np.exp(-2.5 * (d0 ** 2).sum(1)) \
        + 0.05 * d1[:, 0] * np.exp(-1.3 * (d1 ** 2).sum(1))
    np.testing.assert_allclose((f1 - f0).numpy(), ref, rtol=0, atol=1e-13)
    gx = -2 * 2.5 * d0[:, 0] * 0.3 * np.exp(-2.5 * (d0 ** 2).sum(1)) \
        + 0.05 * (1 - 2 * 1.3 * d1[:, 0] ** 2) \
        * np.exp(-1.3 * (d1 ** 2).sum(1))
    np.testing.assert_allclose((g1 - g0)[0].numpy(), gx, rtol=0,
                               atol=1e-13)


def test_f32_route_within_jax_f32_error(files):
    """The f32 route (f64 displacements, f32 stage, f64 accumulation):
    its error against f64 stays within 4x the JAX f32 route's own error
    plus 1e-7 relative, and the outputs are float64."""
    jw, tw = _pair(files["fchk"])
    pts = _points(256, seed=3)
    (jf32, _, _), (tf32, tg32, _) = _eval_both(jw, tw, pts, 2,
                                               dtype=torch.float32)
    (jf, _, _), (tf, _, _) = _eval_both(jw, tw, pts, 2)
    scale = np.abs(jf).max()
    err_j = np.abs(jf32 - jf).max() / scale
    err_t = np.abs(tf32 - tf).max() / scale
    assert tf32.dtype == np.float64 and tg32.dtype == np.float64
    assert 0.0 < err_t <= 4 * err_j + 1e-7, (err_t, err_j)


@pytest.fixture(scope="module")
def tile4(files):
    jw = JWfn.from_file(files["molden"]).tile((2, 2, 1))
    tw = wavefunction_from_arrays(**wavefunction_to_arrays(jw))
    return jw, tw


def test_tile_and_convert_match_jax(files, tile4):
    jw, tw = tile4
    tt = Wavefunction.from_file(files["molden"]).tile((2, 2, 1))
    for k in ARRAYS:
        np.testing.assert_array_equal(getattr(tt, k), getattr(jw, k))
        np.testing.assert_array_equal(getattr(tw, k), getattr(jw, k))
    assert tt.nelec == 4 * 2.0 and tt.source.endswith("[tiled (2, 2, 1)]")


def test_screened_evaluator_matches_jax_and_dense(tile4):
    """A 4-copy tile (24 primitives) through the screened evaluator,
    called directly below SCREEN_NPRI: equal to the JAX package's
    screened sweep and to the port's dense route (rho 1e-13 relative,
    derivatives 1e-11), with several chunks in one batched call."""
    jw, tw = tile4
    pts = np.random.default_rng(4).uniform(-3.0, 9.0, (1500, 3))
    jo = [np.asarray(v) for v in jw.rho_eval_screened(jnp.asarray(pts.T),
                                                      nder=2, n_chunk=256)]
    to = [v.numpy() for v in tw.rho_eval_screened(pts.T, nder=2,
                                                  n_chunk=256, device=CPU)]
    do = [v.numpy() for v in tw.rho_eval_dense(pts.T, nder=2, device=CPU)]
    for ref in (jo, do):
        assert np.abs(to[0] - ref[0]).max() <= 1e-13 * np.abs(ref[0]).max()
        np.testing.assert_allclose(to[1], ref[1], rtol=0, atol=1e-11)
        np.testing.assert_allclose(to[2], ref[2], rtol=0, atol=1e-11)
    # the plan is the JAX package's
    jp = jw.screen_plan(pts, n_chunk=256)
    tp = tw.screen_plan(pts, n_chunk=256)
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_molden_systems_and_nelec_match_jax(files):
    """System.from_structure on a .molden + load_field: the molecular cell
    equals the JAX package's; NELEC over the Becke mesh with f64 weights
    equals JAX's to 1e-10 e; molcalc_nelec's default f32 weights to 1e-8
    e (the two packages round f32 weights apart)."""
    p = files["molden"]
    js = JSystem.from_structure(p)
    js.load_field(p)
    ts = System.from_structure(p, device=CPU)
    ts.load_field(p)
    ja, ta = crystal_to_arrays(js.crystal), crystal_to_arrays(ts.crystal)
    for k in ("m_x2c", "x_frac", "molx0", "molborder"):
        np.testing.assert_allclose(ta[k], ja[k], rtol=0, atol=1e-14)
    assert ts.ref.type == "wfn" and ts.iref == 1
    np.testing.assert_allclose(ts.ref.wfn.atpos, js.ref.wfn.atpos,
                               rtol=0, atol=1e-14)
    a = jmolcalc(js, "$1", lvl="small", weights_dtype=np.float64)
    b = molcalc.molcalc_integral(ts, "$1", lvl="small",
                                 weights_dtype=np.float64)
    assert abs(a - b) < 1e-10 and abs(b - 2.0) < 1e-5
    assert abs(jnelec(js, lvl="small")
               - molcalc.molcalc_nelec(ts, lvl="small")) < 1e-8


def test_peach_matches_jax(files):
    p = files["fchk"]
    js = JSystem.from_structure(p)
    js.load_field(p)
    ts = System.from_structure(p, device=CPU)
    ts.load_field(p)
    from critic2_tpu.analysis.molcalc import molcalc_peach as jpeach

    a = jpeach(js, [(1, 1, 1.0)], lvl="small")
    b = molcalc.molcalc_peach(ts, [(1, 1, 1.0)], lvl="small")
    assert abs(a - b) < 1e-10


def test_autocp_and_makegraph_on_h2_match_jax(files):
    """The dense route on the H2 monomer: CP list within 1e-9 bohr, the
    bond path's two ends equal after aligning take-off signs, path
    lengths within 1e-8 relative."""
    p = files["molden"]
    js = JSystem.from_structure(p)
    js.load_field(p)
    ts = System.from_structure(p, device=CPU)
    ts.load_field(p)
    jc, tc = jautocp(js), autocp(ts)
    assert jc.counts() == tc.counts() == (2, 1, 0, 0)
    ja, ta = cplist_to_arrays(jc), cplist_to_arrays(tc)
    np.testing.assert_array_equal(ta["typ"], ja["typ"])
    np.testing.assert_allclose(ta["r"], ja["r"], rtol=0, atol=1e-9)
    jmakegraph(js, jc)
    makegraph(ts, tc)
    ja, ta = cplist_to_arrays(jc), cplist_to_arrays(tc)
    ta = _same_takeoff_sign(ta, ja)
    np.testing.assert_array_equal(ta["ipath"], ja["ipath"])
    assert sorted(ta["ipath"][ja["typ"] == -1][0]) == [0, 1]
    np.testing.assert_allclose(ta["brpathlen"], ja["brpathlen"], rtol=1e-8)


@pytest.fixture(scope="module")
def screened_pair(tile4):
    """Both packages' systems on the 4-copy tile, with SCREEN_NPRI
    lowered on the two instances so the screened Newton and tracer run;
    the JAX package's CP list and graph computed once."""
    jw, tw = tile4
    js = JSystem.from_wavefunction(jw)
    ts = System.from_wavefunction(tw, device=CPU)
    js.ref.wfn.SCREEN_NPRI = 0
    ts.ref.wfn.SCREEN_NPRI = 0
    jc = jautocp(js)
    jmakegraph(js, jc)
    return js, ts, jc


def test_screened_newton_matches_jax(screened_pair):
    """autocp through the screened Newton: same counts, CP list within
    1e-9 bohr, Poincare-Hopf 1."""
    js, ts, jc = screened_pair
    np.testing.assert_allclose(crystal_to_arrays(ts.crystal)["x_frac"],
                               crystal_to_arrays(js.crystal)["x_frac"],
                               rtol=0, atol=1e-14)
    tc = autocp(ts)
    assert tc.counts() == jc.counts()
    assert tc.poincare_hopf() == 1
    ja, ta = cplist_to_arrays(jc), cplist_to_arrays(tc)
    np.testing.assert_array_equal(ta["typ"], ja["typ"])
    np.testing.assert_allclose(ta["r"], ja["r"], rtol=0, atol=1e-9)


def test_makegraph_screened_matches_jax(screened_pair):
    """makegraph through trace_paths_screened, from the JAX CP list: the
    intramolecular bond paths (one per H2) end at their molecule's two
    nuclei in both packages, with path lengths within 1e-8 relative.
    Paths of the intermolecular CPs start on exact symmetry planes of the
    tile and may fall to either nucleus of a pair, so only their count of
    resolved ends is compared."""
    js, ts, jc = screened_pair
    from critic2_tpu_torch.analysis.autocp import CP, CPList

    tc = CPList(crystal=ts.crystal, cps=[
        CP(x=cp.x.copy(), r=cp.r.copy(), typ=cp.typ, f=cp.f,
           gfmod=cp.gfmod, del2f=cp.del2f, eig=np.asarray(cp.eig),
           isnuc=cp.isnuc, mult=cp.mult, name=cp.name) for cp in jc.cps])
    makegraph(ts, tc)
    ja, ta = cplist_to_arrays(jc), cplist_to_arrays(tc)
    ta = _same_takeoff_sign(ta, ja)
    intra = [i for i in range(len(ja["typ"])) if ja["typ"][i] == -1
             and sorted(ja["ipath"][i]) in ([0, 1], [2, 3], [4, 5], [6, 7])]
    assert len(intra) == 4
    np.testing.assert_array_equal(ta["ipath"][intra], ja["ipath"][intra])
    np.testing.assert_allclose(ta["brpathlen"][intra],
                               ja["brpathlen"][intra], rtol=1e-8)
    sel = np.abs(ja["typ"]) == 1
    assert ((ta["ipath"][sel] >= 0).sum() == (ja["ipath"][sel] >= 0).sum())


def test_trace_paths_screened_matches_jax(tile4):
    """Uphill from 16 seeds 0.5 bohr off random nuclei, with a chunk of 4
    lanes and a 2-bohr margin so paths leave their escape spheres and
    resume (STAT_OOR re-plans): status and termid exact, end points and
    path lengths within 1e-8."""
    jw, tw = tile4
    rng = np.random.default_rng(5)
    iat = rng.integers(0, len(jw.atz), 16)
    u = rng.normal(size=(16, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    seeds = jw.atpos[iat] + 0.5 * u
    kw = dict(iup=1, targets=jw.atpos, rterm=np.full(len(jw.atpos), 0.2),
              n_chunk=4, margin=2.0)
    jo = jode.trace_paths_screened(jw, seeds, **kw)
    to = tode.trace_paths_screened(tw, seeds, device=CPU, **kw)
    jx, js_, jt, jp = (np.asarray(v) for v in jo[:4])
    tx, ts_, tt, tp = (v.numpy() for v in to[:4])
    np.testing.assert_array_equal(ts_, js_)
    np.testing.assert_array_equal(tt, jt)
    assert (ts_ == tode.STAT_ATTRACTOR).all()
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-8)
    np.testing.assert_allclose(tp, jp, rtol=1e-8)


def test_trace_paths_escape_pauses_lanes():
    """escape=(centre, radius) on the dense tracer: lanes that leave the
    sphere stop with STAT_OOR as in the JAX package (status exact, end
    points within 1e-12)."""
    w = wavefunction_from_arrays(**wavefunction_to_arrays(
        JWfn.read_molden(_write_tmp(H2_MOLDEN))))
    jw = JWfn.read_molden(_write_tmp(H2_MOLDEN))
    seeds = np.array([[0.0, 0.3, 2.5], [0.2, 0.0, -1.5], [0.1, 0.1, 0.5]])
    esc = (np.array([0.0, 0.0, 0.7]), 1.2)
    jfn = lambda xT: jw.rho_eval_soa(xT, nder=1)  # noqa: E731
    jo = jode.trace_paths(jfn, jnp.asarray(seeds), iup=1,
                          targets=jnp.asarray(jw.atpos),
                          rterm=jnp.full(2, 0.1), escape=esc)
    tfn = w.eval_closure(nder=1)
    to = tode.trace_paths(tfn, torch.as_tensor(seeds), iup=1,
                          targets=w.atpos, rterm=np.full(2, 0.1),
                          escape=esc)
    np.testing.assert_array_equal(to[1].numpy(), np.asarray(jo[1]))
    assert (to[1].numpy() == tode.STAT_OOR).any()
    np.testing.assert_allclose(to[0].numpy(), np.asarray(jo[0]), rtol=0,
                               atol=1e-12)


def _write_tmp(text, suffix=".molden"):
    import tempfile

    fd, p = tempfile.mkstemp(suffix=suffix)
    with os.fdopen(fd, "w") as fh:
        fh.write(text)
    return p


@pytest.mark.parametrize("what, call", [
    (None, lambda w, s: w.mep(np.zeros((1, 3)), device=CPU)),
    (None, lambda w, s: w.uslater(np.zeros((1, 3)), device=CPU)),
    (None, lambda w, s: w.xhole(np.zeros((1, 3)), np.zeros(3),
                                device=CPU)),
    (None, lambda w, s: molcalc.molcalc_hf(s)["E_total"]),
    (None,
     lambda w, s: molcalc.molcalc_integral(s, "$1 * 2", lvl="small")),
], ids=["mep", "uslater", "xhole", "molcalc_hf", "molcalc-expr"])
def test_unported_wfn_parts_name_what_they_wait_for(files, what, call):
    """These parts waited for ops/mdint.py, ops/brhole.py and
    arithmetic.py; they run now (what=None) and give finite numbers
    (tests/test_torch_mdint.py and test_torch_arithmetic.py hold them to
    the JAX package)."""
    p = files["molden"]
    s = System.from_structure(p, device=CPU)
    s.load_field(p)
    if what is None:
        out = call(s.ref.wfn, s)
        assert np.isfinite(np.asarray(out.cpu() if hasattr(out, "cpu")
                                      else out)).all()
        return
    with pytest.raises(NotImplementedError, match=what):
        call(s.ref.wfn, s)


def test_nciplot_and_fluxprint_on_wfn_match_jax(files):
    """nciplot (generic route) and fluxprint on a wfn field need only
    Field.eval_fn: density and reduced-gradient cubes within 1e-12 of the
    JAX package's (f64), a recorded path's points within 1e-10 bohr."""
    from critic2_tpu.analysis.flux import fluxprint as jflux
    from critic2_tpu.analysis.nci import nciplot as jnci
    from critic2_tpu_torch.analysis.flux import fluxprint
    from critic2_tpu_torch.analysis.nci import nciplot

    p = files["molden"]
    js = JSystem.from_structure(p)
    js.load_field(p)
    ts = System.from_structure(p, device=CPU)
    ts.load_field(p)
    a = jnci(js, nstep=(12, 12, 14), precision="f64")
    b = nciplot(ts, nstep=(12, 12, 14), precision="f64")
    for k in ("crho", "cgrad"):
        u, v = np.asarray(getattr(a, k)), getattr(b, k)
        v = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        np.testing.assert_allclose(v, u, rtol=1e-12, atol=1e-14, err_msg=k)
    seeds = js.crystal.x_cart[0] + np.array([[0.5, 0.3, 0.2]])
    fa = jflux(js, seeds, iup=1, nrec=100)
    fb = fluxprint(ts, seeds, iup=1, nrec=100)
    np.testing.assert_allclose(np.asarray(fb.pathpts[0]),
                               np.asarray(fa.pathpts[0]), rtol=0,
                               atol=1e-10)


def test_mo_values_and_spin_channels_match_jax(files):
    """MO values (M, N) and the RHF spin channels (rho/2 each): 1e-13."""
    jw, tw = _pair(files["fchk"])
    pts = _points(50, seed=6)
    np.testing.assert_allclose(tw.mo_values(pts, device=CPU).numpy(),
                               np.asarray(jw.mo_values(pts)), rtol=0,
                               atol=1e-13)
    ju, jd = jw.rho_spin_soa(jnp.asarray(pts.T))
    tu, td = tw.rho_spin_soa(pts.T, device=CPU)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                               atol=1e-13)
