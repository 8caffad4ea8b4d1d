"""The torch port's whole slice against the JAX package, on the CPU:
structure -> promolecular density -> grid -> intgrid(method="yt"), and
the grid main path as a whole (autocp + nciplot + intgrid on one grid).

The NaCl analogue is the yt256 leg of tools/parity_bench.py at 32^3.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from critic2_tpu import System as JSystem
from critic2_tpu.analysis import integration as jint
from critic2_tpu.analysis.autocp import autocp as jautocp
from critic2_tpu.analysis.autocp import makegraph as jmakegraph
from critic2_tpu.analysis.nci import nciplot as jnciplot
from critic2_tpu.crystal.cell import m_x2c_from_cellpar
from critic2_tpu.crystal.crystal import Crystal, Species
from critic2_tpu.fields import promol as jpromol
from critic2_tpu.fields.field import Field as JField
from critic2_tpu.fields.grid3 import Grid3 as JGrid3
from critic2_tpu_torch import System
from critic2_tpu_torch.analysis import integration as tint
from critic2_tpu_torch.analysis.autocp import autocp, makegraph
from critic2_tpu_torch.analysis.nci import nciplot
from critic2_tpu_torch.convert import (bader_to_arrays, cplist_to_arrays,
                                       crystal_from_arrays,
                                       crystal_to_arrays,
                                       integration_to_arrays,
                                       system_from_arrays)
from critic2_tpu_torch.fields import promol as tpromol
from critic2_tpu_torch.fields.grid1 import atomic_density_at
from critic2_tpu_torch.fields.grid3 import Grid3

# the inputs are tiny: one intra-op thread a process, so that parallel
# test workers do not fight over the cores
torch.set_num_threads(1)

CPU = "cpu"


def _nacl():
    return Crystal(m_x2c=m_x2c_from_cellpar([10.66] * 3, [90] * 3),
                   x_frac=np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5],
                                    [0.5, 0.5, 0.0], [0.0, 0.0, 0.5]]),
                   species_of=np.array([0, 1, 0, 1]),
                   species=[Species("Na", 11), Species("Cl", 17)])


def _port(c):
    return crystal_from_arrays(**crystal_to_arrays(c))


@pytest.fixture(scope="module")
def nacl32():
    """(JAX system, port system, rho (32,)*3 numpy from the JAX side) with
    the rasterized promolecular grid loaded as the reference field."""
    c = _nacl()
    js = JSystem.from_structure(c)
    g = np.asarray(jint._rasterize_field(js.fields[0], (32, 32, 32)))
    js.load_field(JField.from_grid(c, JGrid3(jnp.asarray(g)), name="pg"))
    ts = system_from_arrays(**crystal_to_arrays(c), grid=g, device=CPU)
    return js, ts, g


@pytest.mark.parametrize("nder", [0, 1, 2])
def test_promolecular_soa_matches_jax(nder):
    c = _nacl()
    jenv = jpromol.PromolEnv(c)
    tenv = tpromol.PromolEnv(_port(c), device=CPU)
    assert tenv.atpos.shape == tuple(jenv.atpos.shape)
    rng = np.random.default_rng(11)
    pts = rng.random((3, 500)) * 10.66
    pts[:, 0] = 0.0                       # on a nucleus
    pts[:, 1] = 1e-9                      # beside it
    jf = jpromol.promolecular_soa(jnp.asarray(pts), jenv.atpos, jenv.atspc,
                                  jenv.tab, nder=nder)
    tf = tpromol.promolecular_soa(torch.as_tensor(pts), tenv.atpos,
                                  tenv.atspc, tenv.tab, nder=nder)
    for a, b in zip(tf, jf):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-13,
                                   atol=1e-13 * max(np.abs(b).max(), 1e-300))


def test_rasterized_promolecular_grid_matches_jax(nacl32):
    _, _, g = nacl32
    ts = System.from_structure(_port(_nacl()), device=CPU)
    gt = tint._rasterize_field(ts.fields[0], (32, 32, 32), block=4096)
    assert gt.shape == (32, 32, 32) and gt.dtype == torch.float64
    np.testing.assert_allclose(gt.numpy(), g, rtol=1e-13, atol=0)


def test_intgrid_yt_matches_jax(nacl32):
    js, ts, g = nacl32
    rj = jint.intgrid(js, method="yt")
    rt = tint.intgrid(ts, method="yt")
    assert rt.nattr_raw == rj.nattr_raw
    assert [(r.name, r.atom) for r in rt.rows] == \
        [(r.name, r.atom) for r in rj.rows]
    for a, b in ((rt.charges, rj.charges), (rt.volumes, rj.volumes)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)
    for r, q in zip(rt.rows, rj.rows):
        np.testing.assert_array_equal(r.xfrac, q.xfrac)
    dv = rt.decomp.crystal.volume / g.size
    assert abs(rt.charges.sum() - g.sum() * dv) < 1e-8
    assert abs(rt.volumes.sum() - rt.decomp.crystal.volume) < 1e-8
    assert rt.table().splitlines()[0] == rj.table().splitlines()[0]


def test_intgrid_extra_fields_and_options_match_jax(nacl32):
    js, ts, g = nacl32
    extra = {"sq": g ** 2}
    rj = jint.intgrid(js, method="yt", fields=extra, noatoms=True)
    rt = tint.intgrid(ts, method="yt", fields=extra, noatoms=True)
    assert [r.name for r in rt.rows] == [r.name for r in rj.rows]
    np.testing.assert_allclose([r.extra["sq"] for r in rt.rows],
                               [r.extra["sq"] for r in rj.rows],
                               rtol=1e-10, atol=0)
    # mesh= runs the sharded YT (parallel/yt_sharded): the same sums
    from critic2_tpu_torch.parallel.mesh import make_mesh

    rm = tint.intgrid(ts, method="yt", fields=extra, noatoms=True,
                      mesh=make_mesh(4, device=CPU))
    np.testing.assert_allclose([r.extra["sq"] for r in rm.rows],
                               [r.extra["sq"] for r in rj.rows],
                               rtol=1e-10, atol=0)
    # discard= is an expression now: an unknown name is refused
    with pytest.raises(ValueError, match="unknown variable rho"):
        tint.intgrid(ts, discard="rho")
    with pytest.raises(ValueError):
        tint.intgrid(ts, method="nope")


def test_intgrid_promolecular_reference_matches_jax():
    """A promolecular reference field is rasterized inside intgrid."""
    c = _nacl()
    rj = jint.intgrid(JSystem.from_structure(c), grid_shape=(20, 20, 20))
    rt = tint.intgrid(System.from_structure(_port(c), device=CPU),
                      grid_shape=(20, 20, 20))
    assert [r.name for r in rt.rows] == [r.name for r in rj.rows]
    np.testing.assert_allclose(rt.charges, rj.charges, rtol=0, atol=1e-10)


def test_core_augmented_basin_field_matches_jax():
    c = _nacl()
    zpsp = {11: 9, 17: 7}
    jenv = jpromol.PromolEnv(c, zpsp=zpsp)
    tenv = tpromol.PromolEnv(_port(c), zpsp=zpsp, device=CPU)
    gj = np.asarray(jint._rasterize_env(c, jenv, (12, 12, 12)))
    gt = tint._rasterize_env(_port(c), tenv, (12, 12, 12), block=500)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-13, atol=0)


def test_atomic_density_at_matches_jax():
    from critic2_tpu.fields.grid1 import atomic_density_at as jat

    zs = [11, 17, 17, 11]
    dist = [0.3, 1.1, 4.0, 0.01]
    np.testing.assert_allclose(atomic_density_at(zs, dist, device=CPU),
                               jat(zs, dist), rtol=1e-13)


def _write_cube(path, c, g):
    n = g.shape
    vox = np.asarray(c.m_x2c) / np.asarray(n)[None, :]
    with open(path, "w") as fh:
        fh.write("cube written by numpy\nsecond comment line\n")
        fh.write(f"{len(c.x_frac):5d} 0.0 0.0 0.0\n")
        for i in range(3):
            fh.write(f"{n[i]:5d} {vox[0, i]:.12f} {vox[1, i]:.12f} "
                     f"{vox[2, i]:.12f}\n")
        for x, sp in zip(c.x_cart, c.species_of):
            z = c.species[sp].z
            fh.write(f"{z:5d} {float(z):.6f} {x[0]:.12f} {x[1]:.12f} "
                     f"{x[2]:.12f}\n")
        vals = g.reshape(-1)
        for lo in range(0, len(vals), 6):
            fh.write(" ".join(f"{v:.16e}" for v in vals[lo:lo + 6]) + "\n")


def test_cube_file_read_by_both(tmp_path, nacl32):
    js, _, g = nacl32
    c = _nacl()
    path = str(tmp_path / "rho.cube")
    _write_cube(path, c, g[:, :24, :20])
    gj = np.asarray(JGrid3.read_cube(path).f)
    gt = Grid3.read_cube(path, device=CPU).f
    assert gt.dtype == torch.float64
    np.testing.assert_array_equal(gt.numpy(), gj)
    np.testing.assert_array_equal(gt.numpy(), g[:, :24, :20])
    ts = System.from_structure(_port(c), device=CPU)
    fid = ts.load_field(path, name="cube")
    assert ts.iref == fid and ts.ref.type == "grid"
    assert ts.field("cube") is ts.ref
    np.testing.assert_array_equal(ts.ref.grid.f.numpy(), gj)
    # a pwc grid now loads beside it, with its Kohn-Sham states
    from test_deloc import write_pwc

    from critic2_tpu.fields.qe import read_pwc as jax_read_pwc

    pwc = str(tmp_path / "rho.pwc")
    write_pwc(pwc, np.asarray(c.m_x2c), (2, 1, 1), 2, (8, 8, 8))
    fp = ts.load_field(pwc)
    jrho = jax_read_pwc(pwc)[1]
    assert ts.field(fp).type == "grid" and ts.field(fp).grid.qe.nks == 2
    got = ts.field(fp).grid.f.numpy()
    assert np.abs(got - jrho).max() <= 1e-12 * np.abs(jrho).max()


def test_convert_round_trips(nacl32):
    c = _nacl()
    arrs = crystal_to_arrays(c)
    back = crystal_to_arrays(crystal_from_arrays(**arrs))
    for k in ("m_x2c", "x_frac", "species_of"):
        np.testing.assert_array_equal(back[k], arrs[k])
    assert back["species"] == arrs["species"] == [("Na", 11), ("Cl", 17)]
    tc = crystal_from_arrays(**arrs)
    assert tc.volume == c.volume
    np.testing.assert_array_equal(tc.zatoms, c.zatoms)
    np.testing.assert_allclose(tc.ws.areas, c.ws.areas, rtol=0, atol=0)
    np.testing.assert_allclose(tc.distance(c.x_frac[0], c.x_frac[1]),
                               c.distance(c.x_frac[0], c.x_frac[1]),
                               rtol=1e-15)
    pj, sj, cj = c.atomic_environment(12.0)
    pt, st, ct = tc.atomic_environment(12.0)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(st, sj)
    _, ts, g = nacl32
    assert ts.iref == 1 and ts.ref.grid.f.dtype == torch.float64
    np.testing.assert_array_equal(ts.ref.grid.f.numpy(), g)
    assert ts.fields[0].type == "promol"
    assert tc.spacegroup.nops == c.spacegroup.nops
    assert tc.spg_name() == c.spg_name()


def test_intgrid_core_augmented_matches_jax(nacl32):
    """usecore + zpsp: the basin field is the grid plus the promolecular
    core density (reference src/integration@proc.f90:176-183)."""
    js, _, g = nacl32
    c = _nacl()
    zpsp = {11: 9, 17: 7}
    gs = g[::2, ::2, ::2].copy()
    jsys = JSystem.from_structure(c)
    jsys.load_field(JField.from_grid(c, JGrid3(jnp.asarray(gs))))
    jsys.ref.set_options(core=True, zpsp=zpsp)
    tsys = system_from_arrays(**crystal_to_arrays(c), grid=gs, device=CPU)
    tsys.ref.set_options(core=True, zpsp=zpsp)
    assert tsys.ref.coreenv is not None
    rj = jint.intgrid(jsys, method="yt")
    rt = tint.intgrid(tsys, method="yt")
    np.testing.assert_allclose(rt.rho.numpy(), np.asarray(rj.rho),
                               rtol=1e-13, atol=0)
    assert [r.name for r in rt.rows] == [r.name for r in rj.rows]
    np.testing.assert_allclose(rt.charges, rj.charges, rtol=0, atol=1e-10)


def test_grid_main_path_matches_jax():
    """The slice as a whole: numpy arrays -> system_from_arrays ->
    autocp + nciplot + intgrid(method="yt") on one 24^3 grid, against the
    same calls of the JAX package. The field is a smooth two-Gaussian
    model density with its atoms at cell centres of the grid, so no
    critical point sits on a node plane (where the tricubic Hessian
    jumps). Positions within 1e-9 bohr, charges within 1e-10 e, cubes
    within 1e-10 relative."""
    n = 24
    c = Crystal(m_x2c=m_x2c_from_cellpar([7.0] * 3, [90] * 3),
                x_frac=np.array([[2.5 / n] * 3, [2.5 / n + 0.5] * 3]),
                species_of=np.array([0, 1]),
                species=[Species("Na", 11), Species("Cl", 17)])
    x = np.stack(np.meshgrid(*[np.arange(n) / n] * 3, indexing="ij"), -1)
    g = np.full((n, n, n), 1e-3)
    for site, amp in zip(c.x_frac, (1.0, 1.6)):
        d = x - site
        d -= np.rint(d)
        g += amp * np.exp(-((d @ c.m_x2c.T) ** 2).sum(-1) / 1.5 ** 2)
    js = JSystem.from_structure(c)
    js.load_field(JField.from_grid(c, JGrid3(jnp.asarray(g)), name="rho"))
    ts = system_from_arrays(**crystal_to_arrays(c), grid=g, name="rho",
                            device=CPU, interp="tricubic")
    assert ts.ref.grid.mode == js.ref.grid.mode == "tricubic"

    ja, ta = cplist_to_arrays(jautocp(js)), cplist_to_arrays(autocp(ts))
    for key in ("typ", "mult", "isnuc", "name"):
        np.testing.assert_array_equal(ta[key], ja[key])
    assert ta["mult"].sum() > 8 and (ta["gfmod"] < 1e-10).all()
    np.testing.assert_allclose(ta["f"], ja["f"], rtol=1e-9)
    sg = ts.crystal.spacegroup
    for xt, xj in zip(ta["x"], ja["x"]):       # modulo the orbit's images
        imgs = (sg.rotations @ xj + sg.translations) % 1.0
        assert ts.crystal.distmat(xt, imgs).min() <= 1e-9

    nstep = (23, 23, 23)
    for prec, tol in (("f64", 1e-10), ("f32", 1e-4)):
        jr = jnciplot(js, nstep=nstep, precision=prec)
        tr = nciplot(ts, nstep=nstep, precision=prec)
        for name in ("crho", "cgrad_raw"):
            ref = np.asarray(getattr(jr, name), dtype=np.float64)
            got = getattr(tr, name).double().numpy()
            flip = np.sign(got) != np.sign(ref)
            assert flip.mean() < (0 if prec == "f64" else 2e-3) + 1e-12
            assert np.abs(got - ref)[~flip].max() <= tol * np.abs(ref).max()
        assert tr.ndat > 0 and abs(tr.ndat - jr.ndat) <= 1e-3 * jr.ndat

    rj = jint.intgrid(js, method="yt")
    rt = tint.intgrid(ts, method="yt")
    assert [(r.name, r.atom) for r in rt.rows] == \
        [(r.name, r.atom) for r in rj.rows]
    np.testing.assert_allclose(rt.charges, rj.charges, rtol=0, atol=1e-10)
    np.testing.assert_allclose(rt.volumes, rj.volumes, rtol=0, atol=1e-10)


def test_spline_graph_and_bader_path_matches_jax():
    """The spline, graph and Bader path as a whole: structure -> grid in
    trispline mode -> autocp -> makegraph -> intgrid(method="bader") ->
    multipoles, against the same calls of the JAX package on the smooth
    model density above.
    The CP graph is compared as a set of (type, ends) per orbit, the
    charges to 1e-10 e, the multipoles to 1e-8."""
    n = 24
    c = Crystal(m_x2c=m_x2c_from_cellpar([7.0] * 3, [90] * 3),
                x_frac=np.array([[2.5 / n] * 3, [2.5 / n + 0.5] * 3]),
                species_of=np.array([0, 1]),
                species=[Species("Na", 11), Species("Cl", 17)])
    x = np.stack(np.meshgrid(*[np.arange(n) / n] * 3, indexing="ij"), -1)
    g = np.full((n, n, n), 1e-3)
    for site, amp in zip(c.x_frac, (1.0, 1.6)):
        d = x - site
        d -= np.rint(d)
        g += amp * np.exp(-((d @ c.m_x2c.T) ** 2).sum(-1) / 1.5 ** 2)
    js = JSystem.from_structure(c)
    js.load_field(JField.from_grid(c, JGrid3(jnp.asarray(g)), name="rho"))
    js.ref.set_options(interp="trispline")
    ts = system_from_arrays(**crystal_to_arrays(c), grid=g, name="rho",
                            device=CPU, interp="trispline")

    jcpl, tcpl = jautocp(js), autocp(ts)
    assert tcpl.counts() == jcpl.counts() and tcpl.poincare_hopf() == 0
    jmakegraph(js, jcpl)
    makegraph(ts, tcpl)
    ja, ta = cplist_to_arrays(jcpl), cplist_to_arrays(tcpl)
    for key in ("typ", "mult", "name"):
        np.testing.assert_array_equal(ta[key], ja[key])
    # each CP's two ends as an unordered pair (the take-off vector's sign
    # orders them); every bond path ends at two nuclei
    np.testing.assert_array_equal(np.sort(ta["ipath"], axis=1),
                                  np.sort(ja["ipath"], axis=1))
    bcp = ta["typ"] == -1
    assert bcp.any() and (ta["ipath"][bcp] >= 0).all()
    assert all(tcpl.cps[i].isnuc for i in ta["ipath"][bcp].ravel())
    np.testing.assert_allclose(np.sort(ta["brpathlen"], axis=1),
                               np.sort(ja["brpathlen"], axis=1), rtol=1e-5)

    for bader_method in ("neargrid", "ongrid"):
        rj = jint.intgrid(js, method="bader", bader_method=bader_method)
        rt = tint.intgrid(ts, method="bader", bader_method=bader_method)
        bj, bt = bader_to_arrays(rj.decomp), bader_to_arrays(rt.decomp)
        np.testing.assert_array_equal(bt["labels"], bj["labels"])
        np.testing.assert_array_equal(bt["iattr"], bj["iattr"])
        ij, it = integration_to_arrays(rj), integration_to_arrays(rt)
        np.testing.assert_array_equal(it["name"], ij["name"])
        np.testing.assert_allclose(it["pop"], ij["pop"], rtol=0, atol=1e-10)
        np.testing.assert_allclose(it["volume"], ij["volume"], rtol=0,
                                   atol=1e-10)
    np.testing.assert_allclose(tint.multipoles(ts, rt, lmax=2),
                               jint.multipoles(js, rj, lmax=2), rtol=0,
                               atol=1e-8)


def test_expression_slice_matches_jax():
    """The expression slice end to end on a CsCl-type cell whose atoms sit
    at cell centres of the 12^3 grid: LOAD AS an expression grid (a
    Gaussian of @dnuc per atom, through the compiler) equal to the JAX
    package's (1e-13 relative); a ghost over it (2*$xg) as the reference,
    autocp on the ghost through autograd derivatives against autocp on
    the expression grid itself, whose interpolant the ghost
    differentiates (the same CP counts, types and multiplicities,
    positions within 1e-8 bohr up to a symmetry image, values twice the
    grid's to 1e-10, |grad| < 1e-10, Poincare-Hopf 0); then intgrid on
    the expression grid with two INTEGRABLE entries, $xg (equal to the
    charge, 1e-10 e) and gtf(1), both equal to the JAX package's per row
    (1e-10). The JAX package's autocp on a ghost compiles for minutes
    on a cold cache, so the ghost's CP list is held against the port's
    grid route, which tests/test_torch_autocp.py holds against JAX."""
    off = 0.5 / 12
    c = Crystal(m_x2c=m_x2c_from_cellpar([7.0] * 3, [90] * 3),
                x_frac=np.array([[off] * 3, [0.5 + off] * 3]),
                species_of=np.array([0, 1]),
                species=[Species("Na", 11), Species("Cl", 17)])
    js = JSystem.from_structure(c)
    ts = System.from_structure(_port(c), device=CPU)
    expr = "exp(-0.6 * @dnuc^2) * (1 + @idnuc)"
    for s in (js, ts):
        assert s.load_field_expr(expr, name="xg", shape=(12, 12, 12)) == 1
    ts.load_field_expr("$xg * 2", name="gh", ghost=True)
    np.testing.assert_allclose(ts.field("xg").grid.f.numpy(),
                               np.asarray(js.field("xg").grid.f),
                               rtol=1e-13, atol=1e-300)

    ts.set_reference("xg")
    gcpl = autocp(ts)
    ts.set_reference("gh")
    tcpl = autocp(ts)
    ga, ta = cplist_to_arrays(gcpl), cplist_to_arrays(tcpl)
    assert tcpl.counts() == gcpl.counts() and sum(
        (-1) ** k * n for k, n in enumerate(tcpl.counts())) == 0
    # the list order and the image that represents an orbit hang on which
    # seed got there first: match each CP to a twin of the same type and
    # multiplicity, up to a symmetry image
    sg = ts.crystal.spacegroup
    used = set()
    for i in range(len(ta["x"])):
        imgs = ((sg.rotations @ ta["x"][i] + sg.translations) % 1.0)
        d = ts.crystal.distmat(ga["x"], imgs).min(1)
        d[[j for j in range(len(d)) if j in used or ga["typ"][j] !=
           ta["typ"][i] or ga["mult"][j] != ta["mult"][i]]] = np.inf
        j = int(np.argmin(d))
        assert d[j] <= 1e-8, (i, d[j])
        used.add(j)
        assert abs(ta["f"][i] - 2 * ga["f"][j]) <= 1e-10 * abs(ga["f"][j])
    assert len(used) == len(ga["x"]) and (ta["gfmod"] < 1e-10).all()

    for s in (js, ts):
        s.set_reference("xg")
        s.integrables[:] = ["$xg", ("gtf(1)", "kin")]
    rj = jint.intgrid(js, method="yt")
    rt = tint.intgrid(ts, method="yt")
    assert [r.name for r in rt.rows] == [r.name for r in rj.rows]
    assert sorted(r.name for r in rt.rows) == ["Cl", "Na"]
    for r, q in zip(rt.rows, rj.rows):
        assert abs(r.extra["$xg"] - r.pop) < 1e-10
        for k in ("$xg", "kin"):
            assert abs(r.extra[k] - q.extra[k]) < 1e-10
