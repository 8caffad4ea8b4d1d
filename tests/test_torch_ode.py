"""The port's gradient-path tracer (ops/ode.py) and makegraph against the
JAX package, on the CPU.

Both tracers take the same BS23 attempts on the same evaluator, so a path
takes the same steps in both unless a rounding difference flips one
accept/reject decision; hits are snapped to the target, so end points,
status and termid must agree exactly. Path lengths are compared to 1e-8
relative.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from critic2_tpu import System as JSystem
from critic2_tpu.analysis.autocp import CP as JCP, CPList as JCPList
from critic2_tpu.analysis.autocp import autocp as jautocp
from critic2_tpu.analysis.autocp import makegraph as jmakegraph
from critic2_tpu.crystal.cell import m_x2c_from_cellpar
from critic2_tpu.crystal.crystal import Crystal, Species
from critic2_tpu.crystal.seed import CrystalSeed
from critic2_tpu.fields.field import Field as JField
from critic2_tpu.fields.grid3 import Grid3 as JGrid3
from critic2_tpu.ops import ode as jode
from critic2_tpu_torch.analysis.autocp import Seed, autocp, makegraph
from critic2_tpu_torch.convert import (cplist_to_arrays, crystal_to_arrays,
                                       system_from_arrays)
from critic2_tpu_torch.ops import ode as tode

# the inputs are tiny: one intra-op thread a process, so that parallel
# test workers do not fight over the cores
torch.set_num_threads(1)

CPU = "cpu"
PLEN_RTOL = 1e-8


def _nacl():
    return Crystal(m_x2c=m_x2c_from_cellpar([10.66] * 3, [90] * 3),
                   x_frac=np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]),
                   species_of=np.array([0, 1]),
                   species=[Species("Na", 11), Species("Cl", 17)])


@pytest.fixture(scope="module")
def nacl():
    c = _nacl()
    return JSystem.from_structure(c), \
        system_from_arrays(**crystal_to_arrays(c), device=CPU)


def _images(c, atoms):
    shifts = np.array([[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1)
                       for k in (-1, 0, 1)])
    return c.x2c((np.asarray(c.x_frac)[None, atoms, :]
                  + shifts[:, None, :]).reshape(-1, 3))


def _both(js, ts, seeds, **kw):
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    jo = jode.trace_paths(js.ref.eval_fn(nder=2), jnp.asarray(seeds), **jkw)
    to = tode.trace_paths(ts.ref.eval_fn(nder=2), torch.as_tensor(seeds),
                          **kw)
    return [np.asarray(v) for v in jo], [v.numpy() for v in to]


def test_status_codes_equal_jax():
    for name in ("STAT_ATTRACTOR", "STAT_NEWCP", "STAT_STUCK",
                 "STAT_ESCAPED", "STAT_MAXSTEP", "STAT_OOR"):
        assert getattr(tode, name) == getattr(jode, name)


def test_trace_to_nucleus_matches_jax(nacl):
    js, ts = nacl
    c = js.crystal
    seeds = c.x_cart[0] + np.random.default_rng(0).normal(0, 0.4, (16, 3))
    imgs = _images(c, [0])
    jo, to = _both(js, ts, seeds, iup=1, targets=imgs,
                   rterm=np.full(len(imgs), 0.1))
    assert (to[1] == tode.STAT_ATTRACTOR).all() and (to[3] > 0).all()
    np.testing.assert_array_equal(to[1], jo[1])
    np.testing.assert_array_equal(to[2], jo[2])
    np.testing.assert_allclose(to[0], jo[0], rtol=0, atol=1e-12)
    np.testing.assert_allclose(to[3], jo[3], rtol=PLEN_RTOL)
    np.testing.assert_allclose(to[4], jo[4], rtol=PLEN_RTOL)


def _mixed_seeds(c):
    rng = np.random.default_rng(1)
    near = c.x_cart[0] + rng.normal(0, 0.3, (300, 3))
    far = c.x_cart[0] + 4.5 * rng.normal(0, 1.0, (8, 3))
    return np.concatenate([near, far])


def _count_attempts(monkeypatch):
    """Wrap the stepper's BS23 attempt: counts calls and lanes."""
    cnt = {"attempts": 0, "lane_attempts": 0}
    attempt = tode._attempt

    def counted(su, st):
        cnt["attempts"] += 1
        cnt["lane_attempts"] += st[0].shape[1]
        return attempt(su, st)

    monkeypatch.setattr(tode, "_attempt", counted)
    return cnt


def test_compaction_on_off_equal_and_match_jax(nacl, monkeypatch):
    """A mixed batch above the packing threshold: fast finishers near the
    nucleus force the live lanes to be packed while slow ridge-side seeds
    are still live. Packed and unpacked traces must agree exactly (lanes
    are independent), and with the JAX trace as stated above."""
    js, ts = nacl
    c = js.crystal
    seeds = _mixed_seeds(c)
    imgs = _images(c, [0, 1])
    kw = dict(iup=1, targets=imgs, rterm=np.full(len(imgs), 0.2), mstep=200)
    fn = ts.ref.eval_fn(nder=2)
    cnt = _count_attempts(monkeypatch)
    o1 = tode.trace_paths(fn, torch.as_tensor(seeds), compact=True, **kw)
    packed = dict(cnt)
    o2 = tode.trace_paths(fn, torch.as_tensor(seeds), compact=False, **kw)
    for a, b in zip(o1, o2):
        assert torch.equal(a, b)
    # the packing happened: fewer lane-attempts than lanes x attempts
    assert packed["lane_attempts"] < packed["attempts"] * len(seeds)
    assert cnt["lane_attempts"] - packed["lane_attempts"] \
        == packed["attempts"] * len(seeds)
    jo = [np.asarray(v) for v in jode.trace_paths(
        js.ref.eval_fn(nder=2), jnp.asarray(seeds), iup=1,
        targets=jnp.asarray(imgs), rterm=jnp.full(len(imgs), 0.2),
        mstep=200)]
    np.testing.assert_array_equal(o1[1].numpy(), jo[1])
    np.testing.assert_array_equal(o1[2].numpy(), jo[2])
    np.testing.assert_allclose(o1[0].numpy(), jo[0], rtol=0, atol=1e-12)
    np.testing.assert_allclose(o1[3].numpy(), jo[3], rtol=PLEN_RTOL)


def test_target_distances_in_blocks_change_nothing(nacl, monkeypatch):
    _, ts = nacl
    c = ts.crystal
    seeds = torch.as_tensor(_mixed_seeds(c)[::6])
    imgs = _images(c, [0, 1])
    kw = dict(iup=1, targets=imgs, rterm=np.full(len(imgs), 0.2), mstep=48)
    fn = ts.ref.eval_fn(nder=2)
    o1 = tode.trace_paths(fn, seeds, **kw)
    monkeypatch.setattr(tode, "TARGET_BLOCK", 7 * len(imgs))
    o2 = tode.trace_paths(fn, seeds, **kw)
    for a, b in zip(o1, o2):
        assert torch.equal(a, b)


def test_downhill_molecule_escapes_match_jax():
    cart = np.array([[0.0, 0.0, 0.22], [0.0, 1.43, -0.89],
                     [0.0, -1.43, -0.89]])
    c = CrystalSeed(x_frac=cart, species_of=np.array([0, 1, 1]),
                    species=[Species("O", 8), Species("H", 1)],
                    ismolecule=True).to_crystal()
    js = JSystem.from_structure(c)
    ts = system_from_arrays(**crystal_to_arrays(c), device=CPU)
    seeds = c.x_cart[0] + np.random.default_rng(2).normal(0, 0.5, (12, 3))
    jo, to = _both(js, ts, seeds, iup=-1, mstep=400,
                   m_c2x=np.asarray(c.m_c2x),
                   molborder=np.asarray(c.molborder))
    assert (to[1] == tode.STAT_ESCAPED).all()
    np.testing.assert_array_equal(to[1], jo[1])
    np.testing.assert_allclose(to[0], jo[0], rtol=0, atol=1e-9)
    np.testing.assert_allclose(to[3], jo[3], rtol=PLEN_RTOL)


def test_resume_with_h0_and_plen0_matches_jax(nacl):
    js, ts = nacl
    c = js.crystal
    seeds = c.x_cart[0] + np.random.default_rng(3).normal(0, 0.8, (6, 3))
    imgs = _images(c, [0, 1])
    h0 = np.linspace(0.05, 0.3, 6)
    p0 = np.linspace(1.0, 2.0, 6)
    jo, to = _both(js, ts, seeds, iup=1, targets=imgs,
                   rterm=np.full(len(imgs), 0.1), h0=h0, plen0=p0)
    np.testing.assert_array_equal(to[1], jo[1])
    np.testing.assert_array_equal(to[2], jo[2])
    np.testing.assert_allclose(to[3], jo[3], rtol=PLEN_RTOL)
    assert (to[3] > p0).all()


def test_float32_and_escape_are_refused(nacl):
    """float32 and numpy seeds are refused. escape= (the screened
    tracer's validity sphere) used to be refused too; it is ported now:
    a seed outside the sphere pauses at once with STAT_OOR."""
    _, ts = nacl
    fn = ts.ref.eval_fn(nder=2)
    x = torch.zeros((2, 3), dtype=torch.float32) + 1.0
    with pytest.raises(TypeError):
        tode.trace_paths(fn, x)
    with pytest.raises(TypeError):
        tode.trace_paths(fn, np.ones((2, 3)))
    xx, st, _, plen, _ = tode.trace_paths(fn, x.double(),
                                          escape=(np.zeros(3), 1.0))
    assert (st.numpy() == tode.STAT_OOR).all()
    assert torch.equal(xx, x.double()) and not plen.any()


def test_recorded_paths_match_jax(nacl):
    js, ts = nacl
    c = js.crystal
    seeds = c.x_cart[0] + np.array([[2.0, 0, 0], [0, 2.0, 0.3]])
    imgs = _images(c, [0, 1])
    jp, jst, jti = jode.trace_paths_recorded(
        js.ref.eval_fn(nder=1), jnp.asarray(seeds), nrec=80, iup=1,
        targets=jnp.asarray(imgs), rterm=jnp.full(len(imgs), 0.2))
    tp, tst, tti = tode.trace_paths_recorded(
        ts.ref.eval_fn(nder=1), torch.as_tensor(seeds), nrec=80, iup=1,
        targets=imgs, rterm=np.full(len(imgs), 0.2), chunk=7)
    np.testing.assert_array_equal(tst, jst)
    np.testing.assert_array_equal(tti, jti)
    for a, b in zip(tp, jp):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
        np.testing.assert_array_equal(a[0], b[0])


# -------------------------------------------------------------- makegraph
def _cscl_model(n=24):
    c = Crystal(m_x2c=m_x2c_from_cellpar([7.0] * 3, [90] * 3),
                x_frac=np.array([[2.5 / n] * 3, [2.5 / n + 0.5] * 3]),
                species_of=np.array([0, 1]),
                species=[Species("Na", 11), Species("Cl", 17)])
    x = np.stack(np.meshgrid(*[np.arange(n) / n] * 3, indexing="ij"), -1)
    g = np.zeros((n, n, n))
    for site, amp in zip(c.x_frac, (1.0, 1.6)):
        d = x - site
        d -= np.rint(d)
        g += amp * np.exp(-((d @ c.m_x2c.T) ** 2).sum(-1) / 1.5 ** 2)
    return c, g


def _same_takeoff_sign(ta, ja):
    """The take-off eigenvector is defined up to its sign, and the sign
    decides which of a CP's two paths is listed first: where the port's
    vector is the JAX one negated, swap the port's two ends."""
    dots = (ta["brvec"] * ja["brvec"]).sum(1)
    sel = np.abs(ja["typ"]) == 1
    # 1e-3: where two Hessian eigenvalues nearly coincide, the eigenvector
    # turns by (rounding difference) / (their gap); observed 7e-5 on one
    # ring point of the model grid
    np.testing.assert_allclose(np.abs(dots[sel]), 1.0, atol=1e-3)
    flip = dots < 0
    out = dict(ta)
    for key in ("ipath", "brpathlen"):
        out[key] = np.where(flip[:, None], ta[key][:, ::-1], ta[key])
    return out


def test_makegraph_on_grid_field_matches_jax():
    """Bond and ring paths of a grid field: both packages trace from the
    same CP list (the JAX list, carried over as arrays), so ipath must be
    equal and brpathlen agree to 1e-5 relative (reason below)."""
    c, g = _cscl_model()
    js = JSystem.from_structure(c)
    js.load_field(JField.from_grid(c, JGrid3(jnp.asarray(g))))
    ts = system_from_arrays(**crystal_to_arrays(c), grid=g, device=CPU)
    jcpl = jautocp(js)
    tcpl = autocp(ts)
    ja, ta = cplist_to_arrays(jcpl), cplist_to_arrays(tcpl)
    np.testing.assert_array_equal(ta["typ"], ja["typ"])
    # same representatives on both sides: the port traces the JAX CPs
    for tcp, jcp in zip(tcpl.cps, jcpl.cps):
        tcp.x, tcp.r = np.array(jcp.x), np.array(jcp.r)
    jmakegraph(js, jcpl)
    makegraph(ts, tcpl)
    ja, ta = cplist_to_arrays(jcpl), cplist_to_arrays(tcpl)
    sel = np.abs(ja["typ"]) == 1
    assert sel.any()
    ta = _same_takeoff_sign(ta, ja)
    np.testing.assert_array_equal(ta["ipath"], ja["ipath"])
    assert (ta["ipath"][ja["typ"] == -1] >= 0).all()
    # 1e-5, not the tracer's 1e-8: the seeds sit 0.01 bohr off the CP
    # along the take-off vector, so a vector turned by 7e-5 (see
    # _same_takeoff_sign) moves the seed by 7e-7 bohr and the path length
    # with it; observed 2.4e-6 relative
    np.testing.assert_allclose(ta["brpathlen"][sel], ja["brpathlen"][sel],
                               rtol=1e-5)
    # the structure's nearest neighbours are bonded
    assert any({tcpl.cps[i].name for i in cp.ipath} == {"Na", "Cl"}
               for cp in tcpl.cps if cp.typ == -1)


def test_makegraph_on_promolecular_field_matches_jax(nacl):
    """The port's CP list (WS seeds at depth 0), rebuilt as a JAX CP list,
    goes through both makegraphs."""
    js, ts = nacl
    tcpl = autocp(ts, seeds=[Seed(typ="ws", depth=0)])
    jcpl = JCPList(crystal=js.crystal, cps=[
        JCP(x=cp.x.copy(), r=cp.r.copy(), typ=cp.typ, f=cp.f,
            gfmod=cp.gfmod, del2f=cp.del2f, eig=cp.eig, isnuc=cp.isnuc,
            mult=cp.mult, name=cp.name) for cp in tcpl.cps])
    assert any(cp.typ == -1 for cp in tcpl.cps)
    jmakegraph(js, jcpl)
    makegraph(ts, tcpl)
    ja, ta = cplist_to_arrays(jcpl), cplist_to_arrays(tcpl)
    ta = _same_takeoff_sign(ta, ja)
    np.testing.assert_array_equal(ta["ipath"], ja["ipath"])
    connected = [cp for cp in tcpl.cps if cp.typ == -1
                 and {tcpl.cps[i].name for i in cp.ipath if i >= 0}
                 == {"Na", "Cl"}]
    assert connected
