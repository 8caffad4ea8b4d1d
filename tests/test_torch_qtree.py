"""The port's qtree (analysis/qtree.py) and Keast rules (ops/quadrature.py)
against the JAX package, on the CPU.

The field is the two-Gaussian crystal of tests/test_qtree.py (Gaussians
of amplitude 2 and 1 at (0,0,0) and (1/2,1/2,1/2), a = 8 bohr) at 24^3,
tricubic. qtree's bookkeeping is host numpy in both packages, so the two
trace the same points: ntraced, nlevels and nrefined must be equal, pops
and volumes agree to 1e-9.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from critic2_tpu import System as JSystem
from critic2_tpu.analysis import qtree as jq
from critic2_tpu.crystal.cell import m_x2c_from_cellpar
from critic2_tpu.crystal.crystal import Crystal, Species
from critic2_tpu.fields.field import Field as JField
from critic2_tpu.fields.grid3 import Grid3 as JGrid3
from critic2_tpu.ops import quadrature as jquad
from critic2_tpu_torch.analysis import qtree as tq
from critic2_tpu_torch.convert import (crystal_from_arrays,
                                       crystal_to_arrays, qtree_to_arrays,
                                       system_from_arrays)
from critic2_tpu_torch.ops import quadrature as tquad

# the inputs are tiny: one intra-op thread a process, so that parallel
# test workers do not fight over the cores
torch.set_num_threads(1)

CPU = "cpu"
N = 24
A = 8.0


def _crystal():
    return Crystal(m_x2c=m_x2c_from_cellpar([A] * 3, [90] * 3),
                   x_frac=np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]),
                   species_of=np.array([0, 1]),
                   species=[Species("Na", 11), Species("Cl", 17)])


def _grid():
    ii, jj, kk = np.meshgrid(*[np.arange(N) / N] * 3, indexing="ij")
    xf = np.stack([ii, jj, kk], axis=-1)

    def gauss(center, amp, alpha):
        d = xf - center
        d -= np.round(d)
        return amp * np.exp(-alpha * ((d * A) ** 2).sum(-1))

    return (gauss(np.zeros(3), 2.0, 0.8) + gauss(np.full(3, 0.5), 1.0, 0.6)
            + 1e-3)


@pytest.fixture(scope="module")
def systems():
    c = _crystal()
    g = _grid()
    js = JSystem.from_structure(c)
    js.load_field(JField.from_grid(c, JGrid3(jnp.asarray(g)), name="s"))
    js.iref = 1
    ts = system_from_arrays(**crystal_to_arrays(c), grid=g, device=CPU)
    return js, ts


@pytest.mark.parametrize("rule", range(1, 11))
def test_keast_rules_equal_jax(rule):
    """Nodes and weights of every Keast rule to 1e-15; the points and
    weights of a batch of tetrahedra to 1e-15 (weights sum to volume)."""
    for a, b in zip(jquad.keast_rule(rule), tquad.keast_rule(rule)):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-15)
    tets = np.random.default_rng(rule).normal(size=(5, 4, 3))
    for a, b in zip(jquad.keast_points(tets, rule),
                    tquad.keast_points(tets, rule)):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-15)
    _, w = tquad.keast_points(tets, rule)
    np.testing.assert_allclose(w.sum(1), tq._tet_volume(tets), rtol=1e-12)


def test_tetrahedra_and_site_ops_equal_jax():
    """WS tetrahedra, parent-major subdivision, site operations and the
    orbit reduction: arrays equal."""
    c = _crystal()
    tc = crystal_from_arrays(**crystal_to_arrays(c))
    t0 = tq._ws_tetrahedra(tc)
    np.testing.assert_allclose(t0, jq._ws_tetrahedra(c), rtol=0, atol=1e-14)
    np.testing.assert_array_equal(tq._subdivide(t0), jq._subdivide(t0))
    assert abs(tq._tet_volume(tq._subdivide(t0)).sum() - tc.volume) < 1e-8
    # children of parent i are rows 8i..8i+7
    kids = tq._subdivide(t0[:2])
    np.testing.assert_allclose(kids[8:16].reshape(-1, 3).mean(0),
                               t0[1].mean(0), rtol=0, atol=1e-12)
    jops, tops = jq._site_ops(c, 0), tq._site_ops(tc, 0)
    assert len(jops) == len(tops) == 48
    for (ra, pa), (rb, pb) in zip(jops, tops):
        np.testing.assert_allclose(rb, ra, rtol=0, atol=1e-12)
        np.testing.assert_array_equal(pb, pa)
    jr, jp = jq._reduce_tets(t0, jops)
    tr, tp = tq._reduce_tets(t0, tops)
    np.testing.assert_array_equal(tr, jr)
    assert [len(p) for p in tp] == [len(p) for p in jp]


# (maxl, integ, usesym, sphfactor): both levels, both integrators, the
# symmetry reduction on and off, auto, frozen and no beta spheres
CONFIGS = [(2, "keast", True, None), (2, "corner", False, 0.9),
           (3, "keast", True, 0.9), (2, "corner", True, 0.0)]


@pytest.mark.parametrize("maxl, integ, usesym, sphfactor", CONFIGS)
def test_qtree_matches_jax(systems, maxl, integ, usesym, sphfactor):
    js, ts = systems
    kw = dict(maxl=maxl, integ=integ, usesym=usesym, sphfactor=sphfactor)
    ja = qtree_to_arrays(jq.qtree_integrate(js, **kw))
    ta = qtree_to_arrays(tq.qtree_integrate(ts, **kw))
    for k in ("ntraced", "nlevels", "nrefined"):
        assert ta[k] == ja[k], k
    np.testing.assert_array_equal(ta["names"], ja["names"])
    np.testing.assert_allclose(ta["pops"], ja["pops"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(ta["volumes"], ja["volumes"], rtol=0,
                               atol=1e-9)
    assert ta["ntraced"] > 0 and (ta["pops"] > 0).all()


def test_qtree_mixed_precision_close_to_f64(systems):
    """precision="mixed" traces on a float32 copy of the grid with an f64
    retrace of unresolved lanes: the charges stay within 1e-3 e of the
    f64 run (the f32 gradient can move a separatrix-adjacent corner),
    and the f32 tracer is cached on the field per grid object."""
    _, ts = systems
    r64 = tq.qtree_integrate(ts, maxl=2, integ="corner", sphfactor=0.9)
    rmx = tq.qtree_integrate(ts, maxl=2, integ="corner", sphfactor=0.9,
                             precision="mixed")
    np.testing.assert_allclose(rmx.pops, r64.pops, rtol=0, atol=1e-3)
    cache = ts.ref._qtree_trace_fn
    assert cache["_grid_id"] == id(ts.ref.grid) and "mixed" in cache
