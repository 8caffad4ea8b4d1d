"""The port's sharded path (critic2_tpu_torch/parallel/) on a virtual mesh
of CPU shards: the cases of tests/test_sharded.py and
tests/test_grid_ops_sharded.py held against the port's single-device
functions (which the other test_torch_* files hold against the JAX
package), the padded-slab solves, and the slice against the JAX package
on the inputs its own sharded tests compile."""
import numpy as np
import pytest
import torch

import test_integration as jint
from critic2_tpu.analysis.integration import intgrid as jintgrid
from critic2_tpu.crystal.crystal import Crystal as JCrystal, Species
from critic2_tpu.parallel import mesh as jmesh
from critic2_tpu.parallel.grid_ops import ShardedGridOps as JShardedGridOps
from critic2_tpu.parallel.yt_sharded import \
    yt_integrate_sharded as jyt_sharded
from critic2_tpu_torch import System
from critic2_tpu_torch.analysis.integration import _rasterize_field, intgrid
from critic2_tpu_torch.analysis import yt as tyt
from critic2_tpu_torch.analysis.yt import yt_integrate
from critic2_tpu_torch.convert import crystal_from_arrays
from critic2_tpu_torch.crystal.cell import m_x2c_from_cellpar
from critic2_tpu_torch.fields.field import Field
from critic2_tpu_torch.fields.grid3 import Grid3
from critic2_tpu_torch.ops import fft as sfft
from critic2_tpu_torch.ops.eig3 import eigvalsh3s
from critic2_tpu_torch.ops.interp import interp_soa, sym6_to_mat
from critic2_tpu_torch.ops.yt_pass import yt_gs_pass
from critic2_tpu_torch.parallel.grid_ops import (ShardedGridOps,
                                                 basin_reduce_sharded)
from critic2_tpu_torch.parallel.mesh import (all_to_all, gather, halo_pad,
                                             make_mesh, mesh_shape_for, psum)
from critic2_tpu_torch.parallel.sharded import sharded_eval_fn
from critic2_tpu_torch.parallel.yt_sharded import yt_integrate_sharded

# the inputs are tiny: one intra-op thread a process, so that parallel
# test workers do not fight over the cores
torch.set_num_threads(1)

CPU = "cpu"
ATOL = 1e-10        # port against JAX, and sharded against one device


# ---------------------------------------------------------------- mesh
def test_mesh_shape_for():
    assert mesh_shape_for(8) == (4, 2)
    assert mesh_shape_for(4) == (2, 2)
    assert mesh_shape_for(7) == (7, 1)
    assert mesh_shape_for(1) == (1, 1)


def test_virtual_mesh_on_one_device():
    mesh = make_mesh(8, device=CPU)
    assert mesh.shape == {"space": 4, "points": 2}
    assert mesh.devices.shape == (4, 2)
    assert mesh.space_devices == [torch.device(CPU)] * 4
    assert make_mesh(device=CPU).shape == {"space": 1, "points": 1}


def test_collectives_match_their_definitions():
    """halo_pad is the cyclic ppermute halo, all_to_all the tiled
    all-to-all, psum the sum, gather the concatenation."""
    x = torch.arange(4 * 3 * 6, dtype=torch.float64).reshape(12, 6)
    shards = list(x.chunk(4))
    pads = halo_pad(shards, 1, 2)
    for i, p in enumerate(pads):
        rows = [(3 * i + k) % 12 for k in range(-1, 5)]
        assert torch.equal(p, x[rows])
    cols = halo_pad([s.T for s in shards], 2, 0, dim=1)
    assert torch.equal(cols[0], x[[10, 11, 0, 1, 2]].T)
    # shard j receives chunk j (along dim 1) of every shard, in order
    got = all_to_all(shards, split_dim=1, concat_dim=0)
    for j, g in enumerate(got):
        assert torch.equal(g, torch.cat([s.tensor_split(4, 1)[j]
                                         for s in shards], 0))
    assert torch.equal(gather(all_to_all(got, 0, 1), dim=0), x)
    assert torch.equal(psum(shards), x.reshape(4, 3, 6).sum(0))
    assert torch.equal(gather(shards), x)


# ---------------------------------------------------- tests/test_sharded.py
def _problem(n1, n2, n3, npts, rng):
    a = 7.0
    c = crystal_from_arrays(
        m_x2c_from_cellpar([a, a, 1.3 * a], [90.0, 90.0, 120.0]),
        np.zeros((1, 3)), [0], [("C", 6)])
    i, j, k = np.meshgrid(np.arange(n1), np.arange(n2), np.arange(n3),
                          indexing="ij")
    f = (1.0 + np.sin(2 * np.pi * i / n1) * np.cos(2 * np.pi * j / n2)
         + 0.3 * np.cos(4 * np.pi * k / n3))
    pts = rng.random((npts, 3)) @ np.asarray(c.m_x2c).T
    return c, torch.as_tensor(f), torch.as_tensor(pts)


@pytest.mark.parametrize("ndev", [8, 4, 2])
def test_sharded_matches_single_device(ndev, rng):
    mesh = make_mesh(ndev, device=CPU)
    nspace = mesh.shape["space"]
    n1 = 4 * nspace
    npts = 32 * mesh.shape["points"]
    c, f, pts = _problem(n1, 8, 12, npts, rng)
    w = torch.as_tensor(rng.random(npts))

    fn = sharded_eval_fn(mesh, (n1, 8, 12), c.m_c2x, c.m_x2c, nder=2)
    fv, gf, hf, wsum = fn(f, pts, w)

    m_c2x = torch.as_tensor(c.m_c2x)
    y, yp, ypp = interp_soa(f, m_c2x @ pts.T, nder=2)
    gref = yp.T @ m_c2x
    href = torch.einsum("ki,nkl,lj->nij", m_c2x, sym6_to_mat(ypp), m_c2x)

    np.testing.assert_allclose(fv, y, atol=1e-12)
    np.testing.assert_allclose(gf, gref, atol=1e-11)
    np.testing.assert_allclose(hf, href, atol=1e-10)
    np.testing.assert_allclose(float(wsum), float((w * y).sum()),
                               rtol=1e-12)


# -------------------------------------------- tests/test_grid_ops_sharded.py
@pytest.fixture(scope="module")
def setup():
    mesh = make_mesh(8, device=CPU)
    m_x2c = np.array([[6.0, 0.3, 0.0], [0.0, 5.0, 0.2], [0.0, 0.0, 7.0]])
    shape = (16, 16, 12)
    i, j, k = np.meshgrid(*[np.arange(n) for n in shape], indexing="ij")
    f = (2.0 + np.cos(2 * np.pi * i / shape[0])
         * np.cos(2 * np.pi * j / shape[1])
         + 0.5 * np.cos(4 * np.pi * k / shape[2])
         + 0.25 * np.sin(2 * np.pi * (i + 2 * j - k) / shape[0]))
    ops = ShardedGridOps(mesh, shape, m_x2c)
    return mesh, m_x2c, f, ops


def _close(out, ref):
    np.testing.assert_allclose(gather(out), ref, rtol=1e-10, atol=1e-10)


def test_laplacian_matches(setup):
    _, m_x2c, f, ops = setup
    _close(ops.laplacian(f), sfft.laplacian(torch.as_tensor(f), m_x2c))


def test_gradrho_matches(setup):
    _, m_x2c, f, ops = setup
    _close(ops.gradrho(f), sfft.gradrho(torch.as_tensor(f), m_x2c))


def test_grad_components_match(setup):
    _, m_x2c, f, ops = setup
    ref = sfft.grad_components(torch.as_tensor(f), m_x2c)
    for a, comp in enumerate(ops.grad_components(f)):
        _close(comp, ref[a])


def test_hxx_pot_match(setup):
    _, m_x2c, f, ops = setup
    ft = torch.as_tensor(f)
    for ix in range(3):
        _close(ops.hxx(f, ix), sfft.hxx(ft, m_x2c, ix))
    _close(ops.pot(f, isry=True), sfft.pot(ft, m_x2c, isry=True))


def test_output_is_one_slab_per_space_index(setup):
    mesh, _, f, ops = setup
    out = ops.laplacian(f)
    m = f.shape[0] // mesh.shape["space"]
    assert len(out) == mesh.shape["space"] == 4
    assert {tuple(s.shape) for s in out} == {(m, f.shape[1], f.shape[2])}
    assert [s.device for s in out] == mesh.space_devices
    # slabs in, slabs out: the same numbers
    slabs = list(torch.as_tensor(f).chunk(4))
    for a, b in zip(ops.laplacian(slabs), out):
        assert torch.equal(a, b)


def _dense_nci(f, m_x2c):
    ft = torch.as_tensor(f)
    gmod = sfft.gradrho(ft, m_x2c)
    rho = ft.abs()
    rdg = gmod / (2.0 * (3.0 * np.pi ** 2) ** (1 / 3)
                  * torch.clamp(rho, min=1e-30) ** (4 / 3))
    g = sfft.gvectors(f.shape, m_x2c)
    fk = torch.fft.fftn(ft)
    pairs = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))
    h6 = torch.stack([torch.fft.ifftn(-g[..., a] * g[..., b] * fk).real
                      .reshape(-1) for a, b in pairs])
    lam = eigvalsh3s(h6)
    return rho, rdg, torch.sign(lam[1]).reshape(f.shape) * rho, lam[1]


def test_nci_grids_match_dense(setup):
    _, m_x2c, f, ops = setup
    rho_s, rdg_s, sl2_s = (gather(a) for a in ops.nci_grids(f))
    rho, rdg, sl2, lam2 = _dense_nci(f, m_x2c)
    np.testing.assert_allclose(rho_s, rho, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(rdg_s, rdg, rtol=1e-8, atol=1e-10)
    # sign(lambda_2) is ill-conditioned where lambda_2 ~ 0
    ok = (lam2.abs() > 1e-8).reshape(f.shape)
    assert float(ok.double().mean()) > 0.9
    np.testing.assert_allclose(sl2_s[ok], sl2[ok], rtol=1e-8, atol=1e-10)


def test_basin_reduce_matches_segment_sum(setup, rng):
    mesh, _, f, _ = setup
    N = 16 * 16 * 12
    nattr, Nb = 5, 64
    labels = rng.integers(0, nattr, N).astype(np.int32)
    isb = np.zeros(N, bool)
    isb[rng.choice(N, Nb, replace=False)] = True
    interior = np.where(isb, -1, labels).astype(np.int32)
    bidx = np.zeros(N, np.int32)
    bidx[isb] = np.arange(Nb)
    Wb = rng.random((nattr, Nb))
    Wb /= Wb.sum(0)
    fields = rng.random((3, N))
    out = basin_reduce_sharded(mesh, interior, bidx, Wb, nattr, fields)
    W = np.zeros((nattr, N))
    W[labels[~isb], np.where(~isb)[0]] = 1.0
    W[:, isb] = Wb
    np.testing.assert_allclose(out, fields @ W.T, rtol=1e-10, atol=1e-10)


def _yt_problem(rng):
    """The grid and crystal of test_grid_ops_sharded.py's sharded YT case,
    and its extra integrand."""
    n = (16, 12, 10)
    i, j, k = np.meshgrid(*[np.arange(x) for x in n], indexing="ij")
    rho = (2.0 + np.cos(2 * np.pi * i / n[0]) * np.cos(2 * np.pi * j / n[1])
           + 0.5 * np.cos(2 * np.pi * k / n[2]) + 0.01 * rng.random(n))
    c = crystal_from_arrays(np.diag([8.0, 7.0, 6.0]), [[0.0, 0.0, 0.0]],
                            [0], [("X", 10)])
    return c, rho, rng.random((1, rho.size))


def _perm(xattr, ref):
    """Index into ref's attractors of each attractor of xattr, matched by
    position."""
    perm = []
    for xa in xattr:
        d = ref - xa[None, :]
        d -= np.rint(d)
        perm.append(int(np.argmin(np.linalg.norm(d, axis=1))))
    assert sorted(perm) == list(range(len(ref)))
    return perm


def test_yt_sharded_matches_single_device(rng):
    c, rho, extra = _yt_problem(rng)
    xattr, q, labels = yt_integrate_sharded(make_mesh(8, device=CPU), c, rho,
                                            fields_flat=extra)
    res = yt_integrate(c, rho, device=CPU)
    assert len(xattr) == res.nattr
    perm = _perm(xattr, res.xattr)
    qr = res.integrate(np.stack([rho.reshape(-1), extra[0]]))
    np.testing.assert_allclose(q, qr[:, perm], rtol=1e-10, atol=1e-10)
    assert abs(q[0].sum() - rho.sum()) < 1e-10
    np.testing.assert_array_equal(np.argsort(perm)[res.labels], labels)


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_sharded_flux_is_the_whole_grid_flux_bitwise(ndev, rng):
    """The slabs' flux, built from halo-padded slabs, is the whole grid's
    bit for bit, and so is the attractor set: one basin rule, ties
    included."""
    c, rho, _ = _yt_problem(rng)
    sh = yt_integrate_sharded(make_mesh(ndev, device=CPU), c, rho,
                              result=True)
    offs, wts = tyt._grid_ws_neighbors(c, rho.shape)
    chi, is_attr = tyt._flux_tensors(torch.as_tensor(rho), wts,
                                     tuple(map(tuple, offs.tolist())))
    assert len(sh._solver.chi) == mesh_shape_for(ndev)[0]
    assert torch.equal(torch.cat(sh._solver.chi, dim=1), chi)
    np.testing.assert_array_equal(np.sort(sh.iattr),
                                  np.flatnonzero(is_attr.numpy()))


def test_yt_sharded_nacl_32_matches_single_device():
    """The NaCl analogue of the JAX package's 128^3 sharded case, at 32^3:
    4 slabs of 8 planes, the Gauss-Seidel solve in a few outer
    iterations, charges equal to one device's."""
    n = 32
    c = crystal_from_arrays(m_x2c_from_cellpar([10.66] * 3, [90] * 3),
                            [[0.0, 0.0, 0.0], [0.5, 0.5, 0.5],
                             [0.5, 0.5, 0.0], [0.0, 0.0, 0.5]],
                            [0, 1, 0, 1], [("Na", 11), ("Cl", 17)])
    g = np.stack(np.meshgrid(*[np.arange(n) / n] * 3, indexing="ij"), -1)
    rho = np.zeros((n, n, n))
    for site, amp, alpha in zip(c.x_frac, (11.0, 17.0, 11.0, 17.0),
                                (1.0, 0.7, 1.0, 0.7)):
        d = g - site
        d -= np.rint(d)
        rho += amp * np.exp(-alpha * ((d @ c.m_x2c.T) ** 2).sum(-1))
    sh = yt_integrate_sharded(make_mesh(8, device=CPU), c, rho, result=True)
    q = sh.integrate(rho.reshape(-1))
    stats = dict(sh._solver.stats)
    res = yt_integrate(c, rho, device=CPU)
    assert sh.nattr == res.nattr
    np.testing.assert_allclose(q, res.integrate(rho.reshape(-1))
                               [_perm(sh.xattr, res.xattr)],
                               rtol=1e-10, atol=1e-10)
    assert abs(q.sum() - rho.sum()) < 1e-8
    assert stats["method"] == "gs" and stats["sweeps"] <= 40, stats


# ------------------------------------------------------ padded-slab solves
def test_padded_slab_sweeps_keep_the_halo_planes(rng):
    """One sweep pair on a halo-padded slab, both directions: the halo
    planes come back bit for bit, and the interior changes."""
    c, rho, _ = _yt_problem(rng)
    sh = yt_integrate_sharded(make_mesh(8, device=CPU), c, rho, result=True)
    sv = sh._solver
    H, m = sv.H, sv.m
    f = torch.as_tensor(np.stack([np.ones(rho.size), rho.reshape(-1)])
                        ).reshape((2,) + rho.shape)
    fs = sv._slabs(f)
    for adjoint in (True, False):
        op = sv.operand(adjoint)[1]
        assert op.shape[1] == m + 2 * H
        assert not op[:, :H].any() and not op[:, H + m:].any()
        sp = halo_pad(fs, H, H, dim=1)[1]
        fp = sp.clone()
        fp[:, H:H + m] = fs[1] * 0.5
        a, c1 = yt_gs_pass(op, sp, fp, offs=sv.offs, adjoint=adjoint,
                           backward=False)
        b, c2 = yt_gs_pass(op, a, fp, offs=sv.offs, adjoint=adjoint,
                           backward=True)
        for out in (a, b):
            assert torch.equal(out[:, :H], sp[:, :H])
            assert torch.equal(out[:, H + m:], sp[:, H + m:])
        assert int(c1) == 1 and not torch.equal(a[:, H:H + m],
                                                sp[:, H:H + m])


def test_gs_equals_jacobi(rng):
    c, rho, extra = _yt_problem(rng)
    f = np.stack([np.ones(rho.size), rho.reshape(-1), extra[0]])
    out = {}
    for method in ("gs", "jacobi"):
        sh = yt_integrate_sharded(make_mesh(8, device=CPU), c, rho,
                                  result=True, method=method)
        out[method] = (sh.integrate(f), sh.labels, sh._solver.stats)
    np.testing.assert_allclose(out["gs"][0], out["jacobi"][0], rtol=0,
                               atol=1e-10)
    np.testing.assert_array_equal(out["gs"][1], out["jacobi"][1])
    assert out["gs"][2]["method"] == "gs"
    assert out["jacobi"][2]["passes"] > out["gs"][2]["sweeps"]


def _port_nacl(shape):
    """test_integration._nacl_system in the port, on the CPU."""
    c = crystal_from_arrays(m_x2c_from_cellpar([10.66] * 3, [90] * 3),
                            [[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]], [0, 1],
                            [("Na", 11), ("Cl", 17)])
    s = System.from_structure(c, device=CPU)
    g = _rasterize_field(s.fields[0], shape)
    s.load_field(Field.from_grid(c, Grid3(g), name="promolgrid"))
    return s


def test_intgrid_mesh_equals_intgrid():
    s = _port_nacl((16, 16, 16))
    ref = intgrid(s, method="yt")
    res = intgrid(s, method="yt", mesh=make_mesh(8, device=CPU))
    assert [r.name for r in res.rows] == [r.name for r in ref.rows]
    assert res.nattr_raw == ref.nattr_raw
    for a, b in zip(res.rows, ref.rows):
        assert abs(a.pop - b.pop) < 1e-10 and abs(a.volume - b.volume) < 1e-10
    assert res.decomp.nboundary == ref.decomp.nboundary
    np.testing.assert_array_equal(res.decomp.labels, ref.decomp.labels)


# ------------------------------------------------------ against the JAX package
def test_yt_sharded_charges_match_jax(rng):
    """The inputs and call of test_grid_ops_sharded.py's sharded YT case,
    JAX make_mesh(8) against the port's make_mesh(8, device="cpu")."""
    c, rho, extra = _yt_problem(rng)
    jc = JCrystal(m_x2c=np.diag([8.0, 7.0, 6.0]),
                  x_frac=np.array([[0.0, 0.0, 0.0]]),
                  species_of=np.array([0]), species=[Species("X", 10)])
    jx, jq, jl = jyt_sharded(jmesh.make_mesh(8), jc, rho, fields_flat=extra)
    tx, tq, tl = yt_integrate_sharded(make_mesh(8, device=CPU), c, rho,
                                      fields_flat=extra)
    perm = _perm(tx, np.asarray(jx))
    np.testing.assert_allclose(tq, np.asarray(jq)[:, perm], rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(np.argsort(perm)[np.asarray(jl)], tl)


def test_nci_grids_match_jax(setup):
    """test_grid_ops_sharded.py's setup: the fused NCI sweep of both
    packages on 8-shard meshes (sign(lambda_2) where |lambda_2| > 1e-8)."""
    _, m_x2c, f, _ = setup
    jout = [np.asarray(a) for a in JShardedGridOps(
        jmesh.make_mesh(8), f.shape, m_x2c).nci_grids(f)]
    tout = [gather(a).numpy() for a in
            ShardedGridOps(make_mesh(8, device=CPU), f.shape,
                           m_x2c).nci_grids(f)]
    lam2 = _dense_nci(f, m_x2c)[3].reshape(f.shape).numpy()
    ok = np.abs(lam2) > 1e-8
    for name, j, t in zip(("rho", "rdg", "sl2rho"), jout, tout):
        if name == "sl2rho":
            j, t = j[ok], t[ok]
        np.testing.assert_allclose(t, j, rtol=0, atol=ATOL, err_msg=name)


def test_intgrid_mesh_matches_jax():
    js = jint._nacl_system(shape=(16, 16, 16))
    jres = jintgrid(js, method="yt", mesh=jmesh.make_mesh(8))
    s = _port_nacl((16, 16, 16))
    np.testing.assert_allclose(s.ref.grid.f.numpy(), np.asarray(js.ref.grid.f),
                               rtol=0, atol=1e-12)
    res = intgrid(s, method="yt", mesh=make_mesh(8, device=CPU))
    assert [r.name for r in res.rows] == [r.name for r in jres.rows]
    for a, b in zip(res.rows, jres.rows):
        assert abs(a.pop - b.pop) < ATOL and abs(a.volume - b.volume) < ATOL
        np.testing.assert_array_equal(a.xfrac, np.asarray(b.xfrac))
