"""The port's molecular meshes (analysis/mesh.py) against the JAX
package, on the CPU: radial maps and size tables, the dense and the
mu-threshold (KNN) Becke weights, whole meshes, Franchini weights, mesh
seeds and the disk cache's file name. Tolerances are stated per
assertion.
"""
import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from critic2_tpu.analysis import mesh as jmesh
from critic2_tpu.crystal.cell import m_x2c_from_cellpar
from critic2_tpu.crystal.crystal import Crystal as JCrystal, Species
from critic2_tpu.crystal.seed import CrystalSeed as JSeed
from critic2_tpu.fields.wfn import Wavefunction as JWfn
from critic2_tpu_torch.analysis import mesh as tmesh
from critic2_tpu_torch.analysis.autocp import Seed, gen_seeds
from critic2_tpu_torch.convert import crystal_from_arrays, crystal_to_arrays

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_molden import H2_MOLDEN  # noqa: E402

# the inputs are tiny: one intra-op thread a process, so that parallel
# test workers do not fight over the cores
torch.set_num_threads(1)

CPU = "cpu"


def _molecule(reps=(2, 2, 2)):
    """The JAX package's molecular crystal of an H2 tile, and the port's
    copy of it."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "h2.molden")
        with open(p, "w") as fh:
            fh.write(H2_MOLDEN)
        w = JWfn.read_molden(p).tile(reps)
    c = JSeed(x_frac=w.atpos, species_of=np.zeros(len(w.atz), int),
              species=[Species("H", 1)], ismolecule=True).to_crystal()
    return c, crystal_from_arrays(**crystal_to_arrays(c))


def test_radial_maps_and_sizes_match_jax():
    for lvl in range(1, 7):
        for z in (1, 6, 26, 79):
            assert tmesh.z2nr(z, lvl) == jmesh.z2nr(z, lvl)
            assert tmesh.z2nang(z, lvl) == jmesh.z2nang(z, lvl)
    for fn in ("rmesh_postg", "rmesh_franchini"):
        a = getattr(jmesh, fn)(40, 8)
        b = getattr(tmesh, fn)(40, 8)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    for u, v in zip(jmesh.product_sphere(11), tmesh.product_sphere(11)):
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_dense_becke_weights_match_jax(dtype):
    """(N, nat) Becke cell weights of 8 atoms: 1e-12 in f64; 2e-6 in f32
    (the two packages round f32 apart, ~1e-7 relative a point)."""
    c, _ = _molecule((2, 2, 1))
    x = np.random.default_rng(0).uniform(-2.0, 10.0, (3000, 3))
    a = jmesh._becke_weights_chunked(x, c.x_cart, dtype=dtype, block=1024)
    b = tmesh._becke_weights_chunked(x, c.x_cart, dtype=dtype, block=1024,
                                     device=CPU)
    assert b.dtype == dtype and b.shape == a.shape
    np.testing.assert_allclose(b, a, rtol=0,
                               atol=1e-12 if dtype == np.float64 else 2e-6)
    np.testing.assert_allclose(b.sum(1), 1.0, rtol=0, atol=1e-12
                               if dtype == np.float64 else 1e-6)


def test_knn_becke_weights_match_jax_and_dense():
    """The mu-threshold truncation on a 16-atom tile (forced on by
    calling it directly): equal to the JAX package's to 1e-10 (the tile's
    symmetry makes top-K ties, and the two packages may keep different
    atoms of a tie). Against the dense weights the port is off exactly
    where the JAX route is: the truncation also cuts the products of the
    non-parent cells, up to 0.024 at far points of negligible density."""
    c, tc = _molecule((2, 2, 2))
    x, _, parent = jmesh._becke_mesh_points(c, 1)
    sel = np.random.default_rng(1).choice(len(x), 6000, replace=False)
    x, parent = x[sel], parent[sel]
    a = jmesh._becke_parent_weights_knn(x, c.x_cart, parent, block=2048)
    b = tmesh._becke_parent_weights_knn(x, tc.x_cart, parent, block=2048,
                                        device=CPU)
    dense = tmesh._becke_weights_chunked(x, tc.x_cart, device=CPU)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-10)
    d = dense[np.arange(len(x)), parent]
    assert (np.abs(b - d) <= np.abs(a - d) + 1e-10).all()


def test_becke_mesh_matches_jax(monkeypatch, tmp_path):
    """Whole meshes at level small, f64 weights: points equal, weights to
    1e-12 of the largest weight, on the dense route (8 atoms) and on the
    KNN route (_KNN_NAT_MIN lowered in both packages)."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    for reps, knn in (((2, 2, 1), False), ((2, 2, 1), True)):
        if knn:
            monkeypatch.setattr(jmesh, "_KNN_NAT_MIN", 4)
            monkeypatch.setattr(tmesh, "_KNN_NAT_MIN", 4)
        c, tc = _molecule(reps)
        a = jmesh.becke_mesh(c, "small")
        b = tmesh.becke_mesh(tc, "small", device=CPU)
        np.testing.assert_array_equal(b.x, a.x)
        np.testing.assert_allclose(b.w, a.w, rtol=0,
                                   atol=1e-12 * np.abs(a.w).max())
        assert tmesh.becke_mesh(tc, "small", device=CPU) is b   # cached


def test_becke_disk_cache_has_its_own_name(monkeypatch, tmp_path):
    """Large meshes go to disk in the temporary directory: the port's
    file is not the JAX package's, so neither reads the other's back."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(jmesh, "_KNN_NAT_MIN", 4)
    monkeypatch.setattr(tmesh, "_KNN_NAT_MIN", 4)
    c, tc = _molecule((2, 1, 1))
    jmesh.becke_mesh(c, "small")
    jfiles = set(os.listdir(tmp_path))
    assert len(jfiles) == 1
    m = tmesh.becke_mesh(tc, "small", device=CPU)
    path = tmesh.becke_cache_path(tc, 1)
    assert os.path.basename(path) not in jfiles
    assert os.path.basename(path).startswith("critic2_torch_becke_")
    assert set(os.listdir(tmp_path)) == jfiles | {os.path.basename(path)}
    # a fresh crystal object reads the port's file back
    _, tc2 = _molecule((2, 1, 1))
    m2 = tmesh.becke_mesh(tc2, "small", device=CPU)
    np.testing.assert_array_equal(m2.w, m.w)


def test_franchini_mesh_matches_jax():
    """Franchini weights on a two-atom cubic crystal, level small:
    points equal, weights to 1e-12 relative."""
    c = JCrystal(m_x2c=m_x2c_from_cellpar([6.0] * 3, [90] * 3),
                 x_frac=np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]),
                 species_of=np.array([0, 1]),
                 species=[Species("H", 1), Species("Li", 3)])
    tc = crystal_from_arrays(**crystal_to_arrays(c))
    a = jmesh.franchini_mesh(c, "small", rthres=6.0)
    b = tmesh.franchini_mesh(tc, "small", rthres=6.0, device=CPU)
    np.testing.assert_array_equal(b.x, a.x)
    np.testing.assert_allclose(b.w, a.w, rtol=1e-12, atol=1e-300)


def test_mesh_seeds_equal_jax():
    """Seed type mesh: the nodes of the level-small Becke mesh, in
    fractional coordinates, equal to the JAX package's seeds."""
    from critic2_tpu.analysis.autocp import Seed as JSeedT, gen_seeds as jgen

    c, tc = _molecule((2, 1, 1))
    a = jgen(c, [JSeedT(typ="mesh")])
    b = gen_seeds(tc, [Seed(typ="mesh")], device=CPU)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-14)
    assert len(b) == 4 * tmesh.z2nr(1, 1) * tmesh.z2nang(1, 1)
