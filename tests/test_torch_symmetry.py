"""crystal/symmetry and the Crystal helpers of the torch port against the
JAX package (host numpy on both sides): the detected operations must be
the same arrays, in the same order.
"""
import numpy as np
import pytest
import torch

from critic2_tpu.crystal.cell import m_x2c_from_cellpar
from critic2_tpu.crystal.crystal import Crystal, Species
from critic2_tpu_torch import param as tparam
from critic2_tpu_torch.convert import crystal_from_arrays, crystal_to_arrays
from critic2_tpu_torch.crystal.symmetry import lattice_point_group

# the inputs are tiny: one intra-op thread a process, so that parallel
# test workers do not fight over the cores
torch.set_num_threads(1)

FCC = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]],
               dtype=float)


def _structures():
    cubic = m_x2c_from_cellpar([8.0] * 3, [90] * 3)
    out = {
        "rocksalt": Crystal(
            m_x2c=cubic, x_frac=np.concatenate([FCC, (FCC + 0.5) % 1.0]),
            species_of=np.array([0] * 4 + [1] * 4),
            species=[Species("Na", 11), Species("Cl", 17)]),
        "cscl": Crystal(
            m_x2c=cubic, x_frac=np.array([[0, 0, 0], [0.5, 0.5, 0.5]]),
            species_of=np.array([0, 1]),
            species=[Species("Cs", 55), Species("Cl", 17)]),
        "perovskite": Crystal(
            m_x2c=cubic,
            x_frac=np.array([[0, 0, 0], [0.5, 0.5, 0.5], [0.5, 0.5, 0],
                             [0.5, 0, 0.5], [0, 0.5, 0.5]]),
            species_of=np.array([0, 1, 2, 2, 2]),
            species=[Species("Sr", 38), Species("Ti", 22), Species("O", 8)]),
    }
    # the CsCl structure described in a skewed (non-reduced) cell:
    # a' = a + b, unimodular, so the atoms keep their places
    T = np.array([[1.0, 1.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    x = np.array([[0, 0, 0], [0.5, 0.5, 0.5]]) @ np.linalg.inv(T).T
    out["skewed"] = Crystal(
        m_x2c=cubic @ T, x_frac=x % 1.0, species_of=np.array([0, 1]),
        species=[Species("Cs", 55), Species("Cl", 17)])
    out["triclinic"] = Crystal(
        m_x2c=m_x2c_from_cellpar([7.0, 8.0, 9.0], [80, 95, 70]),
        x_frac=np.array([[0.1, 0.2, 0.3], [0.6, 0.55, 0.45]]),
        species_of=np.array([0, 1]),
        species=[Species("Na", 11), Species("Cl", 17)])
    return out


STRUCTS = _structures()
NOPS = {"rocksalt": 192, "cscl": 48, "perovskite": 48, "skewed": 48,
        "triclinic": 1}


def _port(c):
    return crystal_from_arrays(**crystal_to_arrays(c))


@pytest.mark.parametrize("name", sorted(STRUCTS))
def test_spacegroup_equals_jax_package(name):
    jc = STRUCTS[name]
    jsg, tsg = jc.spacegroup, _port(jc).spacegroup
    assert tsg.nops == jsg.nops == NOPS[name]
    np.testing.assert_array_equal(tsg.rotations, jsg.rotations)
    np.testing.assert_array_equal(tsg.translations, jsg.translations)
    assert tsg.crystal_system == jsg.crystal_system
    assert tsg.nneq == jsg.nneq
    for attr in ("irr_idx", "orbit_of", "mult"):
        np.testing.assert_array_equal(getattr(tsg, attr), getattr(jsg, attr))
    x = np.array([0.13, 0.13, 0.4])
    np.testing.assert_array_equal(tsg.orbit(x), jsg.orbit(x))
    to, tops = tsg.orbit_ops(x)
    jo, jops = jsg.orbit_ops(x)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(tops, jops)
    assert tsg.site_symmetry_order(np.zeros(3)) == \
        jsg.site_symmetry_order(np.zeros(3))


def test_lattice_point_group_and_nosym():
    assert len(lattice_point_group(STRUCTS["cscl"].m_x2c)) == 48
    assert len(lattice_point_group(STRUCTS["triclinic"].m_x2c)) == 2
    c = _port(STRUCTS["rocksalt"])
    c.nosym = True
    sg = c.spacegroup
    assert sg.nops == 1 and sg.nneq == 8 and sg.crystal_system == "triclinic"
    assert c.spacegroup is sg                       # cached
    mol = crystal_from_arrays(np.eye(3) * 20, [[0.5, 0.5, 0.5]], [0],
                              [("O", 8)], ismolecule=True)
    assert mol.spacegroup.crystal_system == "molecule"


@pytest.mark.parametrize("name", ["rocksalt", "skewed", "triclinic"])
def test_distmat_and_identify_atom_equal_jax_package(name):
    jc = STRUCTS[name]
    tc = _port(jc)
    rng = np.random.default_rng(2)
    X = rng.uniform(-1, 2, size=(9, 3))
    Y = rng.uniform(-1, 2, size=(5, 3))
    for cutoff in (None, 1e-2):
        np.testing.assert_array_equal(tc.distmat(X, Y, cutoff=cutoff),
                                      jc.distmat(X, Y, cutoff=cutoff))
    pts = np.concatenate([jc.x_frac + [1.0, -2.0, 0.0] + 1e-3, X])
    tid, td = tc.identify_atom(pts, distmax=0.1)
    jid, jd = jc.identify_atom(pts, distmax=0.1)
    np.testing.assert_array_equal(tid, jid)
    np.testing.assert_array_equal(td, jd)
    assert (tid[:jc.ncel] == np.arange(jc.ncel)).all()
    assert tc.identify_atom(jc.x_cart[0], icrd=tparam.ICRD_CART) == \
        jc.identify_atom(jc.x_cart[0], icrd=tparam.ICRD_CART)
    assert tc.identify_atom(pts[0])[0] == -1         # default 1e-5 radius
