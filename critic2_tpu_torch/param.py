"""Element names and the element tables the port's slice uses.

The numeric tables are data, not code: they are read from the JAX
package's ``critic2_tpu/data/element_tables.npz`` by file path (no
import of that package).
"""
from __future__ import annotations

import functools
import os

import numpy as np

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "critic2_tpu", "data")

BOHR_TO_ANGSTROM = 0.529177210903
ANGSTROM_TO_BOHR = 1.0 / BOHR_TO_ANGSTROM

# coordinate-system selectors (reference icrd_*, src/param.f90)
ICRD_CART = 0
ICRD_CRYS = 1

ELEMENTS = [
    "X",
    "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca",
    "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb", "Sr", "Y", "Zr",
    "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In", "Sn",
    "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd",
    "Pm", "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb",
    "Lu", "Hf", "Ta", "W", "Re", "Os", "Ir", "Pt", "Au", "Hg",
    "Tl", "Pb", "Bi", "Po", "At", "Rn", "Fr", "Ra", "Ac", "Th",
    "Pa", "U", "Np", "Pu", "Am", "Cm", "Bk", "Cf", "Es", "Fm",
    "Md", "No", "Lr", "Rf", "Db", "Sg", "Bh", "Hs", "Mt", "Ds",
    "Rg", "Cn", "Nh", "Fl", "Mc", "Lv", "Ts", "Og",
]


def z_to_symbol(z: int) -> str:
    if 0 <= z < len(ELEMENTS):
        return ELEMENTS[z]
    return "X"


@functools.lru_cache(maxsize=None)
def _load_tables() -> dict:
    with np.load(os.path.join(DATA_DIR, "element_tables.npz")) as f:
        return {k: f[k] for k in f.files}


def cutrad(z: int) -> float:
    """Cutoff radius (bohr) beyond which the atomic density of element z is
    below 1e-12 (role of reference src/global.f90 cutrad table)."""
    t = _load_tables()["cutrad"]
    if 1 <= z <= len(t):
        return float(t[z - 1])
    return 0.0


def covalent_radius(z: int) -> float:
    """Covalent radius in bohr (role of reference src/param.F90 atmcov)."""
    t = _load_tables()["atmcov"]
    if 1 <= z <= len(t):
        return float(t[z - 1])
    return 0.0
