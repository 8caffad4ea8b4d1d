"""Constants, element names and the element tables the port uses.

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
PI = np.pi

# coordinate-system selectors (reference icrd_*, src/param.f90)
ICRD_CART = 0
ICRD_CRYS = 1
ICRD_RCRYS = 2

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
SYMBOL_TO_Z = {s.lower(): z for z, s in enumerate(ELEMENTS)}


def symbol_to_z(name: str) -> int:
    """Atomic number from an element symbol or a label like 'Fe1'/'FE_2'.

    Equivalent in role to the reference's zatguess (src/tools_io.f90).
    """
    s = "".join(ch for ch in name.strip() if ch.isalpha())[:2]
    z = SYMBOL_TO_Z.get(s.lower())
    if z is None and s:
        z = SYMBOL_TO_Z.get(s[0].lower())
    return z if z is not None else 0


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


_COVRAD_OVERRIDE: dict = {}


def covalent_radius(z: int) -> float:
    """Covalent radius in bohr (role of reference src/param.F90 atmcov).
    Per-element overrides come from the RADII settings keyword
    (reference atmcov assignment, src/global@proc.f90:596-619)."""
    if z in _COVRAD_OVERRIDE:
        return _COVRAD_OVERRIDE[z]
    t = _load_tables()["atmcov"]
    if 1 <= z <= len(t):
        return float(t[z - 1])
    return 0.0


def set_covalent_radius(z: int, r_bohr: float) -> None:
    """Override an element's covalent radius (RADII keyword)."""
    _COVRAD_OVERRIDE[int(z)] = float(r_bohr)


def atomic_mass(z: int) -> float:
    """Atomic mass in amu (reference src/param.F90 atmass table)."""
    t = _load_tables()["atmass"]
    if 1 <= z <= len(t):
        return float(t[z - 1])
    return 0.0
