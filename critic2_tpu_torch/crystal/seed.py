"""Structure seeds -> Crystal, for the formats the port reads.

Role of the reference's crystalseedmod (src/crystalseedmod.f90): a seed
holds what a reader parsed (atoms, species, cell or molecule flag); the
Crystal is built from it. The port reads molecular wavefunction files
(.wfn, .wfx, .fchk/.fch/.fck, .molden) as structures; a molecule is
embedded in a border-padded cell. Crystal seeds wait for the structure
readers.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dfield

import numpy as np

from .. import param
from .crystal import Crystal, Species

WFN_EXTENSIONS = (".wfn", ".wfx", ".fchk", ".fch", ".fck", ".molden",
                  ".molden.input")


@dataclass
class CrystalSeed:
    """A molecule as a reader parsed it: Cartesian positions (bohr) in
    x_frac, as in the JAX package's seeds of molecules."""

    x_frac: np.ndarray                   # Cartesian for molecules
    species_of: np.ndarray
    species: list = dfield(default_factory=list)
    name: str = ""
    border: float = 10.0                 # molecule cell border (bohr)

    def to_crystal(self) -> Crystal:
        """Embed the molecule in a big empty cell (reference
        molx0/molborder semantics, src/crystalmod.f90:85-88)."""
        cart = np.atleast_2d(np.asarray(self.x_frac, dtype=float))
        lo = cart.min(axis=0) - self.border
        side = cart.max(axis=0) + self.border - lo
        return Crystal(m_x2c=np.diag(side), x_frac=(cart - lo) / side,
                       species_of=self.species_of, species=self.species,
                       ismolecule=True, molx0=lo,
                       molborder=np.maximum(self.border * 0.5, 0.0) / side)


def is_wfn_path(path: str) -> bool:
    return str(path).lower().endswith(WFN_EXTENSIONS)


def read_wfn_structure(path: str, border: float = 10.0) -> CrystalSeed:
    """Molecule geometry from a wavefunction file (reference MOLECULE
    file.{wfn,wfx,fchk,molden}, src/crystalseedmod.f90 read_mol); species
    in order of first appearance."""
    from ..fields.wfn import Wavefunction

    w = Wavefunction.from_file(path)
    spmap, species, spof = {}, [], []
    for z in np.asarray(w.atz, dtype=int):
        z = int(z)
        if z not in spmap:
            spmap[z] = len(species)
            species.append(Species(param.z_to_symbol(z), z))
        spof.append(spmap[z])
    return CrystalSeed(x_frac=np.asarray(w.atpos, float),
                       species_of=np.asarray(spof), species=species,
                       name=path, border=border)
