"""Structure library: CRYSTAL/MOLECULE LIBRARY <entry>.

Role of the reference's library lookup (src/crystalseedmod@proc.f90
read_library + struct_drivers LIBRARY handling): a .dat file holds named
``structure <name...> ... crystal|molecule ... end ... endstructure``
blocks; the LIBRARY keyword in the input selects one by name. The
shipped tables (data/crystal_library.dat, data/molecule_library.dat) are
the reference's dat/lib/*.dat — pure structure data (prototype crystals
and the G3 molecule set).
"""
from __future__ import annotations

import os

from .. import param
from .seed import CrystalSeed, parse_crystal_env

_DATA = param.DATA_DIR


def library_path(mol: bool = False) -> str:
    return os.path.join(
        _DATA, "molecule_library.dat" if mol else "crystal_library.dat")


def library_entries(mol: bool = False, path: str | None = None) -> list:
    """All entry-name lists in the library file."""
    out = []
    with open(path or library_path(mol)) as fh:
        for line in fh:
            t = line.split("#")[0].split()
            if t and t[0].lower() == "structure":
                out.append([w.lower() for w in t[1:]])
    return out

def load_library_entry(name: str, mol: bool = False,
                       path: str | None = None) -> CrystalSeed:
    """Find ``structure`` block whose name list contains `name` and parse
    its inner crystal/molecule environment."""
    want = name.lower()
    with open(path or library_path(mol)) as fh:
        lines = iter(fh.readlines())
    for raw in lines:
        t = raw.split("#")[0].split()
        if not t or t[0].lower() != "structure":
            continue
        if want not in [w.lower() for w in t[1:]]:
            continue
        for raw2 in lines:
            kw = raw2.split("#")[0].strip().lower()
            if kw in ("crystal", "molecule"):
                seed = parse_crystal_env(lines, mol=(kw == "molecule"))
                seed.name = name
                return seed
            if kw == "endstructure":
                break
        raise ValueError(f"library entry {name} has no structure env")
    raise ValueError(f"structure {name} not found in the library")
