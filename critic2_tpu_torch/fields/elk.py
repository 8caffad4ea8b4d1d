"""Elk files: the GEOMETRY.OUT reader.

Role of the reference's elk_geometry (src/elk_private@proc.f90:289-330).
The port carries only `read_geometry`, which the elk structure reader
needs; the elk LAPW density field (STATE.OUT) waits for queue 1 item 4
of the roadmap.
"""
from __future__ import annotations

import numpy as np

__all__ = ["read_geometry"]


def read_geometry(path: str) -> dict:
    """Parse elk GEOMETRY.OUT (reference elk_geometry,
    src/elk_private@proc.f90:289-330): lattice vectors (columns of x2c)
    and the species/atom list."""
    lines = [ln.rstrip() for ln in open(path)]
    i = 0

    def seek(tag):
        nonlocal i
        while i < len(lines) and not lines[i].strip().startswith(tag):
            i += 1
        i += 1

    seek("avec")
    x2c = np.zeros((3, 3))
    for j in range(3):
        x2c[:, j] = [float(v) for v in lines[i + j].split()[:3]]
    seek("atoms")
    nspecies = int(lines[i].split()[0])
    i += 1
    species, natoms, pos = [], [], []
    for _ in range(nspecies):
        name = lines[i].split()[0].strip("'\"")
        species.append(name.replace(".in", ""))
        i += 1
        na = int(lines[i].split()[0])
        i += 1
        nat_sp = []
        for _ in range(na):
            nat_sp.append([float(v) for v in lines[i].split()[:3]])
            i += 1
        natoms.append(na)
        pos.append(np.asarray(nat_sp))
    return {"x2c": x2c, "species": species, "natoms": natoms,
            "pos_frac": pos}
