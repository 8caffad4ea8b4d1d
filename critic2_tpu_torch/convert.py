"""Carry state across from the JAX package as plain numpy arrays.

A structure travels as m_x2c (3,3), x_frac (ncel,3), species_of (ncel,)
and species [(name, Z)]; a grid field as its (n1,n2,n3) array. From them
the port builds its own Crystal, Field and System, so both packages
compute on identical inputs. Nothing here imports the JAX package: the
caller reads the arrays off its objects (``crystal_to_arrays`` works on
either package's Crystal, since both carry the same attributes).
"""
from __future__ import annotations

import numpy as np
import torch

from .config import FDTYPE, resolve_device
from .crystal.crystal import Crystal, Species


def crystal_to_arrays(crystal) -> dict:
    """The numpy form of a Crystal of either package."""
    return {"m_x2c": np.array(crystal.m_x2c, dtype=float),
            "x_frac": np.array(crystal.x_frac, dtype=float),
            "species_of": np.array(crystal.species_of, dtype=int),
            "species": [(str(s.name), int(s.z)) for s in crystal.species]}


def crystal_from_arrays(m_x2c, x_frac, species_of, species) -> Crystal:
    """The port's Crystal from the numpy form."""
    return Crystal(m_x2c=np.array(m_x2c, dtype=float),
                   x_frac=np.array(x_frac, dtype=float),
                   species_of=np.array(species_of, dtype=int),
                   species=[Species(str(n), int(z)) for n, z in species])


def system_from_arrays(m_x2c, x_frac, species_of, species, grid=None,
                       name: str = "grid", device=None):
    """The port's System: promolecular field 0 and, when `grid` is given,
    that grid as field 1 (the reference field), all on `device` (cuda by
    default)."""
    from .fields.field import Field
    from .fields.grid3 import Grid3
    from .system import System

    c = crystal_from_arrays(m_x2c, x_frac, species_of, species)
    s = System.from_structure(c, device=device)
    if grid is not None:
        g = torch.tensor(np.asarray(grid), dtype=FDTYPE,
                         device=resolve_device(device))
        s.load_field(Field.from_grid(c, Grid3(g), name=name))
    return s
