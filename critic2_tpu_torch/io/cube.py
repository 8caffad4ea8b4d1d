"""Gaussian cube file writer (reference write_cube_header/body,
src/nci@proc.f90:22-24 and grid3 writers in src/rhoplot@proc.f90)."""
from __future__ import annotations

import numpy as np
import torch

from .. import config

__all__ = ["write_cube"]


def write_cube(path, data, origin, xmat, zatoms, positions,
               comment1="critic2-tpu cube", comment2="",
               precise: bool | None = None):
    """Write a cube file.

    data: (n1,n2,n3) array or tensor (copied to the host); origin (3,)
    bohr; xmat (3,3) with COLUMNS the step vectors; zatoms (nat,), positions (nat,3) Cartesian bohr.
    precise: E22.14 body values (the reference `precisecube` default,
    src/global@proc.f90:90, write format src/crystalmod@proc.f90:5031);
    False gives the STANDARDCUBE 1p,e12.5 format. None follows the
    config.PRECISECUBE setting.
    """
    if precise is None:
        precise = config.PRECISECUBE
    if isinstance(data, torch.Tensor):
        data = data.detach().cpu().numpy()
    data = np.asarray(data)
    n1, n2, n3 = data.shape
    # one %-format per (i, j) row: lines of six values, the row's tail on
    # a shorter line (the reference's layout), from Python floats
    one = " %22.14E" if precise else " %12.5E"
    row_fmt = (one * 6 + "\n") * (n3 // 6) + \
        ((one * (n3 % 6) + "\n") if n3 % 6 else "")
    with open(path, "w") as f:
        f.write(comment1.rstrip("\n") + "\n")
        f.write(comment2.rstrip("\n") + "\n")
        f.write(f"{len(zatoms):5d} {origin[0]:11.6f} {origin[1]:11.6f} "
                f"{origin[2]:11.6f}\n")
        for i, n in enumerate((n1, n2, n3)):
            v = np.asarray(xmat)[:, i]
            f.write(f"{n:5d} {v[0]:11.6f} {v[1]:11.6f} {v[2]:11.6f}\n")
        for z, p in zip(zatoms, positions):
            f.write(f"{int(z):5d} {float(z):11.6f} {p[0]:11.6f} "
                    f"{p[1]:11.6f} {p[2]:11.6f}\n")
        for row in data.reshape(n1 * n2, n3).tolist():
            f.write(row_fmt % tuple(row))
