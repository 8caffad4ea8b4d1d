"""3D periodic grid fields: the device tensor and the cube reader.

Role of the reference grid3mod (src/grid3mod.f90): hold the (n1, n2, n3)
scalar data over fractional coordinates and interpolate value, gradient
and Hessian at arbitrary points. The port carries the Gaussian cube
reader and the nearest / trilinear / tricubic interpolants; the other
file formats, the trispline / tristar modes and the FFT-derived grids
raise NotImplementedError.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..config import FDTYPE, resolve_device
from ..ops.interp import interp_batch

MODES = ("nearest", "trilinear", "tricubic", "trispline", "tristar")
DEFAULT_MODE = "tricubic"  # reference mode_default (src/grid3mod.f90:88)


def parse_cube_header(path: str):
    """Returns (x0, voxel_vectors (3,3 columns), n (3,), atoms zs, atom
    cartesians, is-MO flag, byte offset of the data) - all in bohr."""
    with open(path) as f:
        f.readline()
        f.readline()
        toks = f.readline().split()
        nat = int(toks[0])
        x0 = np.array([float(t) for t in toks[1:4]])
        n = np.zeros(3, dtype=int)
        vox = np.zeros((3, 3))
        for i in range(3):
            toks = f.readline().split()
            n[i] = int(toks[0])
            vox[:, i] = [float(t) for t in toks[1:4]]
        ismo = nat < 0
        nat = abs(nat)
        zs = np.zeros(nat, dtype=int)
        pos = np.zeros((nat, 3))
        for i in range(nat):
            toks = f.readline().split()
            zs[i] = int(toks[0])
            pos[i] = [float(t) for t in toks[2:5]]
        offset = f.tell()
    return x0, vox, n, zs, pos, ismo, offset


@dataclass
class Grid3:
    f: torch.Tensor                     # (n1,n2,n3) device tensor
    mode: str = DEFAULT_MODE

    @property
    def n(self):
        return tuple(self.f.shape)

    @property
    def ntot(self):
        return int(np.prod(self.f.shape))

    # ------------------------------------------------------------------
    def setmode(self, mode: str):
        if mode not in MODES:
            raise ValueError(f"unknown interpolation mode {mode}")
        self.mode = mode

    def interp(self, xfrac, nder: int = 2):
        """Batched interpolation at fractional points (N,3).

        Returns (y, yp, ypp) with derivatives w.r.t. fractional coords
        (scaled by n), reference convention (src/grid3mod@proc.f90:1043).
        """
        check_mode_ported(self.mode)
        x = torch.as_tensor(xfrac, dtype=self.f.dtype, device=self.f.device)
        return interp_batch(self.f, torch.atleast_2d(x), mode=self.mode,
                            nder=nder)

    @classmethod
    def from_file(cls, path: str, fmt: str | None = None,
                  device=None) -> "Grid3":
        if fmt is None:
            fmt = detect_grid_format(path)
        if fmt == "cube":
            return cls.read_cube(path, device=device)
        raise NotImplementedError(f"grid format {fmt} is not ported to the "
                                  "torch package yet")

    @classmethod
    def read_cube(cls, path: str, device=None) -> "Grid3":
        """Gaussian cube (reference read_cube, src/grid3mod@proc.f90:396):
        values with the third index fastest -> C-order reshape."""
        _, _, n, _, _, ismo, offset = parse_cube_header(path)
        with open(path) as fh:
            fh.seek(offset)
            if ismo:
                fh.readline()  # MO index line
            data = np.array(fh.read().split(), dtype=np.float64)
        vals = data[: int(np.prod(n))].reshape(tuple(n))
        return cls(torch.as_tensor(vals, dtype=FDTYPE,
                                   device=resolve_device(device)))


def check_mode_ported(mode: str):
    if mode in ("trispline", "tristar"):
        raise NotImplementedError(
            f"interpolation mode {mode} waits for ops/trispline.py, which "
            "is not ported to the torch package yet")


def detect_grid_format(path: str) -> str:
    """File format from the name; only the cube formats are told apart
    here, since no other reader is ported yet."""
    ext = os.path.splitext(os.path.basename(path).lower())[1].lstrip(".")
    if ext in ("cube", "bincube"):
        return ext
    raise ValueError(f"cannot detect grid format of {path}")
