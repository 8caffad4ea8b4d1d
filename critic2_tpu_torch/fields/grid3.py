"""3D periodic grid fields: the device tensor and the cube reader.

Role of the reference grid3mod (src/grid3mod.f90): hold the (n1, n2, n3)
scalar data over fractional coordinates and interpolate value, gradient
and Hessian at arbitrary points, and produce the FFT-derived grids
(laplacian, |grad|, Hessian diagonals, Poisson potential). The port
carries the Gaussian cube reader and all five interpolation modes; the
other file formats raise NotImplementedError.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import FDTYPE, resolve_device
from ..ops import fft as fftops
from ..ops.interp import interp_batch, sym6_to_mat

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
    # lazy coefficient grids of the trispline and tristar modes
    _spl: torch.Tensor = field(default=None, repr=False, compare=False)
    _star_c2: torch.Tensor = field(default=None, repr=False, compare=False)

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
        # the coefficient grids of a mode that is left are released (8
        # and 3 times the grid's size); coming back builds them again
        if mode != "trispline":
            self._spl = None
        if mode != "tristar":
            self._star_c2 = None

    @property
    def spline_coeffs(self):
        """Lazy tensor-product spline coefficient grids (trispline),
        (8, n1, n2, n3) on the grid's device."""
        if self._spl is None:
            from ..ops.trispline import spline_coeffs

            self._spl = spline_coeffs(self.f)
        return self._spl

    @property
    def star_c2(self):
        """Lazy per-axis curvature grids of the reference star scheme
        (init_trispline, src/grid3mod@proc.f90:2167-2274)."""
        if self._star_c2 is None:
            from ..ops.trispline import star_c2

            self._star_c2 = star_c2(self.f)
        return self._star_c2

    def interp_soa(self, xfracT, nder: int = 2):
        """Batch-last interpolation at fractional points (3, N) in the
        grid's mode: (y (N,), yp (3, N), ypp6 (6, N))."""
        if self.mode == "trispline":
            from ..ops.trispline import trispline_soa

            return trispline_soa(self.spline_coeffs, xfracT, nder=nder)
        if self.mode == "tristar":
            from ..ops.trispline import trispline_star_soa

            return trispline_star_soa(self.f, self.star_c2, xfracT,
                                      nder=nder)
        from ..ops.interp import interp_soa

        return interp_soa(self.f, xfracT, mode=self.mode, nder=nder)

    def interp(self, xfrac, nder: int = 2):
        """Batched interpolation at fractional points (N,3).

        Returns (y, yp, ypp) with derivatives w.r.t. fractional coords
        (scaled by n), reference convention (src/grid3mod@proc.f90:1043).
        """
        x = torch.atleast_2d(torch.as_tensor(xfrac, dtype=self.f.dtype,
                                             device=self.f.device))
        if self.mode in ("trispline", "tristar"):
            y, ypT, ypp6 = self.interp_soa(x.T, nder=nder)
            return y, ypT.T, sym6_to_mat(ypp6)
        return interp_batch(self.f, x, mode=self.mode, nder=nder)

    # ------------------------------------------------------------------
    # FFT-derived grids (reference ifformat_as_* computed fields)
    # ------------------------------------------------------------------
    def laplacian(self, m_x2c) -> "Grid3":
        return Grid3(fftops.laplacian(self.f, m_x2c))

    def gradrho(self, m_x2c) -> "Grid3":
        return Grid3(fftops.gradrho(self.f, m_x2c))

    def hxx(self, m_x2c, ix: int) -> "Grid3":
        return Grid3(fftops.hxx(self.f, m_x2c, ix))

    def pot(self, m_x2c, isry: bool = False) -> "Grid3":
        return Grid3(fftops.pot(self.f, m_x2c, isry=isry))

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


def detect_grid_format(path: str) -> str:
    """File format from the name; only the cube formats are told apart
    here, since no other reader is ported yet."""
    ext = os.path.splitext(os.path.basename(path).lower())[1].lstrip(".")
    if ext in ("cube", "bincube"):
        return ext
    raise ValueError(f"cannot detect grid format of {path}")
