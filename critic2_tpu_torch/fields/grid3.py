"""3D periodic grid fields: the device tensor and the grid readers.

Role of the reference grid3mod (src/grid3mod.f90): hold the (n1, n2, n3)
scalar data over fractional coordinates, read the volumetric file
formats (cube, bincube, VASP CHGCAR/CHG/ELFCAR, xsf, qub, SIESTA, abinit,
elk), interpolate value, gradient and Hessian at arbitrary points, and
produce the FFT-derived grids (laplacian, |grad|, Hessian diagonals,
Poisson potential).

Host side: file parsing (NumPy), the same parsers as the JAX package's,
so both read the same doubles from the same file. Every reader hands the
device a C-contiguous float64 tensor (the Fortran-ordered formats are
copied to C order first: the kernels and the interpolators take the
layout as given). A pwc grid is the density built on the device from
the file's Kohn-Sham states (fields/qe.py), which it keeps as `qe`.
"""
from __future__ import annotations

import os
import re
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import resolve_device
from ..crystal.seed import parse_cube_header
from ..ops import fft as fftops
from ..ops.interp import interp_batch, sym6_to_mat

MODES = ("nearest", "trilinear", "tricubic", "trispline", "tristar")
DEFAULT_MODE = "tricubic"  # reference mode_default (src/grid3mod.f90:88)


@dataclass
class Grid3:
    f: torch.Tensor                     # (n1,n2,n3) device tensor
    mode: str = DEFAULT_MODE
    qe: object = None                   # QEData (pwc KS states + Wannier)
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

    # ------------------------------------------------------------------
    # readers (host). Formats follow the reference grid3mod readers.
    # ------------------------------------------------------------------
    @classmethod
    def from_file(cls, path: str, fmt: str | None = None,
                  omega: float | None = None, *, device=None,
                  **kw) -> "Grid3":
        if fmt is None:
            fmt = detect_grid_format(path)
        readers = {"cube": cls.read_cube, "xsf": cls.read_xsf,
                   "elk": cls.read_elk, "qub": cls.read_qub,
                   "bincube": cls.read_bincube, "siesta": cls.read_siesta,
                   "pwc": cls.read_pwc, "abinit": cls.read_abinit}
        if fmt == "vasp":
            return cls.read_vasp(path, omega=omega, device=device)
        if fmt in readers:
            return readers[fmt](path, device=device)
        raise NotImplementedError(f"grid format {fmt}")

    @classmethod
    def _from_host(cls, arr, device=None) -> "Grid3":
        """The grid of a host array: a fresh C-ordered float64 copy (the
        readers' arrays may be Fortran-ordered or read-only views of a
        file buffer) on `device`, cuda by default."""
        host = np.array(arr, dtype=np.float64, order="C")
        return cls(torch.from_numpy(host).to(resolve_device(device)))

    @classmethod
    def read_abinit(cls, path: str, *, device=None) -> "Grid3":
        """Abinit binary _DEN/_POT/_ELF (reference read_abinit,
        src/grid3mod@proc.f90:536-574, header via abinit_private)."""
        from ..io.abinit import read_den

        _, g = read_den(path)
        return cls._from_host(g, device)

    @classmethod
    def read_pwc(cls, path: str, *, device=None) -> "Grid3":
        """QE pw2critic.x pwc file: electron density grid + KS states for
        Wannier delocalization indices (reference read_pwc,
        src/grid3mod@proc.f90:734-852), both on `device`."""
        from .qe import read_pwc as _read

        qe, rho = _read(path, device=device)
        return cls(rho.contiguous(), qe=qe)

    def read_wannier_chk(self, fileup: str, filedn: str | None = None):
        """Attach wannier90 chk data (src/grid3mod@proc.f90:899-1038)."""
        from .qe import read_wannier_chk as _read

        if self.qe is None:
            raise ValueError("wannier chk requires a pwc-loaded grid")
        _read(self.qe, fileup, filedn)

    @classmethod
    def read_cube(cls, path: str, *, device=None) -> "Grid3":
        """Gaussian cube (reference read_cube, src/grid3mod@proc.f90:396):
        values with the third index fastest -> C-order reshape."""
        _, _, n, _, _, ismo, offset = parse_cube_header(path)
        with open(path) as fh:
            fh.seek(offset)
            if ismo:
                fh.readline()  # MO index line
            data = np.array(fh.read().split(), dtype=np.float64)
        vals = data[: int(np.prod(n))].reshape(tuple(n))
        return cls._from_host(vals, device)

    @classmethod
    def read_bincube(cls, path: str, *, device=None) -> "Grid3":
        """critic2 binary cube (reference read_bincube,
        src/grid3mod@proc.f90:445-486): Fortran records
        [nat, x0(3)], [n(3), xd(3,3)], nat x [iz, q, x(3)], [f]."""
        fr = _FortranRecords(path)
        rec = fr.record()
        nat = abs(int(np.frombuffer(rec[:4], dtype=np.int32)[0]))
        rec = fr.record()
        n = np.frombuffer(rec[:12], dtype=np.int32)
        for _ in range(nat):
            fr.record()
        data = fr.record(dtype=np.float64)
        fr.close()
        # stored in Fortran order f(n1,n2,n3)
        return cls._from_host(data.reshape(tuple(n), order="F"), device)

    @classmethod
    def read_siesta(cls, path: str, *, device=None) -> "Grid3":
        """siesta RHO/LDOS/VT (reference read_siesta,
        src/grid3mod@proc.f90:489-533): records [cell 3x3 dp],
        [n(3), nspin], then nspin*n3*n2 records of n1 float32 (spin
        channels summed)."""
        fr = _FortranRecords(path)
        fr.record()                                  # cell (unused here)
        rec = fr.record(dtype=np.int32)
        n1, n2, n3, nspin = (int(v) for v in rec[:4])
        f = np.zeros((n1, n2, n3))
        for _ in range(nspin):
            for iz in range(n3):
                for iy in range(n2):
                    f[:, iy, iz] += fr.record(dtype=np.float32)[:n1]
        fr.close()
        return cls._from_host(f, device)

    def write_bincube(self, path: str, crystal=None):
        """Write the critic2 binary cube format."""
        n = tuple(self.f.shape)
        with open(path, "wb") as fh:
            def rec(raw: bytes):
                fh.write(np.int32(len(raw)).tobytes())
                fh.write(raw)
                fh.write(np.int32(len(raw)).tobytes())

            nat = crystal.ncel if crystal is not None else 0
            molx0 = (np.asarray(getattr(crystal, "molx0", None))
                     if crystal is not None and
                     getattr(crystal, "molx0", None) is not None
                     else np.zeros(3))
            rec(np.int32(nat).tobytes() + molx0.tobytes())
            xd = (np.asarray(crystal.m_x2c) / np.asarray(n)[None, :]
                  if crystal is not None else np.eye(3))
            # Fortran column-major layout: xd(:,i) = step vector i
            # (reference writegrid_cube, src/crystalmod@proc.f90:4999)
            rec(np.asarray(n, np.int32).tobytes()
                + np.asarray(xd, order="F").tobytes(order="F"))
            if crystal is not None:
                for i in range(nat):
                    z = crystal.species[crystal.species_of[i]].z
                    rec(np.int32(z).tobytes() + np.float64(0.0).tobytes()
                        + np.asarray(crystal.x_cart[i] + molx0).tobytes())
            # the transpose of a C-ordered grid is its Fortran-ordered
            # flat form
            rec(self.f.detach().to("cpu", torch.float64).numpy()
                .T.tobytes(order="C"))

    @classmethod
    def read_vasp(cls, path: str, omega: float | None = None, *,
                  device=None) -> "Grid3":
        """VASP CHGCAR/CHG/ELFCAR (reference read_vasp,
        src/grid3mod@proc.f90:577): first index fastest (Fortran order);
        CHGCAR-style charge grids divide by the cell volume omega (by
        default the volume of the file's own header)."""
        with open(path, "rb") as fh:
            data = fh.read()
        # find blank line after the header block
        m = re.search(rb"\n[ \t]*\n", data)
        if m is None:
            raise ValueError(f"no grid block found in {path}")
        tail = data[m.end():]
        n = tuple(int(t) for t in tail.split(None, 3)[:3])
        grid = _numbers(tail, 3 + n[0] * n[1] * n[2])[3:].reshape(
            n, order="F")
        if omega is None:
            from ..crystal.seed import read_poscar

            seed = read_poscar(path)
            omega = abs(np.linalg.det(seed.m_x2c))
        grid = grid / omega
        return cls._from_host(grid, device)

    @classmethod
    def read_xsf(cls, path: str, *, device=None) -> "Grid3":
        """xsf 3D datagrid (reference read_xsf): general-grid periodic
        convention - xsf stores n+1 points per axis (endpoint duplicated),
        we drop the last plane."""
        with open(path) as fh:
            lines = fh.read().splitlines()
        i = 0
        while i < len(lines) and "BEGIN_DATAGRID_3D" not in lines[i].upper():
            i += 1
        if i == len(lines):
            raise ValueError(f"no 3D datagrid in {path}")
        n = [int(t) for t in lines[i + 1].split()[:3]]
        # skip origin + 3 spanning vectors
        vals = []
        j = i + 6
        while j < len(lines) and "END_DATAGRID" not in lines[j].upper():
            vals.extend(float(t) for t in lines[j].split())
            j += 1
        arr = np.array(vals[: n[0] * n[1] * n[2]]).reshape(n, order="F")
        return cls._from_host(arr[: n[0] - 1, : n[1] - 1, : n[2] - 1],
                              device)

    @classmethod
    def read_qub(cls, path: str, *, device=None) -> "Grid3":
        """aimpac qub (reference read_qub): n1 n2 n3 then values, first
        index fastest."""
        with open(path, "rb") as fh:
            data = fh.read()
        n = tuple(int(t) for t in data.split(None, 3)[:3])
        vals = _numbers(data, 3 + n[0] * n[1] * n[2])[3:]
        return cls._from_host(vals.reshape(n, order="F"), device)

    @classmethod
    def read_elk(cls, path: str, *, device=None) -> "Grid3":
        """elk 3D grid file (reference read_elk): n1 n2 n3 then rows of
        x y z value with first index fastest."""
        with open(path, "rb") as fh:
            data = fh.read()
        n = tuple(int(t) for t in data.split(None, 3)[:3])
        ntot = n[0] * n[1] * n[2]
        arr = _numbers(data, 3 + 4 * ntot)[3:].reshape(ntot, 4)
        return cls._from_host(arr[:, 3].reshape(n, order="F"), device)


def _numbers(data: bytes, count: int) -> np.ndarray:
    """The first `count` whitespace-separated numbers of `data` as
    float64: the same correctly rounded doubles as float() of each token,
    without a Python object per token (a 256^3 CHGCAR holds 16.8M). The
    tokens are counted first, so that a short file raises instead of
    being padded, and text after them (a CHGCAR's augmentation block) is
    never parsed."""
    b = np.frombuffer(data, dtype=np.uint8)
    space = (b == 32) | ((b >= 9) & (b <= 13))
    starts = np.flatnonzero(space[:-1] & ~space[1:]) + 1
    if len(b) and not space[0]:
        starts = np.concatenate([[0], starts])
    vals = np.zeros(0)
    if len(starts) >= count:
        end = int(starts[count]) if len(starts) > count else len(b)
        # an unreadable token ends the parse early: numpy warns (newer
        # releases raise ValueError), and the count below refuses it
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            try:
                vals = np.fromstring(data[:end], dtype=np.float64, sep=" ")
            except ValueError:
                pass
    if len(vals) != count:
        raise ValueError(f"grid file holds {len(vals)} readable numbers "
                         f"of the {count} expected")
    return vals


def detect_grid_format(path: str) -> str:
    base = os.path.basename(path).lower()
    ext = os.path.splitext(base)[1].lstrip(".")
    if ext == "cube":
        return "cube"
    if ext == "bincube":
        return "bincube"
    if base.startswith(("chgcar", "chg", "elfcar", "aeccar")) or ext == "vasp":
        return "vasp"
    if ext in ("xsf", "axsf"):
        return "xsf"
    if ext == "qub":
        return "qub"
    if ext == "pwc":
        return "pwc"
    up = os.path.basename(path).upper()
    if up.endswith(("_DEN", "_POT", "_ELF", "_VHA", "_VHXC", "_VXC",
                    "_LDEN", "_KDEN", "_PAWDEN")) or ".DEN" in up:
        return "abinit"
    if ext in ("rho", "ldos", "vt", "vh", "drho", "bader"):
        return "siesta"
    if base.endswith(("rho3d.out", "elf3d.out", ".out")) and "3d" in base:
        return "elk"
    raise ValueError(f"cannot detect grid format of {path}")


class _FortranRecords:
    """Sequential Fortran unformatted records (4-byte markers)."""

    def __init__(self, path):
        self.fh = open(path, "rb")

    def record(self, dtype=None, count=-1):
        head = np.fromfile(self.fh, dtype=np.int32, count=1)
        if len(head) == 0:
            raise EOFError("no more records")
        nbytes = int(head[0])
        raw = self.fh.read(nbytes)
        tail = np.fromfile(self.fh, dtype=np.int32, count=1)
        if len(tail) == 0 or int(tail[0]) != nbytes:
            raise ValueError("corrupt Fortran record")
        if dtype is None:
            return raw
        return np.frombuffer(raw, dtype=dtype, count=count)

    def close(self):
        self.fh.close()
