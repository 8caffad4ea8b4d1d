"""Polymorphic scalar field with batched evaluation.

Role of the reference fieldmod (src/fieldmod.f90): a field is a crystal
plus one evaluation backend, evaluated through a single dispatch `grd`
that returns value, gradient, Hessian and derived scalars for a whole
batch of points (reference grd, src/fieldmod@proc.f90:613-845): grid
(every grid format, pwc with its Kohn-Sham states included),
promolecular, molecular-wavefunction (wfn), ghost (expression), WIEN2k
and elk LAPW (wien, elk), aiPI (pi) and DFTB+ (dftb) types.

Pipeline per batch (mirrors the reference):
  1. Cartesian -> fractional, wrap to the main cell (periodic)
  2. backend evaluation (device)
  3. rotate grid-frame derivatives to Cartesian (m_c2x^T sandwiches)
  4. optional core augmentation (promolecular core tables, zpsp)
  5. nucleus clamp: zero the gradient on nuclei
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field as dfield

import numpy as np
import torch

from ..config import FDTYPE
from ..ops.eig3 import linmap, sym6_rotation
from .grid3 import Grid3, detect_grid_format
from .promol import PromolEnv, promolecular_soa


@dataclass
class ScalarBatch:
    """Struct-of-arrays result of a batched field evaluation (role of the
    reference scalar_value, src/types.f90:113-148)."""

    f: torch.Tensor             # (N,) value (with core if usecore)
    gf: torch.Tensor            # (N,3) gradient
    hf: torch.Tensor            # (N,3,3) hessian
    fval: torch.Tensor          # (N,) valence-only value
    isnuc: torch.Tensor         # (N,) bool

    @property
    def gfmod(self):
        return torch.sqrt((self.gf * self.gf).sum(-1))

    @property
    def del2f(self):
        return self.hf[..., 0, 0] + self.hf[..., 1, 1] + self.hf[..., 2, 2]


def _ghost_derivs(expr_fn, xT, nder):
    """Value/gradient/Hessian of a batched scalar closure by autograd.

    Points are independent, so d(sum_n f)/dxT gives the per-point
    gradients, and one backward pass of each gradient row (summed over
    the points) gives a row of every point's Hessian. Inside another
    differentiation (a ghost of a ghost) the graph is kept so the outer
    pass differentiates through this one."""
    N = xT.shape[1]
    z3 = torch.zeros((3, N), dtype=FDTYPE, device=xT.device)
    z6 = torch.zeros((6, N), dtype=FDTYPE, device=xT.device)
    if nder < 1:
        return expr_fn(xT), z3, z6
    outer = xT.requires_grad
    x = xT if outer else xT.detach().requires_grad_(True)
    with torch.enable_grad():
        f = expr_fn(x)
        if not f.requires_grad:        # the expression ignores the points
            return f, z3, z6
        (gf,) = torch.autograd.grad(f.sum(), x,
                                    create_graph=outer or nder >= 2)
        if nder < 2:
            return (f, gf, z6) if outer else (f.detach(), gf, z6)
        rows = []
        for i in range(3):
            if not gf.requires_grad:
                rows.append(torch.zeros_like(gf))
                continue
            (hi,) = torch.autograd.grad(gf[i].sum(), x, retain_graph=True,
                                        create_graph=outer,
                                        allow_unused=True)
            rows.append(torch.zeros_like(gf) if hi is None else hi)
    h6 = torch.stack([rows[0][0], rows[1][1], rows[2][2], rows[0][1],
                      rows[0][2], rows[1][2]])
    if outer:
        return f, gf, h6
    return f.detach(), gf.detach(), h6.detach()


def _mt_derivs(mt, xT, nder):
    """Value, gradient (3, N) and Hessian rows (6, N) in the package's
    order [xx, yy, zz, xy, xz, yz] of a WIEN2k or elk evaluator at
    Cartesian points xT (3, N); the evaluator's own rows come as [xx,
    xy, xz, yy, yz, zz]. Zeros stand for the derivatives nder leaves
    out."""
    from .wien import SYM6_FROM_MODULE

    f, gf, h6 = mt.grd(xT.T, nder=nder)
    N = xT.shape[1]
    if gf is None:
        gf = torch.zeros((3, N), dtype=FDTYPE, device=xT.device)
    h6 = (torch.zeros((6, N), dtype=FDTYPE, device=xT.device)
          if h6 is None else h6[SYM6_FROM_MODULE])
    return f, gf, h6


@dataclass
class Field:
    crystal: object
    type: str       # 'grid' | 'promol' | 'wfn' | 'ghost' | 'wien' | 'elk'
    #                 | 'pi' | 'dftb'
    grid: Grid3 | None = None
    promol: PromolEnv | None = None
    wfn: object | None = None       # fields/wfn.Wavefunction
    mt: object | None = None        # fields/wien.WienField, elk.ElkField
    pi: object | None = None        # fields/pi.PiField
    dftb: object | None = None      # fields/dftb.DftbField
    wdevice: torch.device | None = None   # where a wfn/ghost field evaluates
    expr: object = None             # compiled ghost expression
    name: str = ""
    usecore: bool = False
    zpsp: dict = dfield(default_factory=dict)
    typnuc: int = -3
    _coreenv: PromolEnv | None = None
    _evalfns: dict = dfield(default_factory=dict)

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------
    @classmethod
    def promolecular(cls, crystal, name="rho0", fragment=None,
                     device=None) -> "Field":
        return cls(crystal=crystal, type="promol",
                   promol=PromolEnv(crystal, fragment=fragment,
                                    device=device), name=name)

    @classmethod
    def ghost(cls, crystal, expr_fn, name="ghost", *,
              device=None) -> "Field":
        """Expression-backed field (reference ghost fields): expr_fn is a
        compiled expression xT (3, N) -> (N,) (arithmetic.compile_expr);
        derivatives come from autograd. It evaluates on `device` (cuda
        by default)."""
        from ..config import resolve_device

        return cls(crystal=crystal, type="ghost", expr=expr_fn, name=name,
                   wdevice=resolve_device(device))

    @classmethod
    def from_grid(cls, crystal, grid: Grid3, name="", **kw) -> "Field":
        return cls(crystal=crystal, type="grid", grid=grid, name=name, **kw)

    @classmethod
    def from_file(cls, crystal, path: str, fmt: str | None = None,
                  name: str = "", *, device=None, **kw) -> "Field":
        """A field from a file: a grid format (a VASP charge grid is
        divided by the crystal's volume, as the reference does) or a
        molecular wavefunction, on `device` (cuda by default)."""
        if fmt is None:
            try:
                fmt = detect_grid_format(path)
            except ValueError:
                fmt = None
        if fmt in ("cube", "bincube", "vasp", "xsf", "qub", "elk",
                   "siesta", "pwc", "abinit"):
            omega = crystal.volume if fmt == "vasp" else None
            g = Grid3.from_file(path, fmt=fmt, omega=omega, device=device)
            if fmt == "pwc":
                chk = kw.pop("file2", None)
                chkdn = kw.pop("file3", None)
                if chk:
                    g.read_wannier_chk(chk, chkdn)
            return cls.from_grid(crystal, g, name=name or path, **kw)
        base = os.path.basename(path).upper()
        if base.startswith("STATE") and base.endswith(".OUT"):
            from .elk import ElkField

            geom = kw.pop("file2", None)
            if geom is None:
                geom = os.path.join(os.path.dirname(path), "GEOMETRY.OUT")
                if not os.path.exists(geom):
                    raise FileNotFoundError(
                        f"elk field {path} needs GEOMETRY.OUT (pass file2=)")
            return cls(crystal=crystal, type="elk",
                       mt=ElkField.from_files(path, geom, device=device),
                       name=name or path, **kw)
        if base == "DETAILED.XML" or fmt == "dftb":
            from .dftb import DftbField

            binf = kw.pop("file2", None)
            hsdf = kw.pop("file3", None)
            if binf is None:
                binf = os.path.join(os.path.dirname(path), "eigenvec.bin")
            if hsdf is None:
                raise ValueError("dftb field needs the wfc .hsd basis "
                                 "file (LOAD detailed.xml eigenvec.bin "
                                 "wfc.hsd)")
            return cls(crystal=crystal, type="dftb",
                       dftb=DftbField.from_files(crystal, path, binf, hsdf,
                                                 device=device),
                       name=name or path, **kw)
        if base.endswith((".CLMSUM", ".CLMUP", ".CLMDN")) or fmt == "wien":
            from .wien import WienField

            struct = kw.pop("file2", None)
            if struct is None:
                struct = os.path.splitext(path)[0] + ".struct"
                if not os.path.exists(struct):
                    raise FileNotFoundError(
                        f"wien field {path} needs a .struct file "
                        f"(tried {struct}; pass file2=)")
            return cls(crystal=crystal, type="wien",
                       mt=WienField.from_files(path, struct, device=device),
                       name=name or path, **kw)
        return cls.from_wavefunction(crystal, path, name=name,
                                     device=device, **kw)

    @classmethod
    def from_wavefunction(cls, crystal, wfn, name: str = "", device=None,
                          **kw) -> "Field":
        """A wfn field from a Wavefunction or a .wfn/.wfx/.fchk/.molden
        path. A molecule lives in its cell's shifted frame (molx0): the
        wavefunction moves into it so all evaluations share one frame."""
        import copy

        from ..config import resolve_device
        from .wfn import Wavefunction

        if isinstance(wfn, str):
            name = name or wfn
            wfn = Wavefunction.from_file(wfn)
        else:
            wfn = copy.copy(wfn)
            wfn.atpos = np.array(wfn.atpos, dtype=float)
        if crystal.ismolecule and crystal.molx0 is not None:
            wfn.atpos = wfn.atpos - np.asarray(crystal.molx0)
        wfn.reset_caches()
        return cls(crystal=crystal, type="wfn", wfn=wfn,
                   wdevice=resolve_device(device), name=name or "wfn", **kw)

    @property
    def device(self) -> torch.device:
        if self.type == "grid":
            return self.grid.f.device
        if self.type in ("wfn", "ghost"):
            return self.wdevice
        if self.type in ("wien", "elk"):
            return self.mt.device
        if self.type in ("pi", "dftb"):
            return getattr(self, self.type).device
        return self.promol.device

    # ------------------------------------------------------------------
    def set_options(self, interp: str | None = None,
                    core: bool | None = None, zpsp: dict | None = None):
        if interp is not None and self.grid is not None:
            self.grid.setmode(interp)
        if zpsp is not None:
            self.zpsp = dict(zpsp)
        if core is not None:
            self.usecore = core
        self._evalfns.clear()
        self._coreenv = None
        return self

    @property
    def coreenv(self) -> PromolEnv | None:
        if not (self.usecore and self.zpsp):
            return None
        if self._coreenv is None:
            self._coreenv = PromolEnv(self.crystal, zpsp=self.zpsp,
                                      device=self.device)
        return self._coreenv

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def _nucleus_images(self) -> np.ndarray | None:
        """Cartesian nuclei (M, 3) a wrapped point can sit on: the cell's
        atoms and, in a crystal, their 26 neighbouring images."""
        c = self.crystal
        if c.ncel == 0:
            return None
        at = np.asarray(c.x_cart)
        if c.ismolecule:
            return at
        shifts = np.array([[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1)
                           for k in (-1, 0, 1)], dtype=float)
        return (at[None, :, :] + (shifts @ np.asarray(c.m_x2c).T)[:, None, :]
                ).reshape(-1, 3)

    def grd(self, points_cart, nder: int = 2,
            periodic: bool = True) -> ScalarBatch:
        """Batched field evaluation at Cartesian points (N, 3), on the
        field's device."""
        c = self.crystal
        dev = self.device
        v = torch.atleast_2d(torch.as_tensor(points_cart, dtype=FDTYPE,
                                             device=dev))
        m_c2x = torch.as_tensor(np.asarray(c.m_c2x), dtype=FDTYPE,
                                device=dev)
        m_x2c = torch.as_tensor(np.asarray(c.m_x2c), dtype=FDTYPE,
                                device=dev)
        wx = v @ m_c2x.T
        if periodic:
            wx = wx - torch.floor(wx)
        wc = wx @ m_x2c.T

        if self.type == "grid":
            y, yp_frac, ypp_frac = self.grid.interp(wx, nder=nder)
            m = m_c2x.to(y.dtype)
            # rotate to Cartesian (reference :741-742): gf = c2x^T yp,
            # hf = c2x^T ypp c2x
            gf = yp_frac @ m
            hf = torch.einsum("ki,nkl,lj->nij", m, ypp_frac, m)
            f = y
        elif self.type == "promol":
            f, gf, hf = self.promol.eval(wc, nder=nder)
        elif self.type == "wfn":
            f, gf, hf = self.wfn.rho_eval(v, nder=nder)  # molecules: no wrap
        elif self.type == "ghost":
            from ..ops.interp import sym6_to_mat

            f, gfT, h6 = _ghost_derivs(self.expr, v.T, nder)
            gf = gfT.T
            hf = sym6_to_mat(h6)
        elif self.type in ("wien", "elk"):
            from ..ops.interp import sym6_to_mat

            f, gfT, h6 = _mt_derivs(self.mt, wc.T, nder)
            gf = gfT.T
            hf = sym6_to_mat(h6)
        elif self.type == "pi":
            f, gf, hf = self.pi.eval(wc, nder=nder)
        elif self.type == "dftb":
            f, gf, hf, _ = self.dftb.eval(wc, nder=nder)
        else:
            raise ValueError(f"unknown field type {self.type}")

        fval = f
        env = self.coreenv
        if env is not None:
            cf, cg, ch = env.eval(wc, nder=nder)
            f = f + cf
            gf = gf + cg
            hf = hf + ch

        # nucleus clamp (reference :836-838)
        isnuc = self._near_nucleus(wc)
        gf = torch.where(isnuc[:, None], torch.zeros_like(gf), gf)
        return ScalarBatch(f=f, gf=gf, hf=hf, fval=fval, isnuc=isnuc)

    def _near_nucleus(self, wc, eps: float = 1e-5):
        """Mask of points within eps of a nucleus (periodic), on device;
        points are wrapped to the main cell, so the immediate neighbour
        images suffice."""
        imgs = self._nucleus_images()
        if imgs is None:
            return torch.zeros(wc.shape[0], dtype=torch.bool,
                               device=wc.device)
        imgs = torch.as_tensor(imgs, dtype=wc.dtype, device=wc.device)
        d2 = ((wc[:, None, :] - imgs[None, :, :]) ** 2).sum(-1)
        return d2.min(dim=1).values < eps * eps

    def grd0(self, points_cart, periodic: bool = True):
        return self.grd(points_cart, nder=0, periodic=periodic).f

    # ------------------------------------------------------------------
    def eval_fn(self, nder: int = 2, clamp_nuclei: bool = True):
        """SoA closure xT (3, N) cart -> (f (N,), gf (3, N), h6 (6, N))
        over the field's device tensors - the evaluation core consumed by
        the batched Newton search and NCIPLOT. Cached per
        (nder, clamp_nuclei)."""
        key = (nder, clamp_nuclei)
        if key not in self._evalfns:
            self._evalfns[key] = self._build_eval_fn(nder, clamp_nuclei)
        return self._evalfns[key]

    def _build_eval_fn(self, nder: int, clamp_nuclei: bool):
        c = self.crystal
        m_c2x = np.asarray(c.m_c2x)
        m_x2c = np.asarray(c.m_x2c)
        r6 = sym6_rotation(m_c2x)
        ftype = self.type
        promol = self.promol
        env = self.coreenv
        if ftype == "grid":
            grid = self.grid
            dev, dt = grid.f.device, grid.f.dtype
            # build the lazy coefficient grids of the spline modes now,
            # not inside the first evaluation
            if grid.mode == "trispline":
                grid.spline_coeffs
            elif grid.mode == "tristar":
                grid.star_c2
        elif ftype == "wfn":
            dev, dt = self.device, FDTYPE
            wfn = self.wfn
        elif ftype in ("ghost", "wien", "elk", "pi", "dftb"):
            dev, dt = self.device, FDTYPE
            expr_fn, mtfield = self.expr, self.mt
            pifield, dftbfield = self.pi, self.dftb
        else:
            dev, dt = promol.atpos.device, promol.atpos.dtype

        imgsT = None
        imgs = self._nucleus_images() if clamp_nuclei else None
        if imgs is not None:
            imgsT = torch.as_tensor(imgs.T, dtype=dt, device=dev)

        def fn(xT):
            wx = linmap(m_c2x, xT)
            wx = wx - torch.floor(wx)
            wc = linmap(m_x2c, wx)
            if ftype == "grid":
                # scattered tricubic points take the 64-element stencil
                # gather; ops.interp.interp_soa_rows computes the same
                # numbers from whole-row gathers
                y, yp, ypp6 = grid.interp_soa(wx, nder=nder)
                f = y
                gf = linmap(m_c2x.T, yp)
                h6 = linmap(r6, ypp6)
            elif ftype == "wfn":
                # molecules: Cartesian points, no wrap; the dense
                # evaluator whatever the size (the screened one needs a
                # block table per spatial chunk, see analysis/autocp.py)
                f, gf, h6 = wfn.rho_eval_dense(xT, nder=nder)
            elif ftype == "ghost":
                f, gf, h6 = _ghost_derivs(expr_fn, xT, nder)
            elif ftype in ("wien", "elk"):
                f, gf, h6 = _mt_derivs(mtfield, wc, nder)
            elif ftype in ("pi", "dftb"):
                out = (pifield.eval(wc.T, nder=nder) if ftype == "pi"
                       else dftbfield.eval(wc.T, nder=nder))
                f, gf, h = out[0], out[1].T, out[2]
                h6 = torch.stack([h[:, 0, 0], h[:, 1, 1], h[:, 2, 2],
                                  h[:, 0, 1], h[:, 0, 2], h[:, 1, 2]])
            else:
                f, gf, h6 = promolecular_soa(wc, promol.atpos, promol.atspc,
                                             promol.tab, nder=nder)
            if env is not None:
                cf, cg, ch6 = promolecular_soa(wc, env.atpos, env.atspc,
                                               env.tab, nder=nder)
                f, gf, h6 = f + cf, gf + cg, h6 + ch6
            if imgsT is not None and nder >= 1:
                d2 = ((wc[:, :, None] - imgsT[:, None, :]) ** 2).sum(0)
                isnuc = d2.min(dim=1).values < 1e-10
                gf = torch.where(isnuc[None, :], torch.zeros_like(gf), gf)
            return f, gf, h6

        return fn
