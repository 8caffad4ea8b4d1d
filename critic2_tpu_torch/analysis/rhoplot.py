"""POINT / LINE / PLANE / CUBE drivers.

Role of the reference rhoplot (src/rhoplot@proc.f90:68,148,356,645):
evaluate a field or expression at a point, along a segment, on a plane
(with contour/gnuplot emission) or on a 3D grid (cube/vasp/xsf output).

Evaluation is chunked batched work on the system's device (the CUBE
nodes are built there too); the writers are host-side. Coordinates:
crystallographic fractions for crystals, internal Cartesian bohr for
molecules (callers shift by crystal.molx0 for user frames, as the
reference does at the CLI boundary).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import FDTYPE, resolve_device
from ..ops.eig3 import eigvalsh3

__all__ = ["point", "line", "plane", "cube", "cube_states", "grdvec"]

_DERIV_SELECT = ("f", "gx", "gy", "gz", "gmod", "xx", "xy", "xz", "yy",
                 "yz", "zz", "lap")


@dataclass
class PointReport:
    x: np.ndarray            # fractional
    r: np.ndarray            # Cartesian
    f: float
    gf: np.ndarray
    hf: np.ndarray
    gfmod: float
    del2f: float
    eig: np.ndarray
    ellipticity: float | None = None

    def __str__(self):
        lines = [
            f"* POINT {self.x[0]:.6f} {self.x[1]:.6f} {self.x[2]:.6f}",
            f"  Field value (f): {self.f:.8e}",
            f"  Gradient norm (|grad f|): {self.gfmod:.8e}",
            f"  Laplacian (del2 f): {self.del2f:.8e}",
            f"  Hessian eigenvalues: " + " ".join(
                f"{v:.8e}" for v in self.eig),
        ]
        if self.ellipticity is not None:
            lines.append(f"  Ellipticity (l1/l2 - 1): {self.ellipticity:.8e}")
        return "\n".join(lines)


def _resolve_points(system, pts_frac):
    c = system.crystal
    x = np.atleast_2d(np.asarray(pts_frac, dtype=float))
    return x, x @ np.asarray(c.m_x2c).T


def point(system, x_frac, field=None) -> PointReport:
    """Properties at one point (reference rhoplot_point)."""
    resolve_device(system.device)
    f = system.field(field) if field is not None else system.ref
    x, cart = _resolve_points(system, x_frac)
    res = f.grd(cart, nder=2)
    hf = res.hf[0].to(FDTYPE)
    eig = eigvalsh3(hf[None])[0].cpu().numpy()
    ell = None
    if abs(eig[1]) > 1e-30:
        ell = float(eig[0] / eig[1] - 1.0)
    return PointReport(
        x=x[0], r=cart[0], f=float(res.f[0]), gf=res.gf[0].cpu().numpy(),
        hf=hf.cpu().numpy(), gfmod=float(res.gfmod[0]),
        del2f=float(res.del2f[0]), eig=eig, ellipticity=ell)


def _eval_what(system, field, what, cart):
    """A derivative selector or an expression at Cartesian points
    (numpy or a tensor, (N, 3)): (N,) f64 tensor on the device."""
    if what not in _DERIV_SELECT:
        return system.eval_expr(what, cart)
    f = system.field(field) if field is not None else system.ref
    nder = 0 if what == "f" else (1 if what.startswith("g") else 2)
    res = f.grd(cart, nder=nder)
    if what == "f":
        return res.f
    if what == "gmod":
        return res.gfmod
    if what in ("gx", "gy", "gz"):
        return res.gf[:, "xyz".index(what[1])]
    if what == "lap":
        return res.del2f
    i, j = "xyz".index(what[0]), "xyz".index(what[1])
    return res.hf[:, i, j]


def line(system, x0, x1, npts: int = 201, field=None, what: str = "f",
         file: str | None = None):
    """Field values along a segment (reference rhoplot_line).

    Returns (t (n,), dist (n,), values (n,)) numpy; optionally writes a
    .dat.
    """
    resolve_device(system.device)
    x0 = np.asarray(x0, dtype=float)
    x1 = np.asarray(x1, dtype=float)
    t = np.linspace(0.0, 1.0, npts)
    pts = x0[None, :] + t[:, None] * (x1 - x0)[None, :]
    _, cart = _resolve_points(system, pts)
    vals = _eval_what(system, field, what, cart).cpu().numpy()
    dist = np.linalg.norm(cart - cart[0], axis=1)
    if file:
        np.savetxt(file, np.stack([dist, vals], axis=1),
                   header=f"LINE {what}: distance value")
    return t, dist, vals


def _write_gnu(root, mode, nx, ny, vals, nctr=20, logscale=False):
    """Emit a gnuplot driver script next to the .dat (reference
    contour/relief/colormap writers, src/rhoplot@proc.f90:1508-1699)."""
    lines = [f'set output "{root}.eps"', "set terminal postscript eps"]
    if mode == "contour":
        lo, hi = float(np.nanmin(vals)), float(np.nanmax(vals))
        if logscale and lo > 0:
            levels = np.geomspace(max(lo, 1e-8), hi, nctr)
        else:
            levels = np.linspace(lo, hi, nctr)
        lvl = ", ".join(f"{v:.6g}" for v in levels)
        lines += ["set contour base", "unset surface",
                  f"set cntrparam levels discrete {lvl}",
                  "set view map", f'splot "{root}.dat" w l notitle']
    elif mode == "relief":
        lines += ["set hidden3d", "set view 60,30",
                  f'splot "{root}.dat" w l notitle']
    else:                        # colormap
        lines += ["set view map", "set pm3d at b",
                  f'splot "{root}.dat" w pm3d notitle']
    with open(root + ".gnu", "w") as fh:
        fh.write("\n".join(lines) + "\n")


def plane(system, x0, x1, x2, nx: int = 101, ny: int = 101, field=None,
          what: str = "f", file: str | None = None,
          emit: str | None = None, nctr: int = 20,
          logscale: bool = False):
    """Field values on a plane patch spanned by x1-x0, x2-x0 (reference
    rhoplot_plane). Returns (u, v, vals (nx, ny)); optional gnuplot .dat
    plus a .gnu driver when emit is "contour"/"relief"/"colormap".
    """
    resolve_device(system.device)
    x0, x1, x2 = (np.asarray(v, dtype=float) for v in (x0, x1, x2))
    u = np.linspace(0, 1, nx)
    v = np.linspace(0, 1, ny)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    pts = (x0[None, :] + uu.ravel()[:, None] * (x1 - x0)[None, :]
           + vv.ravel()[:, None] * (x2 - x0)[None, :])
    _, cart = _resolve_points(system, pts)
    vals = _eval_what(system, field, what, cart).cpu().numpy().reshape(
        nx, ny)
    if file:
        with open(file, "w") as fh:
            fh.write(f"# PLANE {what}\n")
            for i in range(nx):
                for j in range(ny):
                    fh.write(f"{u[i]:14.8f} {v[j]:14.8f} "
                             f"{vals[i, j]:18.10e}\n")
                fh.write("\n")
        if emit:
            root = file[:-4] if file.endswith(".dat") else file
            _write_gnu(root, emit, nx, ny, vals, nctr=nctr,
                       logscale=logscale)
    return u, v, vals


def grdvec(system, x0, x1, x2, cpl=None, nseed: int = 8,
           nx: int = 51, ny: int = 51, file: str | None = None,
           nrec: int = 250):
    """GRDVEC: 2D gradient-path map on a plane patch with a contour
    backdrop (reference rhoplot grdvec machinery, src/rhoplot@proc.f90).

    Traces uphill and downhill paths from in-plane CPs (or a uniform seed
    grid when no CP list is given), projects them onto the plane, and
    returns (contour (nx, ny), paths [list of (L, 2) plane coords]).
    Writes a gnuplot-ready .dat when `file` is given.
    """
    from ..ops.ode import trace_paths_recorded

    c = system.crystal
    x0, x1, x2 = (np.asarray(v, dtype=float) for v in (x0, x1, x2))
    u_vec = (x1 - x0) @ np.asarray(c.m_x2c).T
    v_vec = (x2 - x0) @ np.asarray(c.m_x2c).T
    o_cart = x0 @ np.asarray(c.m_x2c).T
    # orthonormal plane basis
    eu = u_vec / np.linalg.norm(u_vec)
    ev = v_vec - (v_vec @ eu) * eu
    ev /= np.linalg.norm(ev)

    _, _, vals = plane(system, x0, x1, x2, nx=nx, ny=ny)

    # seeds: in-plane CPs (within 0.2 bohr of the plane), else a grid
    seeds = []
    if cpl is not None:
        for cp in cpl.cps:
            if cp.isnuc:
                continue
            d = cp.r - o_cart
            off = d - (d @ eu) * eu - (d @ ev) * ev
            if np.linalg.norm(off) < 0.2:
                seeds.append(cp.r)
    if not seeds:
        uu, vv = np.meshgrid(np.linspace(0.1, 0.9, nseed),
                             np.linspace(0.1, 0.9, nseed))
        seeds = [o_cart + a * u_vec + b * v_vec
                 for a, b in zip(uu.ravel(), vv.ravel())]
    seeds = np.asarray(seeds)

    f = system.ref
    fn = f.eval_fn(nder=1)
    # uphill paths capture at nuclei; downhill molecular paths stop at
    # the molecular cell border (reference gradient termination,
    # src/fieldmod@proc.f90:2158-2210) - both also spare the recorded
    # tracer its full step budget
    from .flux import _nucleus_targets

    tgt = _nucleus_targets(c)
    if len(tgt) == 0:
        tgt = None
    rt = np.full(len(tgt), 0.2) if tgt is not None else None
    seedsT = torch.as_tensor(seeds, dtype=FDTYPE, device=f.device)
    paths2d = []
    for iup in (1, -1):
        mol = c.ismolecule and iup < 0
        paths, _, _ = trace_paths_recorded(
            fn, seedsT, nrec=nrec, iup=iup,
            targets=tgt if iup > 0 else None,
            rterm=rt if iup > 0 else None,
            m_c2x=c.m_c2x if mol else None,
            molborder=c.molborder if mol else None)
        for p in paths:
            d = p - o_cart[None, :]
            paths2d.append(np.stack([d @ eu, d @ ev], axis=1))

    if file:
        with open(file, "w") as fh:
            fh.write("# GRDVEC contour block (u v f), then paths\n")
            for i in range(nx):
                for j in range(ny):
                    du = (i / (nx - 1)) * (u_vec @ eu)
                    dv = (j / (ny - 1)) * np.linalg.norm(
                        v_vec - (v_vec @ eu) * eu)
                    fh.write(f"{du:14.8f} {dv:14.8f} "
                             f"{vals[i, j]:18.10e}\n")
                fh.write("\n")
            fh.write("\n\n# gradient paths\n")
            for p in paths2d:
                for row in p:
                    fh.write(f"{row[0]:14.8f} {row[1]:14.8f}\n")
                fh.write("\n")
    return vals, paths2d


def cube(system, n=(64, 64, 64), origin=(0.0, 0.0, 0.0), lengths=None,
         field=None, what: str = "f", file: str | None = None,
         block: int = 1 << 16):
    """Field/expression on a 3D grid over the cell (reference
    rhoplot_cube), the nodes built and evaluated on the system's device
    `block` at a time. Returns the (n1,n2,n3) f64 tensor; optional cube
    (or bincube, xsf, CHGCAR) file.
    """
    dev = resolve_device(system.device)
    c = system.crystal
    n1, n2, n3 = (int(v) for v in n)
    origin = np.asarray(origin, dtype=float)
    if lengths is None:
        lengths = np.ones(3)
    lengths = np.asarray(lengths, dtype=float)
    N = n1 * n2 * n3
    org = torch.as_tensor(origin, dtype=FDTYPE, device=dev)
    lng = torch.as_tensor(lengths, dtype=FDTYPE, device=dev)
    m = torch.as_tensor(np.asarray(c.m_x2c), dtype=FDTYPE, device=dev)
    out = torch.empty(N, dtype=FDTYPE, device=dev)
    for lo in range(0, N, block):
        idx = torch.arange(lo, min(N, lo + block), device=dev)
        frac = torch.stack([(idx // (n2 * n3)).to(FDTYPE) / n1,
                            ((idx // n3) % n2).to(FDTYPE) / n2,
                            (idx % n3).to(FDTYPE) / n3], dim=1)
        cart = (org[None, :] + frac * lng[None, :]) @ m.T
        out[lo:lo + cart.shape[0]] = _eval_what(system, field, what, cart)
    data = out.reshape(n1, n2, n3)
    if file:
        write_grid_file(c, data, file, origin=origin, lengths=lengths,
                        what=what)
    return data


def write_grid_file(c, data, file, origin=(0.0, 0.0, 0.0),
                    lengths=(1.0, 1.0, 1.0), what: str = "f"):
    """Grid output dispatch by extension (reference rhoplot_cube FILE
    outputs, src/rhoplot@proc.f90:356-645): .cube, .bincube, .xsf, and
    VASP CHGCAR-style files. `data` is an array or a tensor."""
    if isinstance(data, torch.Tensor):
        data = data.detach().cpu().numpy()
    n1, n2, n3 = data.shape
    origin = np.asarray(origin, dtype=float)
    lengths = np.asarray(lengths, dtype=float)
    low = file.lower()
    base = low.rsplit("/", 1)[-1]
    if low.endswith(".bincube"):
        from ..fields.grid3 import Grid3

        Grid3(torch.as_tensor(np.ascontiguousarray(data),
                              dtype=FDTYPE)).write_bincube(file, crystal=c)
    elif low.endswith(".xsf"):
        _write_xsf_grid(c, data, file, what)
    elif low.endswith((".vasp", "chgcar")) or base.startswith("chgcar"):
        _write_chgcar(c, data, file)
    else:
        from ..io.cube import write_cube

        xmat = np.asarray(c.m_x2c) * (lengths / np.array([n1, n2, n3]))
        zs = [c.species[s].z for s in c.species_of]
        write_cube(file, data, origin @ np.asarray(c.m_x2c).T, xmat, zs,
                   np.asarray(c.x_cart),
                   comment1=f"critic2-tpu CUBE {what}")


def _write_xsf_grid(c, data, path, what="f"):
    """XCrySDen xsf with a 3D datagrid (reference grid xsf writer;
    node-centered grid is written with the periodic endpoint repeated)."""
    from .. import param

    m = np.asarray(c.m_x2c) * param.BOHR_TO_ANGSTROM
    d = np.asarray(data)
    dp = np.pad(d, ((0, 1), (0, 1), (0, 1)), mode="wrap")
    with open(path, "w") as f:
        f.write("CRYSTAL\nPRIMVEC\n")
        for v in m.T:
            f.write(f" {v[0]:.10f} {v[1]:.10f} {v[2]:.10f}\n")
        f.write(f"PRIMCOORD\n{c.ncel} 1\n")
        pos = np.asarray(c.x_cart) * param.BOHR_TO_ANGSTROM
        for z, p in zip(c.zatoms, pos):
            f.write(f" {int(z)} {p[0]:.10f} {p[1]:.10f} {p[2]:.10f}\n")
        f.write("BEGIN_BLOCK_DATAGRID_3D\n critic2_tpu\n"
                " BEGIN_DATAGRID_3D\n")
        f.write(f" {dp.shape[0]} {dp.shape[1]} {dp.shape[2]}\n")
        f.write(" 0.0 0.0 0.0\n")
        for v in m.T:
            f.write(f" {v[0]:.10f} {v[1]:.10f} {v[2]:.10f}\n")
        flat = dp.transpose(2, 1, 0).reshape(-1)
        for lo in range(0, len(flat), 6):
            f.write(" " + " ".join(f"{v:.10e}"
                                   for v in flat[lo:lo + 6]) + "\n")
        f.write(" END_DATAGRID_3D\nEND_BLOCK_DATAGRID_3D\n")


def _write_chgcar(c, data, path):
    """VASP CHGCAR-style grid: POSCAR header + rho*Omega in Fortran
    order (the reference multiplies by the cell volume on write, inverse
    of the divide-on-read, src/grid3mod@proc.f90:577-617)."""
    from .. import param

    m = np.asarray(c.m_x2c) * param.BOHR_TO_ANGSTROM
    names, counts, order = [], [], []
    for isp in range(len(c.species)):
        idx = np.where(np.asarray(c.species_of) == isp)[0]
        if len(idx):
            names.append(c.species[isp].name)
            counts.append(len(idx))
            order.extend(idx.tolist())
    d = np.asarray(data)
    with open(path, "w") as f:
        f.write("critic2-tpu CHGCAR\n1.0\n")
        for v in m.T:
            f.write(f" {v[0]:.10f} {v[1]:.10f} {v[2]:.10f}\n")
        f.write(" ".join(names) + "\n")
        f.write(" ".join(str(n) for n in counts) + "\n")
        f.write("Direct\n")
        xf = np.asarray(c.x_frac)
        for i in order:
            f.write(f" {xf[i, 0]:.10f} {xf[i, 1]:.10f} {xf[i, 2]:.10f}\n")
        f.write("\n")
        f.write(f" {d.shape[0]} {d.shape[1]} {d.shape[2]}\n")
        flat = d.transpose(2, 1, 0).reshape(-1) * c.volume
        for lo in range(0, len(flat), 5):
            f.write(" " + " ".join(f"{v:.11e}"
                                   for v in flat[lo:lo + 5]) + "\n")


def cube_states(system, kind: str, ibnd: int, ik: int | None = None,
                spin: int = 0, field=None, fileroot: str = "states",
                write: bool = True):
    """Wannier/Bloch state cubes: the CUBE MLWF/WANNIER/UNK/PSINK
    dumps over a pwc-loaded grid field (reference machinery
    rotate_qe_evc/get_qe_wnr, src/grid3mod@proc.f90:1440-1577, exposed
    through the CUBE command options).

    kind:
      "mlwf"    - U-rotated Wannier function of band `ibnd` assembled
                  on the nk1 x nk2 x nk3 supercell (re/im cube pair);
                  requires an attached wannier90 chk
      "wannier" - same Bloch sum WITHOUT the U rotation
      "unk"     - periodic part u_nk of band `ibnd` at k-point `ik` on
                  the home cell (re/im pair)
      "psink"   - Bloch state psi_nk = u_nk e^{2 pi i k.x} at k-point
                  `ik` on the home cell (re/im pair)

    ibnd/ik are 1-based (reference convention). Returns
    (data_complex, files): the complex state tensor, on the device of
    the pwc states, and the cube paths written (empty when
    write=False).
    """
    f = system.ref if field is None else system.field(field)
    if f.type != "grid" or getattr(f.grid, "qe", None) is None:
        raise ValueError(f"CUBE {kind.upper()} requires a pwc-loaded "
                         "grid field (LOAD file.pwc)")
    qe = f.grid.qe
    kind = kind.lower()
    b0 = int(ibnd) - 1
    files: list[str] = []
    c = system.crystal

    if kind in ("mlwf", "wannier"):
        useu = kind == "mlwf" and qe.iswan
        if kind == "mlwf" and not qe.iswan:
            raise ValueError("CUBE MLWF requires wannier90 chk data "
                             "(LOAD ... WANNIER file.chk)")
        W = qe.wannier_home(spin, b0, useu=useu)
        nk1, nk2, nk3 = (int(v) for v in qe.nk)
        n1, n2, n3 = (int(v) for v in qe.n)
        # supercell value at x + R is the home-cell value of the image
        # translated by R: w_0(x + R) = w_{(-R) mod nk}(x)
        S = torch.empty((nk1 * n1, nk2 * n2, nk3 * n3), dtype=W.dtype,
                        device=W.device)
        for r1 in range(nk1):
            for r2 in range(nk2):
                for r3 in range(nk3):
                    ilat = (((-r1) % nk1) * nk2 + ((-r2) % nk2)) * nk3 \
                        + ((-r3) % nk3)
                    S[r1 * n1:(r1 + 1) * n1, r2 * n2:(r2 + 1) * n2,
                      r3 * n3:(r3 + 1) * n3] = W[ilat]
        if write:
            from ..crystal.transform import newcell

            cs = newcell(c, np.diag([nk1, nk2, nk3]))
            for part, arr in (("re", S.real), ("im", S.imag)):
                path = f"{fileroot}-{kind}-{ibnd}-{spin + 1}-{part}.cube"
                write_grid_file(cs, arr, path, what=f"{kind} {ibnd}")
                files.append(path)
        return S, files

    if kind not in ("unk", "psink"):
        raise ValueError(f"unknown CUBE state kind: {kind}")
    if ik is None:
        raise ValueError(f"CUBE {kind.upper()} needs a k-point index")
    k0 = int(ik) - 1
    u = qe.bloch_on_grid(spin, b0, useu=False)[k0]
    if kind == "psink":
        n1, n2, n3 = (int(v) for v in qe.n)
        dev = u.device
        fx = torch.arange(n1, dtype=FDTYPE, device=dev) / n1
        fy = torch.arange(n2, dtype=FDTYPE, device=dev) / n2
        fz = torch.arange(n3, dtype=FDTYPE, device=dev) / n3
        kpt = np.asarray(qe.kpt)[k0]
        u = u * torch.exp(2j * torch.pi * (
            float(kpt[0]) * fx[:, None, None] + float(kpt[1]) * fy[None, :, None]
            + float(kpt[2]) * fz[None, None, :]))
    if write:
        for part, arr in (("re", u.real), ("im", u.imag)):
            path = (f"{fileroot}-{kind}-{ibnd}-{ik}-{spin + 1}"
                    f"-{part}.cube")
            write_grid_file(c, arr, path, what=f"{kind} {ibnd} {ik}")
            files.append(path)
    return u, files
