"""XDM dispersion (exchange-hole dipole moment model).

Role of the reference xdm_grid / xdm_qe / xdm_wfn (src/xdm@proc.f90:
120-748, :751-889, :1014-1164): from rho, grad, laplacian and
kinetic-energy-density values, compute the Becke-Roussel hole
displacement b at every point, Hirshfeld-partitioned moment integrals
<M_l^2>, free-volume-scaled polarizabilities, C6/C8/C10 dispersion
coefficients, and the Becke-Johnson damped pairwise energy and forces.

Decomposition: the BR inversion x e^(-2x/3)/(x-2) = rhs runs as a
bracketed Newton of 60 masked steps over all points at once, and the
moment integrals as per-atom-image reductions over the grid nodes (built
on the device) or the mesh, in f64 on the device, read back once per
image; the coefficients and the pair sum are small host numpy. Free-atom
data (alpha_free, frevol0) are the published constants of the JAX
package's data/xdm.npz, read by path.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import param
from ..config import FDTYPE, resolve_device

__all__ = ["xdm_grid", "xdm_qe", "xdm_wfn", "br_hole_b", "XDMResult"]

_XDM = None


def _xdmdata():
    global _XDM
    if _XDM is None:
        with np.load(os.path.join(param.DATA_DIR, "xdm.npz")) as f:
            _XDM = dict(f)
    return _XDM


def br_hole_b(rho, grad, lap, tau):
    """Becke-Roussel hole displacement b (reference src/xdm@proc.f90:
    400-447): per-spin quantities, solve x e^(-2x/3)/(x-2) = rhs,
    b = x (e^-x / (8 pi rho_s))^(1/3). f64 tensors of any shape."""
    rho = torch.as_tensor(rho, dtype=FDTYPE)
    dev = rho.device
    grad, lap, tau = (torch.as_tensor(v, dtype=FDTYPE, device=dev)
                      for v in (grad, lap, tau))
    rhos = torch.clamp(rho, min=1e-14) / 2.0
    grho = grad / 2.0
    laps = lap / 2.0
    taus = tau / 2.0
    ds = taus - 0.25 * grho * grho / rhos
    qs = (laps - 2.0 * ds) / 6.0
    qs = torch.where(qs.abs() < 1e-20, torch.sign(qs) * 1e-20 + 1e-21, qs)
    rhs = (2.0 / 3.0) * math.pi ** (2.0 / 3.0) * rhos ** (5.0 / 3.0) / qs

    def g(x):
        return x * math.exp(-2.0 * x / 3.0) / (x - 2.0)

    # bracketed init: rhs > 0 -> x > 2 (g decreasing from +inf);
    # rhs < 0 -> x < 2. Mirror the reference's 0.1^k shift scan.
    pos = rhs > 0
    xinit = torch.where(pos, torch.full_like(rhs, 3.0),
                        torch.full_like(rhs, 1.0))
    for k in range(16):
        shift = 0.1 ** k
        cand_hi = 2.0 + shift
        cand_lo = 2.0 - shift
        xinit = torch.where(pos & (g(cand_hi) < rhs),
                            torch.full_like(rhs, cand_hi), xinit)
        xinit = torch.where(~pos & (g(cand_lo) > rhs),
                            torch.full_like(rhs, cand_lo), xinit)

    x = xinit
    for _ in range(60):
        expx = torch.exp(-2.0 * x / 3.0)
        gx = x * expx / (x - 2.0)
        fx = gx - rhs
        dfx = gx * (1.0 / x - 2.0 / 3.0 - 1.0 / (x - 2.0))
        xn = x - fx / dfx
        # keep the iterate on the correct side of the pole
        x = torch.where(pos, torch.clamp(xn, min=2.0 + 1e-12),
                        torch.clamp(xn, 1e-12, 2.0 - 1e-12))
    return x * (torch.exp(-x) / (8.0 * math.pi * rhos)) ** (1.0 / 3.0)


@dataclass
class XDMResult:
    volumes: np.ndarray       # (nat,)
    vfree: np.ndarray
    moments: np.ndarray       # (nat, 3) <M_1^2>, <M_2^2>, <M_3^2>
    alpha: np.ndarray
    c6: np.ndarray            # (nat, nat)
    c8: np.ndarray
    c10: np.ndarray
    rc: np.ndarray
    rvdw: np.ndarray
    energy: float
    forces: np.ndarray        # (nat, 3)
    ehadd: dict = None


def _free_tables(zs, dev):
    """Free-atom radial tables of the species in zs, and the table index
    of each Z."""
    from ..fields.grid1 import RadialTableSet
    from ..fields.promol import promol_tables

    zq = sorted({(int(z), 0) for z in zs})
    ts = RadialTableSet.build(zq)
    return ts, promol_tables(ts, device=dev), \
        {t[0]: q for q, t in enumerate(zq)}


def _moments(r, sidx, tab, wrho, b):
    """(<M_1^2>, <M_2^2>, <M_3^2>, volume) sums of one atom image over
    points at distances r with weights wrho = w rho / promol."""
    from ..fields.promol import _radial_interp

    s = torch.full(r.shape, sidx, dtype=torch.int64, device=r.device)
    rhofree, _, _ = _radial_interp(tab, s, r, nder=0)
    w = torch.clamp(rhofree, min=0.0) * wrho
    db = torch.clamp(r - b, min=0.0)
    return torch.stack([(w * (r ** L - db ** L) ** 2).sum()
                        for L in (1, 2, 3)] + [(w * r ** 3).sum()])


def xdm_grid(system, a1: float = 0.6836, a2_ang: float = 1.5045,
             rho=None, tau=None, lap=None, grad=None,
             upto: int = 10, ecut: float = 1e-11) -> XDMResult:
    """XDM dispersion from grids, on the system's device. rho defaults
    to the reference field's grid; tau/lap/grad default to FFT-derived
    grids of rho (tau by the Thomas-Fermi + Weizsacker approximation;
    feeding the exact tau grid is strongly recommended, as the QE
    workflow in the reference does)."""
    from ..ops import fft as fftops
    from .integration import _grid_points, _rasterize_env

    dev = resolve_device(system.device)
    c = system.crystal
    f = system.ref
    if rho is None:
        if f.type != "grid":
            raise ValueError("XDM GRID needs a grid reference field")
        rho = f.grid.f
    rho = torch.as_tensor(rho, dtype=FDTYPE, device=dev)
    n = tuple(int(v) for v in rho.shape)
    N = int(np.prod(n))

    if grad is None:
        grad = fftops.gradrho(rho, c.m_x2c)
    if lap is None:
        lap = fftops.laplacian(rho, c.m_x2c)
    grad = torch.as_tensor(grad, dtype=FDTYPE, device=dev)
    lap = torch.as_tensor(lap, dtype=FDTYPE, device=dev)
    if tau is None:
        ctf = 0.3 * (3.0 * math.pi ** 2) ** (2.0 / 3.0)
        tau = ctf * torch.clamp(rho, min=0.0) ** (5.0 / 3.0) \
            + grad ** 2 / (8.0 * torch.clamp(rho, min=1e-14))
    tau = torch.as_tensor(tau, dtype=FDTYPE, device=dev)

    b_flat = br_hole_b(rho, grad, lap, tau).reshape(-1)
    del grad, lap, tau

    # promolecular density on the grid: the Hirshfeld denominator
    env = system.fields[0].promol
    pd_flat = torch.clamp(_rasterize_env(c, env, n).reshape(-1).to(dev),
                          min=1e-14)
    wrho = rho.reshape(-1) / pd_flat
    del pd_flat
    xcart = _grid_points(c, n, 0, N, FDTYPE, dev)               # (3, N)

    zs = np.asarray(c.zatoms)
    nat = c.ncel
    ts, tab, zidx = _free_tables(zs, dev)
    m_x2c = np.asarray(c.m_x2c)
    widths = 1.0 / np.linalg.norm(np.asarray(c.m_c2x), axis=1)
    ml = np.zeros((nat, 3))
    avol = np.zeros(nat)
    for iat in range(nat):
        z = int(zs[iat])
        cutr = min(param.cutrad(z), float(ts.rmax[zidx[z]]))
        # atom images whose cutoff sphere reaches a grid node
        nimg = np.ceil(cutr / widths).astype(int) + 1
        rng = [np.arange(-v, v + 1) for v in nimg]
        shifts = np.stack(np.meshgrid(*rng, indexing="ij"),
                          -1).reshape(-1, 3)
        x0 = np.asarray(c.x_frac[iat])
        acc = torch.zeros(4, dtype=FDTYPE, device=dev)
        for sh in shifts:
            pos = torch.as_tensor((x0 + sh) @ m_x2c.T, dtype=FDTYPE,
                                  device=dev)
            d = xcart - pos[:, None]
            r = torch.sqrt(torch.clamp((d * d).sum(0), min=1e-28))
            if float(r.min()) > cutr:
                continue
            acc += _moments(r, zidx[z], tab, wrho, b_flat)
        acc = acc.cpu().numpy()
        ml[iat] = acc[:3]
        avol[iat] = acc[3]
    scale = c.volume / N
    ml *= scale
    avol *= scale

    return _xdm_coefs_energy(c, zs, ml, avol, a1, a2_ang, upto, ecut)


def _xdm_coefs_energy(c, zs, ml, avol, a1, a2_ang, upto, ecut):
    """Coefficients + damped dispersion energy shared by the grid and
    wfn variants (reference calc_coefs/calc_edisp,
    src/xdm@proc.f90:577-705)."""
    nat = len(zs)
    xd = _xdmdata()
    vfree = np.array([xd["frevol0"][z] for z in zs])
    alpha = np.minimum(avol / vfree, 1.0) * \
        np.array([xd["alpha_free"][z - 1] for z in zs])

    c6 = np.zeros((nat, nat))
    c8 = np.zeros((nat, nat))
    c10 = np.zeros((nat, nat))
    for ii in range(nat):
        for jj in range(nat):
            den = ml[ii, 0] * alpha[jj] + ml[jj, 0] * alpha[ii]
            c6[ii, jj] = alpha[ii] * alpha[jj] * ml[ii, 0] * ml[jj, 0] / den
            c8[ii, jj] = 1.5 * alpha[ii] * alpha[jj] * (
                ml[ii, 0] * ml[jj, 1] + ml[ii, 1] * ml[jj, 0]) / den
            c10[ii, jj] = (2.0 * alpha[ii] * alpha[jj]
                           * (ml[ii, 0] * ml[jj, 2] + ml[ii, 2] * ml[jj, 0])
                           / den
                           + 4.2 * alpha[ii] * alpha[jj] * ml[ii, 1]
                           * ml[jj, 1] / den)
    rc = (np.sqrt(c8 / c6) + np.sqrt(c10 / c8) + (c10 / c6) ** 0.25) / 3.0
    a2 = a2_ang * param.ANGSTROM_TO_BOHR
    rvdw = a1 * rc + a2

    etotal, forces, ehadd = _edisp_sum(c, c6, c8, c10, rvdw, upto, ecut)

    return XDMResult(volumes=avol, vfree=vfree, moments=ml, alpha=alpha,
                     c6=c6, c8=c8, c10=c10, rc=rc, rvdw=rvdw,
                     energy=float(etotal), forces=forces, ehadd=ehadd)


def _edisp_sum(c, c6, c8, c10, rvdw, upto: int = 10, ecut: float = 1e-11):
    """Damped -C_n/R^n dispersion lattice sum + forces (reference
    calc_edisp, src/xdm@proc.f90:577-705)."""
    nat = c6.shape[0]
    maxc6 = max(c6.max(), 1e-300)
    rmax = (maxc6 / ecut) ** (1.0 / 6.0)
    pos_env, spc_env, cidx_env = c.atomic_environment(rmax)
    xc_at = np.asarray(c.x_cart)
    etotal = 0.0
    forces = np.zeros((nat, 3))
    ehadd = {6: 0.0, 8: 0.0, 10: 0.0}
    cn_by_order = {6: c6, 8: c8, 10: c10}
    for ii in range(nat):
        d = pos_env - xc_at[ii][None, :]
        ri = np.linalg.norm(d, axis=1)
        sel = (ri > 1e-10) & (ri < rmax)
        dd = d[sel]
        rr = ri[sel]
        jidx = cidx_env[sel]
        for nn in range(6, upto + 1, 2):
            cn = cn_by_order[nn][ii, jidx]
            rv = rvdw[ii, jidx] ** nn
            ex = cn / (rv + rr ** nn)
            ehadd[nn] += ex.sum()
            etotal += ex.sum()
            fxx = nn * cn * rr ** (nn - 2) / (rv + rr ** nn) ** 2
            forces[ii] += (fxx[:, None] * dd).sum(0)
    etotal = -0.5 * etotal
    ehadd = {k: -0.5 * v for k, v in ehadd.items()}
    return etotal, forces, ehadd


def xdm_qe(system, path: str | None = None, between=None, and_=None,
           upto: int = 10, ecut: float = 1e-11) -> XDMResult:
    """XDM energy from the coefficients printed in a Quantum ESPRESSO
    pw.x output (reference xdm_qe, src/xdm@proc.f90:751-889): parse a1,
    a2 and the lower-triangular per-pair C6/C8/C10/Rc/Rvdw table from
    the '* XDM dispersion' / '+ Dispersion coefficients' blocks, zero
    the coefficients of pairs outside the BETWEEN x AND atom sets, and
    run the same damped lattice sum as the grid/wfn variants.

    between/and_: 1-based cell-atom index lists (reference BETWEEN/AND
    keywords); both or neither must be given."""
    c = system.crystal
    nat = c.ncel
    if path is None:
        path = getattr(c, "file", None)
        if not path:
            raise ValueError("XDM QE needs the QE output file "
                             "(CRYSTAL source or explicit path)")
    if (between is None) != (and_ is None):
        raise ValueError("BETWEEN and AND must be given together")

    c6 = np.zeros((nat, nat))
    c8 = np.zeros((nat, nat))
    c10 = np.zeros((nat, nat))
    rc = np.zeros((nat, nat))
    rvdw = np.zeros((nat, nat))
    a1 = a2 = None
    with open(path) as fh:
        lines = iter(fh.read().splitlines())
    lit = list(lines)
    i = 0
    got_coefs = False
    while i < len(lit):
        line = lit[i]
        if line.strip() == "* XDM dispersion":
            # a1 on the next '='-line, a2 two lines later (reference
            # reads getline/=, getline, getline/=)
            a1 = float(lit[i + 1].split("=")[1].split()[0])
            a2 = float(lit[i + 3].split("=")[1].split()[0])
            i += 4
            continue
        if line.strip() == "+ Dispersion coefficients":
            k = i + 1
            for ii in range(nat):
                for jj in range(ii + 1):
                    f = lit[k].split()
                    k += 1
                    i1, i2 = int(f[0]), int(f[1])
                    if i1 != ii + 1 or i2 != jj + 1:
                        raise ValueError(
                            f"XDM QE: indices {i1},{i2} do not match "
                            f"expected {ii + 1},{jj + 1}")
                    c6[ii, jj] = c6[jj, ii] = float(f[2])
                    c8[ii, jj] = c8[jj, ii] = float(f[3])
                    c10[ii, jj] = c10[jj, ii] = float(f[4])
                    rc[ii, jj] = rc[jj, ii] = float(f[5])
                    rvdw[ii, jj] = rvdw[jj, ii] = float(f[6])
            got_coefs = True
            i = k
            continue
        i += 1
    if not got_coefs:
        raise ValueError(f"no '+ Dispersion coefficients' block in {path}")

    if between is not None:
        lfrom = np.zeros(nat, bool)
        lto = np.zeros(nat, bool)
        lfrom[np.asarray(between, dtype=int) - 1] = True
        lto[np.asarray(and_, dtype=int) - 1] = True
        keep = (lto[:, None] & lfrom[None, :]) | (lto[None, :]
                                                  & lfrom[:, None])
        c6 = np.where(keep, c6, 0.0)
        c8 = np.where(keep, c8, 0.0)
        c10 = np.where(keep, c10, 0.0)

    etotal, forces, ehadd = _edisp_sum(c, c6, c8, c10, rvdw, upto, ecut)
    return XDMResult(volumes=None, vfree=None, moments=None, alpha=None,
                     c6=c6, c8=c8, c10=c10, rc=rc, rvdw=rvdw,
                     energy=float(etotal), forces=forces, ehadd=ehadd)


def xdm_wfn(system, a1: float = 0.6836, a2_ang: float = 1.5045,
            upto: int = 10, ecut: float = 1e-11, lvl: str = "good",
            block: int = 1 << 13) -> XDMResult:
    """Molecular XDM from the wavefunction on a Becke mesh (reference
    xdm_wfn, src/xdm@proc.f90:1014-1164): BR hole displacement b from
    the exact rho/grad/lap/tau, Hirshfeld weights from free-atom radial
    densities, and <M_l^2> moments integrated per atom on the mesh, on
    the system's device."""
    from ..fields.promol import _radial_interp
    from .mesh import becke_mesh

    dev = resolve_device(system.device)
    c = system.crystal
    f = system.ref
    if f.type != "wfn":
        raise ValueError("XDM (molecular) needs a wavefunction "
                         "reference field")
    if f.wfn.wfntyp != "rhf":
        raise ValueError("XDM: open-shell wavefunctions not supported "
                         "(as in the reference)")
    m = becke_mesh(c, lvl, device=dev)
    x = torch.as_tensor(m.x, dtype=FDTYPE, device=dev)
    wm = torch.as_tensor(m.w, dtype=FDTYPE, device=dev)
    npts = m.n
    rho = torch.empty(npts, dtype=FDTYPE, device=dev)
    b = torch.empty(npts, dtype=FDTYPE, device=dev)
    for lo in range(0, npts, block):
        ex = f.wfn.extras_soa(x[lo:lo + block].T)
        r_ = ex["rho"]
        rho[lo:lo + r_.shape[0]] = r_
        b[lo:lo + r_.shape[0]] = br_hole_b(
            r_, torch.sqrt((ex["grad"] ** 2).sum(0)),
            ex["h6"][0] + ex["h6"][1] + ex["h6"][2], ex["gkin"])

    zs = np.asarray(c.zatoms)
    nat = c.ncel
    ts, tab, zidx = _free_tables(zs, dev)
    xc_at = torch.as_tensor(np.asarray(c.x_cart), dtype=FDTYPE, device=dev)

    # free atomic densities at the mesh points
    dist = torch.linalg.norm(x[None, :, :] - xc_at[:, None, :], dim=-1)
    rfree = torch.empty((nat, npts), dtype=FDTYPE, device=dev)
    for iat in range(nat):
        s = torch.full((npts,), zidx[int(zs[iat])], dtype=torch.int64,
                       device=dev)
        rf, _, _ = _radial_interp(tab, s, dist[iat], nder=0)
        rfree[iat] = torch.clamp(rf, min=0.0)
    promol = torch.clamp(rfree.sum(0), min=1e-40)

    ml = np.zeros((nat, 3))
    avol = np.zeros(nat)
    for iat in range(nat):
        r = dist[iat]
        w = wm * (torch.clamp(rfree[iat], min=1e-40) / promol) * rho
        rb = torch.clamp(r - b, min=0.0)
        acc = torch.stack([(w * (r ** L - rb ** L) ** 2).sum()
                           for L in (1, 2, 3)] + [(w * r ** 3).sum()])
        acc = acc.cpu().numpy()
        ml[iat] = acc[:3]
        avol[iat] = acc[3]

    return _xdm_coefs_energy(c, zs, ml, avol, a1, a2_ang, upto, ecut)
