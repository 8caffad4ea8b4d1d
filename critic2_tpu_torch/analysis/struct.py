"""Structure-level drivers: POWDER, RDF, COMPARE, ENVIRON, COORD, PACKING.

Role of the reference struct_drivers (src/struct_drivers@proc.f90) and
crystalmod powder/rdf (src/crystalmod@proc.f90:1577-1920): X-ray powder
patterns from Cromer-Mann scattering factors (data extracted from the
reference's vendored International Tables constants into data/scatt.npz),
radial distribution functions, and structure similarity via triangle-
weighted cross-correlations (de Gelder POWDIFF,
src/tools_math@proc.f90:30-64).

Device: the RDF pair sums run as batched f64 PyTorch ops on the device;
host numpy: the (hkl) sweep of the powder pattern (a few thousand
reflections), peak lists, cross-correlations and tables. The scattering
factors are the JAX package's data/scatt.npz, read by path.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import param
from ..config import FDTYPE, resolve_device

__all__ = ["powder", "rdf", "compare", "rmsd_walker",
           "coordination", "packing_ratio"]

_SCATT = None


def _scatt():
    global _SCATT
    if _SCATT is None:
        with np.load(os.path.join(param.DATA_DIR, "scatt.npz")) as f:
            _SCATT = dict(f)
    return _SCATT


@dataclass
class Pattern:
    t: np.ndarray                # abscissa (2theta deg or r bohr)
    ih: np.ndarray               # intensity (normalized to 100)
    peaks_t: np.ndarray = None
    peaks_i: np.ndarray = None
    peaks_hkl: np.ndarray = None


def powder(crystal, th2ini: float = 5.0, th2end: float = 90.0,
           npts: int = 10001, lambda_ang: float = 1.5406,
           fpol: float = 0.0, sigma: float = 0.05) -> Pattern:
    """X-ray powder diffraction pattern (reference powder,
    src/crystalmod@proc.f90:1577-1797)."""
    c = crystal
    sc = _scatt()
    cs_all = sc["cscatt"]          # (94, 9)
    c2_all = sc["c2scatt"]         # (93, 4) for z = 2..94

    lam = lambda_ang * param.ANGSTROM_TO_BOHR        # bohr
    th2ini_r = np.radians(th2ini)
    th2end_r = np.radians(th2end)
    smax = np.sin(th2end_r / 2.0)

    g = np.asarray(c.m_x2c).T @ np.asarray(c.m_x2c)
    gr = np.linalg.inv(g)
    # hkl bound: dh <= 2 smax / lam
    dhmax = 2.0 * smax / lam
    hmax = [int(np.ceil(dhmax / np.sqrt(gr[i, i]))) + 1 for i in range(3)]
    hs = np.mgrid[-hmax[0]:hmax[0] + 1, -hmax[1]:hmax[1] + 1,
                  -hmax[2]:hmax[2] + 1].reshape(3, -1).T
    hs = hs[(hs != 0).any(axis=1)]

    dh2 = np.einsum("ni,ij,nj->n", hs, gr, hs)
    dh = np.sqrt(dh2)
    sth = 0.5 * lam * dh
    sel = sth <= smax
    hs, dh, dh2, sth = hs[sel], dh[sel], dh2[sel], sth[sel]
    th2 = 2.0 * np.arcsin(sth)
    sel = (th2 >= th2ini_r) & (th2 <= th2end_r)
    hs, dh, dh2, th2 = hs[sel], dh[sel], dh2[sel], th2[sel]

    zs = np.asarray(c.zatoms)
    xf = np.asarray(c.x_frac)
    # form factors per atom per reflection; sthlam in 1/Ang (reference
    # src/crystalmod@proc.f90:1666)
    sthlam = dh / param.BOHR_TO_ANGSTROM / 2.0
    ff = np.zeros((len(zs), len(dh)))
    dh3 = dh2 * dh
    for ia, z in enumerate(zs):
        row = cs_all[z - 1]
        a4, b4, cc = row[0:8:2], row[1:8:2], row[8]
        low = (a4[:, None] * np.exp(-b4[:, None] * dh2[None, :])).sum(0) + cc
        if z == 1:
            high = np.zeros_like(dh)
        else:
            c2 = c2_all[z - 2]
            high = np.exp(c2[0] + c2[1] * dh + c2[2] * dh2 / 10.0
                          + c2[3] * dh3 / 100.0)
        ff[ia] = np.where(dh < 2.0, low, high) * np.exp(-sthlam ** 2)

    phase = 2.0 * np.pi * (xf @ hs.T)                   # (nat, nh)
    cterm = (ff * np.cos(phase)).sum(0)
    sterm = (ff * np.sin(phase)).sum(0)
    inten = cterm ** 2 + sterm ** 2

    th = th2 / 2.0
    mcorr = 1.0 / np.sin(th2) / np.sin(th)
    afac = (1.0 - fpol) / (1.0 + fpol)
    mcorr *= (1.0 + afac * (0.5 + 0.5 * np.cos(2.0 * th2))) / (1.0 + afac)
    inten = inten * mcorr

    t = np.linspace(th2ini, th2end, npts)
    th2d = np.degrees(th2)
    keep = inten > 1e-5
    ih = (inten[keep, None] * np.exp(
        -(t[None, :] - th2d[keep, None]) ** 2 / (2 * sigma ** 2))).sum(0)
    if ih.max() > 0:
        ihn = 100.0 * ih / ih.max()
    else:
        ihn = ih

    # peak list: unique two-thetas
    order = np.argsort(th2d[keep])
    tp, ip_, hklp = [], [], []
    for idx in np.nonzero(keep)[0][order]:
        if tp and abs(th2d[idx] - tp[-1]) < 1e-5 * 180 / np.pi:
            ip_[-1] += inten[idx]
        else:
            tp.append(th2d[idx])
            ip_.append(inten[idx])
            hklp.append(hs[idx])
    return Pattern(t=t, ih=ihn, peaks_t=np.asarray(tp),
                   peaks_i=np.asarray(ip_), peaks_hkl=np.asarray(hklp))


def rdf(crystal, rini: float = 0.0, rend: float = 25.0,
        sigma: float = 0.05, npts: int = 10001, *, device=None) -> Pattern:
    """Radial distribution function (reference rdf,
    src/crystalmod@proc.f90:1799-1920): RDF(r) = sum_ij sqrt(Zi Zj)/nat
    Gaussian(r - r_ij), the pair sums on `device` (cuda by default)."""
    dev = resolve_device(device)
    c = crystal
    zs = np.asarray(c.zatoms, dtype=float)
    nat = c.ncel
    pos, spc, cidx = c.atomic_environment(rend + 5 * sigma)
    zenv = np.array([c.species[s].z for s in spc], dtype=float)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=FDTYPE,
                               device=dev)

    xc = t(c.x_cart)
    t_ = np.linspace(rini, rend, npts)
    posj, zenvj, tj = t(pos), t(zenv), t(t_)
    ih = torch.zeros(npts, dtype=FDTYPE, device=dev)
    for i in range(nat):
        ih += _pair_hist(xc[i], float(zs[i]), posj, zenvj, tj, float(nat),
                         float(rend + 5 * sigma), float(sigma))
    return Pattern(t=t_, ih=ih.cpu().numpy())


def _pair_hist(xi, zi, pos, zenv, t, nat, dcut, sigma):
    """One atom's Gaussian-smeared pair histogram."""
    d = torch.linalg.norm(pos - xi[None, :], dim=1)
    w = torch.sqrt(zi * zenv) / nat
    ok = (d > 1e-10) & (d < dcut)
    w = torch.where(ok, w, torch.zeros_like(w))
    return (w[None, :] * torch.exp(
        -(t[:, None] - d[None, :]) ** 2 / (2 * sigma ** 2))).sum(1)


def _crosscorr_triangle(h, f, g, l):
    """Triangle-weighted cross-correlation (reference crosscorr_triangle,
    src/tools_math@proc.f90:30-64)."""
    n = len(f)
    m = int(np.floor(l / h))
    if m <= 0 or m >= n:
        raise ValueError("incorrect triangle slope")
    i = np.arange(m + 1)
    w = np.maximum(1.0 - i * h / l, 0.0)
    total = 0.0
    for ii, ww in zip(i, w):
        total += np.dot(f[:n - ii], g[ii:]) * ww
        if ii:
            total += np.dot(g[:n - ii], f[ii:]) * ww
    return total * h * h


def rmsd_walker(x1, x2):
    """Least-RMSD superposition of two point sets (3, n) or (n, 3)
    after centroid alignment, by the quaternion method of Walker, Shao
    & Volz, CVGIP 54 (1991) 358 (reference rmsd_walker,
    src/tools_math@proc.f90:244-...). Returns the RMSD in bohr."""
    x1 = np.asarray(x1, dtype=float)
    x2 = np.asarray(x2, dtype=float)
    if x1.shape[0] != 3:
        x1 = x1.T
    if x2.shape[0] != 3:
        x2 = x2.T
    n = x1.shape[1]
    if x2.shape[1] != n:
        raise ValueError("rmsd_walker: inconsistent number of points")
    x1 = x1 - x1.mean(axis=1, keepdims=True)
    x2 = x2 - x2.mean(axis=1, keepdims=True)

    def wmat(x):
        return np.array([
            [x[3], x[2], -x[1], x[0]],
            [-x[2], x[3], x[0], x[1]],
            [x[1], -x[0], x[3], x[2]],
            [-x[0], -x[1], -x[2], x[3]]])

    def qmat(x):
        return np.array([
            [x[3], -x[2], x[1], x[0]],
            [x[2], x[3], -x[0], x[1]],
            [-x[1], x[0], x[3], x[2]],
            [-x[0], -x[1], -x[2], x[3]]])

    c1 = np.zeros((4, 4))
    c3 = np.zeros((4, 4))
    for i in range(n):
        w = wmat(np.array([*x1[:, i], 0.0]))
        q = qmat(np.array([*x2[:, i], 0.0]))
        c1 -= q.T @ w
        c3 += w - q
    a = (c3.T @ c3) * (0.5 * n) - c1
    eval_, evec = np.linalg.eig(a)
    v = np.real(evec[:, np.argmax(np.real(eval_))])
    v = v / np.linalg.norm(v)
    rot = (wmat(v).T @ qmat(v))[:3, :3]
    return float(np.sqrt(((rot @ x1 - x2) ** 2).sum() / n))


def compare(crystals, method: str | None = None, *, device=None,
            **kw) -> np.ndarray:
    """Pairwise structure similarity (reference struct_compare,
    src/struct_drivers@proc.f90:1062-1311): POWDIFF = 1 -
    c_fg / sqrt(c_ff c_gg) over powder patterns (crystals), RDF
    fingerprints on request, or least-RMSD superposition for molecules
    (the reference's molecular default, :1267-1284, in bohr).
    Returns the (n, n) distance matrix; RDF fingerprints are summed on
    `device` (cuda by default)."""
    if method is None:
        method = "rmsd" if crystals[0].ismolecule else "powder"
    if method == "rmsd":
        n = len(crystals)
        out = np.zeros((n, n))
        for i in range(n):
            for j in range(i + 1, n):
                ci, cj = crystals[i], crystals[j]
                if ci.ncel == cj.ncel:
                    d = rmsd_walker(np.asarray(ci.x_cart).T,
                                    np.asarray(cj.x_cart).T)
                else:
                    d = -1.0
                out[i, j] = out[j, i] = d
        return out
    pats = []
    for c in crystals:
        if method == "powder":
            p = powder(c, **kw)
        else:
            p = rdf(c, device=device, **kw)
        pats.append(p)
    n = len(pats)
    h = pats[0].t[1] - pats[0].t[0]
    lslope = 1.0
    selfcorr = [np.sqrt(_crosscorr_triangle(h, p.ih, p.ih, lslope))
                for p in pats]
    out = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1, n):
            cfg = _crosscorr_triangle(h, pats[i].ih, pats[j].ih, lslope)
            d = max(1.0 - cfg / (selfcorr[i] * selfcorr[j]), 0.0)
            out[i, j] = out[j, i] = d
    return out


def coordination(crystal, bondfactor: float = 1.4):
    """Coordination numbers from covalent connectivity (reference COORD)."""
    nb = crystal.bonds(bondfactor)
    coord = np.zeros(crystal.ncel, dtype=int)
    for i, j, _ in nb:
        coord[i] += 1
        coord[j] += 1
    return coord


def packing_ratio(crystal) -> float:
    """Packing ratio from covalent-sphere volumes (reference PACKING)."""
    zs = crystal.zatoms
    vol = sum(4.0 / 3.0 * np.pi * param.covalent_radius(int(z)) ** 3
              for z in zs)
    return float(vol / crystal.volume * 100.0)
