"""Plain reference of localization and delocalization indices from
Wannier functions over Yu-Trinkle basins (Otero-de-la-Roza, Martin
Pendas and Johnson, JCTC 14, 4699 (2018); critic2's intgrid_deloc_wannier
and calc_sij_wannier, src/integration@proc.f90:1183-1879).

From a pool item of benchmark/data/bloch_orbitals.py (plane-wave
coefficients, Miller indices, k-points, wannier90 U, centres, spreads):
- the density: each state's periodic part u_nk(r) on the grid by
  torch.fft.ifftn of its coefficients placed at their Miller indices,
  rho = fspin / (Omega sum wk) sum_nk occ_nk |u_nk|^2;
- the attractors and each basin's weights: the YT flux of
  benchmark/reference/yt.py, then the forward fixpoint w_a = e_a +
  sum_k chi_k w_a(. + o_k) (w_a at attractor b is delta_ab) by Jacobi
  passes of torch.roll, all attractors at once, until a pass changes
  nothing;
- the U-rotated periodic parts ~u_nk = sum_j U[k, j, n] u_jk, and the
  Wannier function of band n centred in cell R at a point y as the
  k-sum (1/Nk) sum_k exp(2 pi i k.(y - R)) ~u_nk(y). A grid point x
  whose weight goes to the image of attractor a in cell p is the point
  y = x - p of a's own basin: its phase carries p, no index is permuted;
- S^a = (1/N) sum_x w_a(x) conj(w_i(y)) w_j(y) over the basin, in blocks
  of points, then the screening: entries whose centres lie farther
  apart (minimum image in the k-point supercell, found here by search
  over its images) than wancut times their summed spreads are zeroed;
- Fa(a, b, R) = sum_ij Re[S^a_ji S^b_{i-R, j-R}], the translation a
  torch.roll of S reshaped on its (k1, k2, k3) axes; LI(a) = fspin
  |Fa(a, a, 0)|, N(a) = fspin sum_{b,R} |Fa(a, b, R)|.

Runs in the dtype it is given: float64 (complex128) is the reference,
float32 (complex64) its control. Loads nothing of the program.
"""
from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from benchmark.reference import yt as ref_yt

BOHR_TO_ANGSTROM = 0.52917720859
MAX_PASSES = 100_000
# points a block of the overlap sums
BLOCK = 16384


def _complex(dtype):
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def _periodic_parts(item, ik, coef, dtype):
    """(nb, n1, n2, n3) periodic parts of the rows of coef (nb, ngk) at
    k-point ik: the coefficients at their Miller indices, unscaled
    inverse FFT."""
    n = tuple(int(v) for v in item["n"])
    ng = int(item["ngk"][ik])
    mil = item["miller"][item["igk_k"][ik, :ng] - 1] % np.asarray(n)
    dev = coef.device
    grid = torch.zeros((coef.shape[0],) + n, dtype=_complex(dtype),
                       device=dev)
    i1, i2, i3 = (torch.as_tensor(mil[:, c], device=dev) for c in range(3))
    grid[:, i1, i2, i3] = coef[:, :ng].to(_complex(dtype))
    return torch.fft.ifftn(grid, dim=(1, 2, 3), norm="forward")


def density(item, dtype=torch.float64) -> torch.Tensor:
    """The electron density (n1, n2, n3) in `dtype` on the states'
    device."""
    evc = item["evc"]
    nspin, nks = evc.shape[0], evc.shape[1]
    n = tuple(int(v) for v in item["n"])
    vol = abs(float(np.linalg.det(np.asarray(item["at"]))))
    fspin = 2.0 if nspin == 1 else 1.0
    wk, occ = np.asarray(item["wk"]), np.asarray(item["occ"])
    rho = torch.zeros(n, dtype=dtype, device=evc.device)
    for s in range(nspin):
        for ik in range(nks):
            u = _periodic_parts(item, ik, evc[s, ik], dtype)
            f = torch.as_tensor(occ[s * nks + ik], dtype=dtype,
                                device=evc.device)
            rho += torch.einsum("b,bxyz->xyz", f, (u.abs() ** 2))
    return rho * (fspin / (vol * wk.sum()))


def attractors(rho, lattice_bohr) -> np.ndarray:
    """Flat grid indices (ascending) of the points with no uphill
    neighbour, by the flux of benchmark/reference/yt.py."""
    offs, wts = ref_yt.ws_facets(ref_yt.grid_lattice(lattice_bohr,
                                                     rho.shape))
    _, attr = ref_yt.flux(rho, offs, wts)
    return torch.nonzero(attr.reshape(-1)).reshape(-1).cpu().numpy()


def basin_weights(rho, lattice_bohr):
    """(attractors (nattr,), weights (nattr, n1, n2, n3), passes): the
    forward fixpoint of every basin at once by Jacobi passes."""
    offs, wts = ref_yt.ws_facets(ref_yt.grid_lattice(lattice_bohr,
                                                     rho.shape))
    chi, attr = ref_yt.flux(rho, offs, wts)
    iattr = torch.nonzero(attr.reshape(-1)).reshape(-1)
    e = torch.zeros((len(iattr), rho.numel()), dtype=rho.dtype,
                    device=rho.device)
    e[torch.arange(len(iattr), device=rho.device), iattr] = 1.0
    e = e.reshape((len(iattr),) + tuple(rho.shape))
    w = e
    for npass in range(1, MAX_PASSES + 1):
        new = e.clone()
        for k, o in enumerate(offs):
            # the weight at x + o_k, brought to x
            new.addcmul_(chi[k][None], torch.roll(
                w, tuple(-int(v) for v in o), (1, 2, 3)))
        if torch.equal(new, w):
            return iattr.cpu().numpy(), w, npass
        w = new
    raise RuntimeError(f"no fixpoint after {MAX_PASSES} passes")


def _cell_images(xg, xa, at):
    """Per point, the lattice vector p (integers) of the attractor image
    nearest the point: xg - p is the point nearest xa."""
    d = xg - xa[None, :]
    base = np.rint(d)
    best, bestd = None, None
    for c in itertools.product((-1, 0, 1), repeat=3):
        p = base + np.asarray(c)
        dist = (((d - p) @ at.T) ** 2).sum(1)
        if best is None:
            best, bestd = p.copy(), dist
        else:
            upd = dist < bestd
            best[upd], bestd[upd] = p[upd], dist[upd]
    return best.astype(np.int64)


def screening(item, wancut, device) -> torch.Tensor:
    """(nmo, nmo) mask of the overlaps kept: centres closer (minimum
    image in the k-point supercell) than wancut times the summed
    spreads. Orbital index R nb + n, R in C order over (k1, k2, k3)."""
    at = np.asarray(item["at"], dtype=float)
    nk = np.asarray(item["nk"], dtype=np.int64)
    rv = np.stack(np.meshgrid(*[np.arange(v) for v in nk], indexing="ij"),
                  -1).reshape(-1, 3)
    cen = np.asarray(item["centres_ang"]) / BOHR_TO_ANGSTROM   # bohr
    spr = np.sqrt(np.asarray(item["spreads_ang2"])) / BOHR_TO_ANGSTROM
    pos = (cen[None, :, :] + (rv @ at.T)[:, None, :]).reshape(-1, 3)
    sp = np.broadcast_to(spr, (len(rv), len(spr))).reshape(-1)
    sup = at * nk[None, :].astype(float)            # supercell, columns
    imgs = np.array(list(itertools.product(range(-2, 3), repeat=3)),
                    dtype=float) @ sup.T
    pos_t = torch.as_tensor(pos, device=device)
    img_t = torch.as_tensor(imgs, device=device)
    sp_t = torch.as_tensor(sp, device=device)
    nmo = len(pos)
    keep = torch.empty((nmo, nmo), dtype=torch.bool, device=device)
    rows = 64
    for i0 in range(0, nmo, rows):
        d = pos_t[None, :, None, :] - pos_t[i0:i0 + rows, None, None, :] \
            + img_t[None, None, :, :]
        dmin = torch.sqrt((d * d).sum(-1).min(-1).values)
        keep[i0:i0 + rows] = dmin <= (sp_t[i0:i0 + rows, None]
                                      + sp_t[None, :]) * wancut
    return keep


def overlaps(item, rho, lattice_bohr, dtype, wancut=None):
    """(attractors, S (nattr, nmo, nmo) complex, passes)."""
    dev = item["evc"].device
    cd = _complex(dtype)
    at = np.asarray(item["at"], dtype=float)
    n = tuple(int(v) for v in item["n"])
    N = int(np.prod(n))
    nk = np.asarray(item["nk"], dtype=np.int64)
    nks = int(np.prod(nk))
    kf = np.asarray(item["kpt"]) @ at                 # crystallographic
    rv = np.stack(np.meshgrid(*[np.arange(v) for v in nk], indexing="ij"),
                  -1).reshape(-1, 3)
    evc = item["evc"][0]
    nb = evc.shape[1]
    nmo = nks * nb
    iattr, w, passes = basin_weights(rho, lattice_bohr)
    # the U-rotated periodic parts of every state on the grid
    ut = torch.empty((nks, nb, N), dtype=cd, device=dev)
    for ik in range(nks):
        u = torch.as_tensor(item["u"][ik], dtype=cd, device=dev)
        ut[ik] = _periodic_parts(item, ik, u.T @ evc[ik].to(cd),
                                 dtype).reshape(nb, N)
    kf_t = torch.as_tensor(kf, dtype=dtype, device=dev)
    # (nlat, nks): exp(-2 pi i k.R) / Nk
    E = torch.exp(torch.complex(torch.zeros((), dtype=dtype, device=dev),
                                -2 * math.pi * (torch.as_tensor(
                                    rv, dtype=dtype, device=dev)
                                    @ kf_t.T))) / nks
    S = torch.zeros((len(iattr), nmo, nmo), dtype=cd, device=dev)
    xa = np.stack(np.unravel_index(iattr, n), 1) / np.asarray(n)
    wflat = w.reshape(len(iattr), N)
    for a in range(len(iattr)):
        pts = torch.nonzero(wflat[a] > 0).reshape(-1)
        for b0 in range(0, len(pts), BLOCK):
            idx = pts[b0:b0 + BLOCK]
            ijk = np.stack(np.unravel_index(idx.cpu().numpy(), n), 1)
            xg = ijk / np.asarray(n)
            p = _cell_images(xg, xa[a], at)
            y = torch.as_tensor(xg - p, dtype=dtype, device=dev)
            ph = torch.exp(torch.complex(torch.zeros((), dtype=dtype,
                                                     device=dev),
                                         2 * math.pi * (kf_t @ y.T)))
            vals = ut[:, :, idx] * ph[:, None, :]          # (nks, nb, B)
            V = (E @ vals.reshape(nks, -1)).reshape(nmo, len(idx))
            S[a] += (V.conj() * wflat[a, idx].to(cd)[None, :]) @ V.T
    S /= N
    if wancut is not None:
        S = torch.where(screening(item, wancut, dev), S,
                        torch.zeros((), dtype=cd, device=dev))
    return iattr, S, passes


def deloc(item, lattice_bohr, dtype=torch.float64, wancut=None) -> dict:
    """Attractors (flat grid indices, ascending), Fa (1, nattr, nattr,
    nlat), LI and populations per attractor, the lattice vectors R of
    Fa's last axis, in `dtype`."""
    nspin = item["evc"].shape[0]
    fspin = 2.0 if nspin == 1 else 1.0
    rho = density(item, dtype)
    iattr, S, passes = overlaps(item, rho, lattice_bohr, dtype, wancut)
    nk = [int(v) for v in item["nk"]]
    nlat = int(np.prod(nk))
    nattr, nmo = S.shape[0], S.shape[1]
    nb = nmo // nlat
    S6 = S.reshape(nattr, *nk, nb, *nk, nb)
    rv = np.stack(np.meshgrid(*[np.arange(v) for v in nk], indexing="ij"),
                  -1).reshape(-1, 3)
    fa = np.empty((nattr, nattr, nlat))
    for r, R in enumerate(rv):
        # S^b_{i-R, j-R}: both lattice indices moved by R
        Sr = torch.roll(S6, tuple(int(v) for v in R) * 2,
                        (1, 2, 3, 5, 6, 7)).reshape(nattr, nmo, nmo)
        fa[:, :, r] = torch.einsum("aji,bij->ab", S, Sr).real.to(
            torch.float64).cpu().numpy()
    r0 = int(np.flatnonzero((rv == 0).all(1))[0])
    return {"iattr": iattr, "fa": fa[None],
            "li": fspin * np.abs(fa[:, :, r0]).diagonal(),
            "population": fspin * np.abs(fa).sum(axis=(1, 2)),
            "rvec": rv, "passes": passes}
