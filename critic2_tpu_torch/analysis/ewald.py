"""Ewald electrostatics for point-charge lattices.

Role of the reference ewald_energy/ewald_pot (src/crystalmod@proc.f90):
the electrostatic energy and site potentials of the point-charge lattice
defined by the atomic charges (Q/QAT/ZPSP keywords), via Ewald summation.

Device formulation: the real-space erfc sum runs over an image list and
the reciprocal sum over a G-vector ball, both dense batched reductions
in f64 on the device; the cutoffs and the lists are built on the host.
Units: Hartree (energy), charges in e.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..config import FDTYPE, resolve_device

__all__ = ["ewald_energy", "ewald_potential"]


def _setup(crystal, qs, eta=None, rcut_tol=1e-12, gcut_tol=1e-12):
    c = crystal
    m = np.asarray(c.m_x2c)
    vol = c.volume
    if eta is None:
        # balance real/reciprocal work (standard choice)
        eta = np.sqrt(np.pi) / vol ** (1.0 / 3.0)
    # real-space cutoff: erfc(eta r)/r < tol
    rcut = 1.0
    while math.erfc(eta * rcut) / rcut > rcut_tol:
        rcut *= 1.25
    # reciprocal cutoff: exp(-g^2/(4 eta^2))/g^2 < tol
    gcut = 1.0
    while np.exp(-gcut ** 2 / (4 * eta ** 2)) / gcut ** 2 > gcut_tol:
        gcut *= 1.25
    # image list
    widths = 1.0 / np.linalg.norm(np.asarray(c.m_c2x), axis=1)
    nimg = np.ceil(rcut / widths).astype(int) + 1
    rng = [np.arange(-n, n + 1) for n in nimg]
    shifts = np.stack(np.meshgrid(*rng, indexing="ij"), -1).reshape(-1, 3)
    latvec = shifts @ m.T
    # G vectors
    gmat = 2.0 * np.pi * np.asarray(c.m_c2x)       # rows = b_i
    gwidth = np.linalg.norm(gmat, axis=1)
    ng = np.ceil(gcut / np.min(gwidth)).astype(int) + 1
    grng = np.arange(-ng, ng + 1)
    gid = np.stack(np.meshgrid(grng, grng, grng, indexing="ij"),
                   -1).reshape(-1, 3)
    gvec = gid @ gmat
    g2 = (gvec ** 2).sum(1)
    sel = (g2 > 1e-12) & (g2 < gcut ** 2)
    return float(eta), latvec, gvec[sel], g2[sel], float(vol)


def _tensors(crystal, charges, dev):
    c = crystal
    qs = np.asarray(charges if charges is not None else c.zatoms,
                    dtype=float)
    eta, latvec, gvec, g2, vol = _setup(c, qs)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=FDTYPE,
                               device=dev)

    return (eta, vol, t(c.x_cart), t(qs), t(latvec), t(gvec), t(g2))


def ewald_energy(crystal, charges=None, *, device=None) -> float:
    """Total Ewald energy (Ha) of the point-charge lattice, summed on
    `device` (cuda by default)."""
    dev = resolve_device(device)
    eta, vol, pos, q, lat, gv, g2 = _tensors(crystal, charges, dev)
    # real space: 1/2 sum_ij sum_R' qi qj erfc(eta |rij+R|)/|rij+R|
    rij = pos[:, None, :] - pos[None, :, :]            # (n, n, 3)
    d = torch.linalg.norm(rij[None] + lat[:, None, None, :], dim=-1)
    mask = d > 1e-10
    er = torch.where(mask, torch.special.erfc(eta * d)
                     / torch.where(mask, d, torch.ones_like(d)),
                     torch.zeros_like(d))
    ereal = 0.5 * torch.einsum("i,j,rij->", q, q, er)
    # reciprocal space: |S(G)|^2 from its cosine and sine parts
    phase = gv @ pos.T                                  # (G, n)
    sre = (q[None, :] * torch.cos(phase)).sum(1)
    sim = (q[None, :] * torch.sin(phase)).sum(1)
    erec = (2.0 * math.pi / vol) * (torch.exp(-g2 / (4 * eta ** 2)) / g2
                                    * (sre * sre + sim * sim)).sum()
    eself = -eta / math.sqrt(math.pi) * (q * q).sum()
    ebg = -math.pi / (2.0 * vol * eta ** 2) * q.sum() ** 2
    return float(ereal + erec + eself + ebg)


def ewald_potential(crystal, points_cart, charges=None, *, device=None):
    """Ewald potential (Ha/e) at Cartesian points (N, 3), an f64 tensor
    on the points' device (numpy points go to `device`, cuda by
    default)."""
    if isinstance(points_cart, torch.Tensor):
        pts = points_cart.to(FDTYPE)
    else:
        pts = torch.as_tensor(np.asarray(points_cart, float), dtype=FDTYPE,
                              device=resolve_device(device))
    pts = torch.atleast_2d(pts)
    cst = _tensors(crystal, charges, pts.device)
    # (images, points, atoms) temporaries: 4,096 points a block
    return torch.cat([_potential(cst, pts[lo:lo + 4096])
                      for lo in range(0, pts.shape[0], 4096)])


def _potential(cst, pts):
    eta, vol, pos, q, lat, gv, g2 = cst
    rij = pts[:, None, :] - pos[None, :, :]
    d = torch.linalg.norm(rij[None] + lat[:, None, None, :], dim=-1)
    mask = d > 1e-7   # same threshold as the isnuc detection below
    vreal = torch.einsum("j,rnj->n", q, torch.where(
        mask, torch.special.erfc(eta * d)
        / torch.where(mask, d, torch.ones_like(d)), torch.zeros_like(d)))
    phase_p = gv @ pts.T                                # (G, N)
    phase_a = gv @ pos.T                                # (G, n)
    # S(G) = sum_j q_j exp(-i G.r_j); Re[S exp(i G.r)]
    sre = (q[None, :] * torch.cos(phase_a)).sum(1)
    sim = -(q[None, :] * torch.sin(phase_a)).sum(1)
    wg = (torch.exp(-g2 / (4 * eta ** 2)) / g2)[:, None]
    vrec = (4.0 * math.pi / vol) * (
        wg * (sre[:, None] * torch.cos(phase_p)
              - sim[:, None] * torch.sin(phase_p))).sum(0)
    vbg = -math.pi / (vol * eta ** 2) * q.sum()
    # nuclear self-term: at an atomic site the reciprocal sum still
    # contains that site's own Gaussian (potential 2*eta*q/sqrt(pi) at
    # its center) while the masked real-space term dropped the
    # compensating -q/d singularity; subtract it, matching the
    # reference's isnuc branch (crystalmod@proc.f90:2145-2150)
    onsite = (d.min(0).values < 1e-7).to(FDTYPE)        # (N, n)
    vself = -(2.0 * eta / math.sqrt(math.pi)) * (onsite @ q)
    return vreal + vrec + vbg + vself
