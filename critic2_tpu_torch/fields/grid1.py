"""Radial atomic density tables on log grids (host side).

Role of the reference grid1mod (src/grid1mod.f90 + @proc): build rho(r)
radial grids from the PBE atomic tables with first/second derivatives by
6-point finite differences on the log grid (read_critic,
src/grid1mod@proc.f90:204-332):
  rho_raw(i) = sum_j occ_j wfc_j(r_i)^2     (grid truncated where
  rho_raw/(4 pi r^2) < 1e-8), then f = rho_raw/(4 pi r^2) and derivatives
  through the log-grid chain rule.

The tables are data: they are read from the JAX package's
``critic2_tpu/data/wfc_pbe.npz`` by file path. The batched interpolation
runs on the device (fields/promol.py).
"""
from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import numpy as np

from .. import param

CORE_CUTDENS = 1e-8  # reference core_cutdens (src/grid1mod@proc.f90:41)

# 6-point derivation formulas on a uniform (log) grid
# (src/grid1mod@proc.f90:25-38): rows = forward / centered / backward
_NOEF = np.array([[0, 1, 2, 3, 4, 5], [-2, -1, 0, 1, 2, 3],
                  [-5, -4, -3, -2, -1, 0]])
_COEF1 = np.array([[-274, 600, -600, 400, -150, 24],
                   [6, -60, -40, 120, -30, 4],
                   [-24, 150, -400, 600, -600, 274]], dtype=float)
_COEF2 = np.array([[225, -770, 1070, -780, 305, -50],
                   [-5, 80, -150, 80, -5, 0],
                   [-50, 305, -780, 1070, -770, 225]], dtype=float)
_FAC1 = 1.0 / 120.0
_FAC2 = 2.0 / 120.0

_DATA = os.path.join(param.DATA_DIR, "wfc_pbe.npz")


@dataclass
class Grid1:
    """One radial density table rho(r) on a log grid r_i = a e^{b (i-1)}."""

    z: int
    qat: int
    a: float
    b: float
    r: np.ndarray
    f: np.ndarray
    fp: np.ndarray
    fpp: np.ndarray

    @property
    def ngrid(self) -> int:
        return len(self.r)

    @property
    def rmax(self) -> float:
        return float(self.r[-1])


@functools.lru_cache(maxsize=1)
def _raw():
    return np.load(_DATA)


@functools.lru_cache(maxsize=256)
def build_grid1(z: int, q: int = 0) -> Grid1 | None:
    """Radial density table for element z with n = z - q electrons
    (q=0: all-electron agrid; q>0: core cgrid). Anions use the neutral
    density (reference read_db, src/grid1mod@proc.f90:72-73)."""
    q = max(q, 0)
    n = z - q
    if n <= 0:
        return None
    raw = _raw()
    key = f"z{z:03d}"
    if f"{key}_r" not in raw.files:
        return None
    r = raw[f"{key}_r"]
    rho_orb = raw[f"{key}_rho_orb"]  # (norb, ngrid) = wfc^2
    occ = raw[f"{key}_occ"].astype(float)
    xmin, zz, dx, ngrid0 = raw[f"{key}_head"]
    ngrid0 = int(ngrid0)

    # occupation truncation to n electrons (read_critic :240-251)
    if occ.sum() != n:
        occ = occ.copy()
        ns = 0.0
        for i in range(len(occ)):
            if ns + occ[i] > n:
                occ[i] = n - ns
                occ[i + 1:] = 0
                break
            ns += occ[i]

    rr0 = occ @ rho_orb
    # truncate where the density drops below the cutoff (:260-264)
    dens = rr0 / (4.0 * np.pi * r**2)
    below = np.where(dens[1:] < CORE_CUTDENS)[0]
    ngrid = min(int(below[0]) + 2, ngrid0) if len(below) else ngrid0
    r = r[:ngrid]
    rr0 = rr0[:ngrid]

    # 6-point FD derivatives of rr0 w.r.t. the log-grid index (:277-303)
    idx = np.arange(ngrid)
    ic = np.where(idx <= 1, 0, np.where(idx >= ngrid - 3, 2, 1))
    rr1 = np.zeros(ngrid)
    rr2 = np.zeros(ngrid)
    for j in range(6):
        nodes = idx + _NOEF[ic, j]
        rr1 += _COEF1[ic, j] * rr0[nodes]
        rr2 += _COEF2[ic, j] * rr0[nodes]
    rr1 *= _FAC1
    rr2 *= _FAC2

    delta = 1.0 / dx
    r1 = 1.0 / r
    fourpi = 4.0 * np.pi
    f = rr0 * r1**2 / fourpi
    fp = (rr1 * delta - 2.0 * rr0) * r1**3 / fourpi
    fpp = (rr2 * delta**2 - 5.0 * rr1 * delta + 6.0 * rr0) * r1**4 / fourpi
    return Grid1(z=z, qat=q, a=float(np.exp(xmin) / zz), b=float(dx),
                 r=r, f=f, fp=fp, fpp=fpp)


@dataclass
class RadialTableSet:
    """Stacked, padded radial tables for a set of (z, q) entries: the
    constant arrays the promolecular sum gathers from."""

    zq: list                # list of (z, q)
    a: np.ndarray           # (S,)
    b: np.ndarray           # (S,)
    ngrid: np.ndarray       # (S,) int
    rmax: np.ndarray        # (S,)
    cutoff: np.ndarray      # (S,) min(cutrad(z), rmax) effective cut
    r: np.ndarray           # (S, L) padded node radii
    f: np.ndarray           # (S, L)
    fp: np.ndarray          # (S, L)
    fpp: np.ndarray         # (S, L)

    @classmethod
    def build(cls, zq_list) -> "RadialTableSet":
        zq = [(int(z), int(q)) for z, q in zq_list]
        grids = [build_grid1(z, q) for z, q in zq]
        L = max((g.ngrid for g in grids if g is not None), default=1)
        S = len(zq)
        out = dict(
            a=np.ones(S), b=np.ones(S), ngrid=np.ones(S, dtype=int),
            rmax=np.zeros(S), cutoff=np.zeros(S),
            r=np.full((S, L), 1e30), f=np.zeros((S, L)),
            fp=np.zeros((S, L)), fpp=np.zeros((S, L)),
        )
        for i, g in enumerate(grids):
            if g is None:
                continue
            out["a"][i] = g.a
            out["b"][i] = g.b
            out["ngrid"][i] = g.ngrid
            out["rmax"][i] = g.rmax
            # contribution cut: reference promolecular skips r > cutrad(z)
            # and interp returns 0 beyond rmax (environmod@proc.f90:1293)
            out["cutoff"][i] = min(param.cutrad(zq[i][0]), g.rmax)
            out["r"][i, : g.ngrid] = g.r
            out["f"][i, : g.ngrid] = g.f
            out["fp"][i, : g.ngrid] = g.fp
            out["fpp"][i, : g.ngrid] = g.fpp
        return cls(zq=zq, **out)


def atomic_density_at(zs, dist, device=None) -> np.ndarray:
    """All-electron atomic density rho_at(z, r) per point (reference
    agrid(iz)%interp, src/arithmetic@proc.F90)."""
    import torch

    from .promol import _radial_interp, promol_tables

    zs = np.asarray(zs, dtype=int)
    uniq = sorted(set(int(z) for z in zs))
    ts = RadialTableSet.build([(z, 0) for z in uniq])
    tab = promol_tables(ts, device=device)
    dev = tab["r"].device
    sidx = torch.as_tensor([uniq.index(int(z)) for z in zs], device=dev)
    rho, _, _ = _radial_interp(tab, sidx, torch.as_tensor(
        np.asarray(dist, dtype=float), device=dev), nder=0)
    return rho.cpu().numpy()
