"""Batched promolecular density evaluation on the device.

Role of the reference environ%promolecular (src/environmod@proc.f90:1202):
the sum of spherical atomic densities (and its gradient/Hessian) at a
batch of points, as a dense masked points x atom-images contraction: every
(point, image) pair evaluates the radial table with a distance mask, so
there are no dynamic neighbour lists.

The radial interpolation is the reference's 4-node, 3rd-order Lagrange on
the log grid (src/grid1mod@proc.f90:84-135), evaluated for all pairs at
once via gathers into the stacked RadialTableSet arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import FDTYPE, resolve_device
from ..ops.interp import sym6_to_mat
from .grid1 import RadialTableSet

__all__ = ["promol_tables", "promolecular_soa", "promolecular_batch",
           "PromolEnv"]


def _radial_interp(tab, s, r0, nder: int = 2):
    """Batched Lagrange-4 log-grid interpolation.

    tab: dict of tensors from promol_tables; s: (...,) int table index per
    evaluation; r0: (...,) radius. Returns (f, fp, fpp) with zeros beyond
    rmax (reference interp, src/grid1mod@proc.f90:84-135); fp and fpp are
    None when nder is below 1 and 2."""
    L = tab["r"].shape[1]
    a = tab["a"][s]
    b = tab["b"][s]
    ngrid = tab["ngrid"][s]
    rmax = tab["rmax"][s]
    r1 = tab["r"][:, 0][s]

    # reference: if r0 <= r(1) evaluate AT r(1); else at r0
    below = r0 <= r1
    r = torch.where(below, r1, r0)
    ir = torch.where(
        below, torch.ones_like(ngrid),
        1 + torch.floor(torch.log(torch.clamp(r0, min=1e-300) / a) / b)
        .to(ngrid.dtype))
    base = torch.minimum(torch.clamp(ir, min=2), ngrid - 2) - 2
    flat = s * L + base                     # first node, flat table index

    rr = [torch.take(tab["r"], flat + i) for i in range(4)]
    dr1 = [r - ri for ri in rr]
    # lagrange basis: w_i = prod_{j != i} dr1_j / (rr_i - rr_j)
    w = []
    for i in range(4):
        wi = None
        for j in range(4):
            if j == i:
                continue
            t = dr1[j] / (rr[i] - rr[j])
            wi = t if wi is None else wi * t
        w.append(wi)

    valid = (r0 < rmax) & (ngrid > 0)

    def contract(name):
        tb = tab[name]
        acc = torch.take(tb, flat) * w[0]
        for i in range(1, 4):
            acc = acc + torch.take(tb, flat + i) * w[i]
        return torch.where(valid, acc, torch.zeros_like(acc))

    fv = contract("f")
    fpv = contract("fp") if nder >= 1 else None
    fppv = contract("fpp") if nder >= 2 else None
    return fv, fpv, fppv


def promol_tables(ts: RadialTableSet, dtype=FDTYPE, device=None) -> dict:
    """Move a RadialTableSet to device tensors."""
    dev = resolve_device(device)

    def t(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=dev)

    return {
        "a": t(ts.a), "b": t(ts.b), "ngrid": t(ts.ngrid, torch.int64),
        "rmax": t(ts.rmax), "cutoff": t(ts.cutoff),
        "r": t(ts.r), "f": t(ts.f), "fp": t(ts.fp), "fpp": t(ts.fpp),
    }


def promolecular_soa(pointsT, atpos, atspc, tab, nder: int = 2):
    """Promolecular density/gradient/Hessian, batch-last SoA.

    pointsT: (3, N) Cartesian points; atpos: (M, 3) atom-image positions;
    atspc: (M,) int index into the table set; tab: promol_tables output.
    Returns (f (N,), fp (3, N), fpp6 (6, N)) with fpp6 in SYM6 order
    (xx, yy, zz, xy, xz, yz).

    Semantics follow reference promolecular (environmod@proc.f90:1284-1323):
    per-pair distance clamped to max(r, 1e-14); per-atom density clamped
    to >= 0; contribution dropped beyond min(cutrad(z), rmax).
    """
    pT = pointsT
    xx = pT[:, :, None] - atpos.T[:, None, :]            # (3, N, M)
    r2 = (xx * xx).sum(0)
    r = torch.sqrt(torch.clamp(r2, min=1e-28))           # (N, M)
    N = pT.shape[1]
    zero = torch.zeros((), dtype=r.dtype, device=r.device)

    s = atspc[None, :].expand(r.shape)
    within = r <= tab["cutoff"][atspc][None, :]

    rho, rhop, rhopp = _radial_interp(tab, s, r, nder=nder)
    rho = torch.where(within, torch.clamp(rho, min=0.0), zero)
    f = rho.sum(-1)
    z3 = torch.zeros((3, N), dtype=pT.dtype, device=pT.device)
    z6 = torch.zeros((6, N), dtype=pT.dtype, device=pT.device)
    if nder < 1:
        return f, z3, z6

    rinv = 1.0 / r
    rp = torch.where(within, rhop, zero) * rinv         # rhop / r
    fp = (xx * rp[None]).sum(-1)                         # (3, N)
    if nder < 2:
        return f, fp, z6

    rfac = (torch.where(within, rhopp, zero) - rp) * rinv * rinv
    # H = sum_m [ rp * I + rfac * xx xx^T ], symmetric components
    hiso = rp.sum(-1)
    hxx = (rfac * xx[0] * xx[0]).sum(-1) + hiso
    hyy = (rfac * xx[1] * xx[1]).sum(-1) + hiso
    hzz = (rfac * xx[2] * xx[2]).sum(-1) + hiso
    hxy = (rfac * xx[0] * xx[1]).sum(-1)
    hxz = (rfac * xx[0] * xx[2]).sum(-1)
    hyz = (rfac * xx[1] * xx[2]).sum(-1)
    return f, fp, torch.stack([hxx, hyy, hzz, hxy, hxz, hyz])


def promolecular_batch(points, atpos, atspc, tab, nder: int = 2):
    """Batch-first wrapper over promolecular_soa: points (N, 3) ->
    (f (N,), fp (N, 3), fpp (N, 3, 3))."""
    f, fpT, fpp6 = promolecular_soa(points.T, atpos, atspc, tab, nder=nder)
    return f, fpT.T, sym6_to_mat(fpp6)


class PromolEnv:
    """Host-side wrapper: crystal -> candidate atom images + tables.

    The all-electron variant is the promolecular field (field 0); passing
    zpsp builds the core-augmentation variant (cgrid tables).
    """

    def __init__(self, crystal, zpsp: dict | None = None, fragment=None,
                 dtype=FDTYPE, device=None):
        dev = resolve_device(device)
        self.crystal = crystal
        zs = crystal.zatoms
        if zpsp is None:
            zq = sorted({(int(z), 0) for z in zs})
        else:
            # core tables: q = pseudopotential charge per element; atoms of
            # elements without a zpsp entry contribute nothing
            zq = sorted({(int(z), int(zpsp.get(int(z), -1))) for z in zs})
        self.ts = RadialTableSet.build(zq)
        self.tab = promol_tables(self.ts, dtype=dtype, device=dev)
        zq_index = {t: i for i, t in enumerate(zq)}

        rmax = float(np.max(self.ts.cutoff)) if len(self.ts.cutoff) else 0.0
        pos, spc, cidx = crystal.atomic_environment(rmax)
        if fragment is not None:
            keep = np.isin(cidx, np.asarray(fragment, dtype=int))
            pos, spc, cidx = pos[keep], spc[keep], cidx[keep]
        qof = (lambda z: 0) if zpsp is None else \
            (lambda z: int(zpsp.get(int(z), -1)))
        tidx = np.array([zq_index[(crystal.species[s].z,
                                   qof(crystal.species[s].z))]
                         for s in spc], dtype=np.int64)
        if zpsp is not None and len(tidx):
            # drop images whose element has no valid core table (q <= 0)
            valid = np.array([self.ts.zq[t][1] > 0 and
                              (self.ts.zq[t][0] - self.ts.zq[t][1]) > 0
                              for t in tidx])
            pos, tidx, cidx = pos[valid], tidx[valid], cidx[valid]
        self.atpos = torch.as_tensor(np.asarray(pos).reshape(-1, 3),
                                     dtype=dtype, device=dev)
        self.atspc = torch.as_tensor(tidx, device=dev)
        self.cellidx = cidx

    @property
    def device(self):
        return self.atpos.device

    def eval(self, points_cart, nder: int = 2):
        """Density, gradient (N, 3) and Hessian (N, 3, 3) at Cartesian
        points (N, 3)."""
        dt, dev = self.atpos.dtype, self.atpos.device
        pts = torch.atleast_2d(torch.as_tensor(points_cart, dtype=dt,
                                               device=dev))
        if self.atpos.shape[0] == 0:
            n = pts.shape[0]
            return (torch.zeros((n,), dtype=dt, device=dev),
                    torch.zeros((n, 3), dtype=dt, device=dev),
                    torch.zeros((n, 3, 3), dtype=dt, device=dev))
        return promolecular_batch(pts, self.atpos, self.atspc, self.tab,
                                  nder=nder)
