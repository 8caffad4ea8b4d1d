"""Plain reference of Yu-Trinkle basin integration (Yu and Trinkle, JCP
134, 064111 (2011); critic2 src/yt@proc.f90) on a periodic grid.

From the density alone: the Wigner-Seitz facets of the grid-point
lattice (scipy's Voronoi), the uphill flux fractions over them, the
attractors (points with no uphill neighbour), and each basin's volume
and charge as the exact fixpoint of the adjoint flux equations by plain
Jacobi passes of torch.roll, which converge bitwise after as many passes
as the longest uphill chain is long. Runs in the dtype it is given:
float64 is the reference, float32 its control.

Rules, as critic2 states them: a neighbour is uphill when its density is
higher, or equal with a lower flat index (the stable descending sort); a
point sends A_k (rho_k - rho) / l_k of its mass to each uphill
neighbour, normalised; a point whose uphill neighbours all carry zero
flux sends everything to the highest of them.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

# facets smaller than this share of the largest are lattice degeneracies
FACET_RTOL = 1e-8
MAX_PASSES = 100_000


def ws_facets(m_grid) -> tuple:
    """(offsets (K, 3) int, A_k / l_k (K,)) of the Voronoi cell of the
    lattice spanned by the columns of m_grid (bohr), one entry per facet."""
    from scipy.spatial import ConvexHull, Voronoi

    m = np.asarray(m_grid, dtype=float)
    rng = range(-2, 3)
    ijk = np.array(list(itertools.product(rng, rng, rng)), dtype=float)
    pts = ijk @ m.T
    centre = int(np.flatnonzero((ijk == 0).all(1))[0])
    vor = Voronoi(pts)
    offs, areas, lens = [], [], []
    for (p, q), rv in zip(vor.ridge_points, vor.ridge_vertices):
        if centre not in (p, q) or -1 in rv:
            continue
        other = q if p == centre else p
        v = vor.vertices[rv]
        nrm = pts[other] / np.linalg.norm(pts[other])
        # polygon area: project onto the facet plane, 2-D hull area
        u = np.cross(nrm, [1.0, 0.0, 0.0])
        if np.linalg.norm(u) < 0.5:
            u = np.cross(nrm, [0.0, 1.0, 0.0])
        u /= np.linalg.norm(u)
        w = np.cross(nrm, u)
        xy = np.stack([v @ u, v @ w], 1)
        area = ConvexHull(xy).volume if len(v) >= 3 else 0.0
        offs.append(ijk[other].astype(int))
        areas.append(area)
        lens.append(np.linalg.norm(pts[other]))
    areas = np.asarray(areas)
    keep = areas > FACET_RTOL * areas.max()
    offs = np.asarray(offs)[keep]
    wts = areas[keep] / np.asarray(lens)[keep]
    order = np.lexsort(offs.T[::-1])
    return offs[order], wts[order]


def grid_lattice(lattice_bohr, shape) -> np.ndarray:
    return np.asarray(lattice_bohr, dtype=float) / np.asarray(
        shape, dtype=float)[None, :]


def flux(rho, offs, wts):
    """(chi (K, n1, n2, n3), attractor mask): chi[k, x] is the share of
    x's mass that goes to x + offs[k]."""
    dt, dev = rho.dtype, rho.device
    idx = torch.arange(rho.numel(), device=dev).reshape(rho.shape)
    K = len(offs)
    chi = torch.zeros((K,) + tuple(rho.shape), dtype=dt, device=dev)
    uphill_any = torch.zeros(rho.shape, dtype=torch.bool, device=dev)
    best_rho = torch.full(rho.shape, -torch.inf, dtype=dt, device=dev)
    best_idx = torch.full(rho.shape, -1, dtype=torch.int64, device=dev)
    best_k = torch.full(rho.shape, -1, dtype=torch.int64, device=dev)
    for k, o in enumerate(offs):
        shift = tuple(-int(v) for v in o)          # value at x + o
        rk = torch.roll(rho, shift, (0, 1, 2))
        ik = torch.roll(idx, shift, (0, 1, 2))
        up = (rk > rho) | ((rk == rho) & (ik < idx))
        uphill_any |= up
        chi[k] = torch.where(up, float(wts[k]) * (rk - rho),
                             torch.zeros((), dtype=dt, device=dev))
        better = up & ((rk > best_rho) | ((rk == best_rho) & (ik < best_idx)))
        best_rho = torch.where(better, rk, best_rho)
        best_idx = torch.where(better, ik, best_idx)
        best_k = torch.where(better, k, best_k)
    tot = chi.sum(0)
    pos = tot > 0
    chi = torch.where(pos[None], chi / torch.where(pos, tot, 1.0)[None],
                      chi)
    for k in range(K):
        chi[k] = torch.where(~pos & (best_k == k),
                             torch.ones((), dtype=dt, device=dev), chi[k])
    return chi, ~uphill_any


def adjoint_fixpoint(chi, offs, f):
    """s = f + sum_k roll(chi_k s, +o_k): the mass each point holds once
    every point upstream has passed its share on. f: (P, n1, n2, n3).
    Returns (s, passes)."""
    # the share a point receives from x - o_k, aligned with the receiver
    recv = torch.stack([torch.roll(chi[k], tuple(int(v) for v in o),
                                   (0, 1, 2)) for k, o in enumerate(offs)])
    s = f
    for npass in range(1, MAX_PASSES + 1):
        new = f.clone()
        for k, o in enumerate(offs):
            new.addcmul_(recv[k][None],
                         torch.roll(s, tuple(int(v) for v in o), (1, 2, 3)))
        if torch.equal(new, s):
            return s, npass
        s = new
    raise RuntimeError(f"no fixpoint after {MAX_PASSES} passes")


def basins(rho, lattice_bohr, dtype=torch.float64) -> dict:
    """Attractors (flat grid indices, ascending) with each basin's volume
    (bohr^3) and charge (e), computed in `dtype`."""
    rho = rho.to(dtype)
    shape = tuple(int(v) for v in rho.shape)
    offs, wts = ws_facets(grid_lattice(lattice_bohr, shape))
    chi, attr = flux(rho, offs, wts)
    iattr = torch.nonzero(attr.reshape(-1)).reshape(-1)
    f = torch.stack([torch.ones_like(rho), rho])
    s, npass = adjoint_fixpoint(chi, offs, f)
    del chi
    dv = abs(float(np.linalg.det(np.asarray(lattice_bohr, float)))) \
        / float(np.prod(shape))
    q = s.reshape(2, -1)[:, iattr].to(torch.float64).cpu().numpy() * dv
    return {"iattr": iattr.cpu().numpy(), "volume": q[0], "charge": q[1],
            "passes": npass, "K": len(offs)}
