"""Delaunay reduction and Wigner-Seitz cell construction (host side).

Replacement for the reference's qhull-based WS construction
(src/crystalmod@proc.f90:3160-3307 `wigner`, src/doqhull.c): the WS cell of
a 3D lattice is the Voronoi cell of the origin against the 14-vector
Delaunay star (ITC 9.1.8), which we compute directly by halfspace
intersection of the 14 bisector planes - no external hull library needed
for this fixed small case.

Outputs per facet: the generating lattice vector (integer, crystallographic
coordinates) and the facet area, exactly the quantities the YT flux weights
consume (src/yt@proc.f90:93-127).
"""
from __future__ import annotations

from dataclasses import dataclass
from itertools import combinations

import numpy as np

EPS = 1e-10


def delaunay_reduce(m_x2c: np.ndarray) -> np.ndarray:
    """Delaunay (Selling) reduction of a lattice.

    Returns rmat (3,4): the four Delaunay vectors in crystallographic
    coordinates, with all pairwise scalar products <= 0.
    Same algorithm as reference src/crystalmod@proc.f90:2491-2538.
    """
    r = np.empty((3, 4))
    r[:, :3] = m_x2c
    r[:, 3] = -(r[:, 0] + r[:, 1] + r[:, 2])
    for _ in range(10000):
        sc = r.T @ r
        np.fill_diagonal(sc, -1.0)
        iu = np.triu_indices(4, 1)
        vals = sc[iu]
        if np.all(vals <= EPS):
            break
        k = int(np.argmax(vals > EPS))
        i, j = iu[0][k], iu[1][k]
        for m in range(4):
            if m != i and m != j:
                r[:, m] = r[:, m] + r[:, i]
        r[:, i] = -r[:, i]
    else:
        raise RuntimeError("Delaunay reduction did not converge")
    return np.linalg.solve(m_x2c, r)  # back to crystallographic coords


def delaunay_star(m_x2c: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The 14-vector star of the Delaunay-reduced lattice.

    Returns (xstar_cart (3,14), istar_crys (3,14) integer).
    """
    rfrac = delaunay_reduce(m_x2c)
    combos = [
        rfrac[:, 0], rfrac[:, 1], rfrac[:, 2], rfrac[:, 3],
        rfrac[:, 0] + rfrac[:, 1],
        rfrac[:, 0] + rfrac[:, 2],
        rfrac[:, 1] + rfrac[:, 2],
    ]
    istar = np.rint(np.stack(combos + [-c for c in combos], axis=1)).astype(int)
    xstar = m_x2c @ istar
    return xstar, istar


def reduced_basis(m_x2c: np.ndarray) -> np.ndarray:
    """Shortest right-handed basis from the Delaunay star (crystallographic
    coordinates, integer 3x3). Mirrors the rbas selection of the reference
    delaunay_reduction (src/crystalmod@proc.f90:2540-2571)."""
    xstar, istar = delaunay_star(m_x2c)
    half = istar[:, :7]
    xhalf = xstar[:, :7]
    order = np.argsort(np.linalg.norm(xhalf, axis=0), kind="stable")
    b = np.empty((3, 3))
    ib = np.empty((3, 3), dtype=int)
    b[:, 0] = xhalf[:, order[0]]
    ib[:, 0] = half[:, order[0]]
    for i in range(1, 7):
        b[:, 1] = xhalf[:, order[i]]
        ib[:, 1] = half[:, order[i]]
        for j in range(i + 1, 7):
            b[:, 2] = xhalf[:, order[j]]
            ib[:, 2] = half[:, order[j]]
            dd = np.linalg.det(b)
            if abs(dd) > EPS:
                if dd < 0:
                    ib = -ib
                return ib.astype(float)
    raise RuntimeError("could not find reduced basis")


@dataclass
class WignerSeitz:
    """Wigner-Seitz cell data.

    ineighx: (nf, 3) int, lattice vectors generating each facet (cryst.)
    ineighc: (nf, 3) float, same in Cartesian
    areas:   (nf,) facet areas (bohr^2)
    vertices: (nv, 3) cell vertices (Cartesian, bohr)
    faces:   list of vertex-index lists, one per facet (ordered)
    """

    ineighx: np.ndarray
    ineighc: np.ndarray
    areas: np.ndarray
    vertices: np.ndarray
    faces: list

    @property
    def nf(self) -> int:
        return len(self.areas)

    @property
    def isortho(self) -> bool:
        ok = self.nf <= 6
        if ok:
            a = np.abs(self.ineighx)
            ok = bool(np.all((a.sum(axis=1) == 1) & (a.max(axis=1) == 1)))
        return ok


def wigner_seitz(m_x2c: np.ndarray) -> WignerSeitz:
    """Construct the WS cell of the lattice defined by m_x2c.

    Voronoi cell of the origin vs the Delaunay 14-star: vertices are
    intersections of bisector-plane triples lying inside all halfspaces;
    facets are the planes supporting >= 3 vertices.
    """
    xstar, istar = delaunay_star(m_x2c)
    p = xstar.T  # (14, 3) neighbor points
    if np.any(np.linalg.norm(p, axis=1) < 1e-5):
        raise ValueError("lattice vector too short; check the unit cell")

    # halfspace: x . p_i <= |p_i|^2 / 2
    nrm2 = np.einsum("ij,ij->i", p, p)
    rhs = 0.5 * nrm2

    verts = []
    scale = np.sqrt(nrm2.max())
    for i, j, k in combinations(range(len(p)), 3):
        a = p[[i, j, k]]
        det = np.linalg.det(a)
        if abs(det) < EPS * scale**3:
            continue
        v = np.linalg.solve(a, rhs[[i, j, k]])
        if np.all(p @ v <= rhs + 1e-8 * scale * scale):
            verts.append(v)
    if not verts:
        raise RuntimeError("WS construction found no vertices")
    verts = np.array(verts)
    # dedupe vertices
    uniq = []
    for v in verts:
        if not any(np.linalg.norm(v - u) < 1e-7 * scale for u in uniq):
            uniq.append(v)
    verts = np.array(uniq)

    faces = []
    fneigh = []
    areas = []
    for i in range(len(p)):
        onplane = np.where(np.abs(verts @ p[i] - rhs[i]) < 1e-7 * scale * scale)[0]
        if len(onplane) < 3:
            continue
        # order the polygon vertices by angle around the facet normal
        n = p[i] / np.linalg.norm(p[i])
        c = verts[onplane].mean(axis=0)
        ref = verts[onplane[0]] - c
        ref = ref - n * (ref @ n)
        ref /= np.linalg.norm(ref)
        ref2 = np.cross(n, ref)
        d = verts[onplane] - c
        ang = np.arctan2(d @ ref2, d @ ref)
        order = onplane[np.argsort(ang)]
        faces.append(list(order))
        fneigh.append(i)
        # polygon area
        vv = verts[order]
        av = np.zeros(3)
        for m in range(len(vv)):
            av += np.cross(vv[m], vv[(m + 1) % len(vv)])
        areas.append(0.5 * abs(av @ n))

    fneigh = np.array(fneigh, dtype=int)
    return WignerSeitz(
        ineighx=istar[:, fneigh].T,
        ineighc=p[fneigh],
        areas=np.array(areas),
        vertices=verts,
        faces=faces,
    )
