"""Minisurf: triangulated sphere surfaces and IAS surface files.

Role of the reference surface module (src/surface.f90:44-55): the
minisurf type - a center plus unit-sphere rays with per-ray limits -
built by octahedron (spheretriang) or cube (spherecub) recursive
subdivision or by Gauss-Legendre / Lebedev node generation, with the
writeint/readint IAS-file format used by BASINPLOT/INTEGRALS restarts.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["MiniSurf", "sphere_oct", "sphere_cub", "gauleg_nodes",
           "lebedev_nodes"]


def _dedupe_verts(verts, faces, tol=1e-9):
    out = []
    remap = {}
    for i, v in enumerate(verts):
        for j, u in enumerate(out):
            if np.linalg.norm(v - u) < tol:
                remap[i] = j
                break
        else:
            remap[i] = len(out)
            out.append(v)
    faces = [[remap[i] for i in f] for f in faces]
    return np.asarray(out), np.asarray(faces)


def sphere_oct(level: int):
    """Octahedron subdivision of the unit sphere (reference
    spheretriang, src/surface@proc.f90): (verts (nv, 3), tri (nf, 3))."""
    v = np.array([[1., 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                  [0, 0, 1], [0, 0, -1]])
    f = [[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
         [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]]
    verts = list(v)
    faces = f
    for _ in range(level):
        newf = []
        for (a, b, c) in faces:
            ab = verts[a] + verts[b]
            bc = verts[b] + verts[c]
            ca = verts[c] + verts[a]
            ids = []
            for m in (ab, bc, ca):
                m = m / np.linalg.norm(m)
                verts.append(m)
                ids.append(len(verts) - 1)
            i1, i2, i3 = ids
            newf += [[a, i1, i3], [i1, b, i2], [i3, i2, c],
                     [i1, i2, i3]]
        faces = newf
    verts, faces = _dedupe_verts(np.asarray(verts), faces)
    return verts, faces


def sphere_cub(level: int):
    """Cube subdivision of the unit sphere (reference spherecub,
    src/surface@proc.f90): quads split 4-way `level` times, then each
    quad triangulated; vertices projected to the sphere."""
    v = np.array([[1, 1, 1], [-1, 1, 1], [-1, -1, 1], [1, -1, 1],
                  [1, 1, -1], [-1, 1, -1], [-1, -1, -1], [1, -1, -1]],
                 dtype=float)
    quads = [[0, 1, 2, 3], [4, 7, 6, 5], [0, 4, 5, 1], [3, 2, 6, 7],
             [0, 3, 7, 4], [1, 5, 6, 2]]
    verts = list(v)
    for _ in range(level):
        newq = []
        for (a, b, c, d) in quads:
            mab = (verts[a] + verts[b]) / 2
            mbc = (verts[b] + verts[c]) / 2
            mcd = (verts[c] + verts[d]) / 2
            mda = (verts[d] + verts[a]) / 2
            ctr = (verts[a] + verts[b] + verts[c] + verts[d]) / 4
            ids = []
            for m in (mab, mbc, mcd, mda, ctr):
                verts.append(m)
                ids.append(len(verts) - 1)
            i1, i2, i3, i4, i5 = ids
            newq += [[a, i1, i5, i4], [i1, b, i2, i5],
                     [i5, i2, c, i3], [i4, i5, i3, d]]
        quads = newq
    tris = []
    for (a, b, c, d) in quads:
        tris += [[a, b, c], [a, c, d]]
    verts = np.asarray(verts)
    verts = verts / np.linalg.norm(verts, axis=1, keepdims=True)
    verts, tris = _dedupe_verts(verts, tris, tol=1e-9)
    return verts, np.asarray(tris)


def gauleg_nodes(ntheta: int, nphi: int):
    """Gauss-Legendre(theta) x uniform(phi) ray directions + weights
    (reference gauleg_nodes, src/surface@proc.f90); weights sum 4pi."""
    xt, wt = np.polynomial.legendre.leggauss(ntheta)
    th = np.arccos(xt)
    phi = 2 * np.pi * np.arange(nphi) / nphi
    T, P = np.meshgrid(th, phi, indexing="ij")
    W = np.broadcast_to(wt[:, None] * (2 * np.pi / nphi),
                        T.shape).ravel()
    dirs = np.stack([np.sin(T) * np.cos(P), np.sin(T) * np.sin(P),
                     np.cos(T)], axis=-1).reshape(-1, 3)
    return dirs, W


def lebedev_nodes(npts: int):
    """Lebedev ray directions + weights summing to 4 pi (reference
    lebedev_nodes)."""
    from ..ops.lebedev import good_lebedev, lebedev

    p, w = lebedev(good_lebedev(npts))
    return p, w * 4.0 * np.pi


@dataclass
class MiniSurf:
    """Center + unit rays (+ optional faces) + per-ray limits."""

    n: np.ndarray                      # (3,) center, Cartesian
    verts: np.ndarray                  # (nv, 3) unit directions
    faces: np.ndarray = None           # (nf, 3) or None (node surfaces)
    r: np.ndarray = None               # (nv,) ray limits (IAS radii)
    w: np.ndarray = None               # (nv,) weights (node surfaces)

    @property
    def nv(self):
        return len(self.verts)

    @classmethod
    def triang(cls, center, level: int = 3, scheme: str = "oct"):
        gen = sphere_oct if scheme == "oct" else sphere_cub
        v, f = gen(level)
        return cls(n=np.asarray(center, dtype=float), verts=v, faces=f)

    @classmethod
    def nodes(cls, center, kind: str = "lebedev", ntheta: int = 20,
              nphi: int = 40, npts: int = 302):
        if kind == "lebedev":
            d, w = lebedev_nodes(npts)
        else:
            d, w = gauleg_nodes(ntheta, nphi)
        return cls(n=np.asarray(center, dtype=float), verts=d, w=w)

    # -- IAS surface files (reference writeint/readint,
    #    src/surface@proc.f90) -------------------------------------
    def writeint(self, path, n1: int = 0, n2: int = 0, meth: int = 0):
        with open(path, "w") as fh:
            fh.write(f"{n1:10d} {n2:10d} {meth:2d}\n")
            fh.write(" ".join(f"{v:23.15E}" for v in self.n) + "\n")
            r = self.r if self.r is not None else np.zeros(self.nv)
            for lo in range(0, self.nv, 3):
                fh.write(" ".join(f"{v:23.15E}"
                                  for v in r[lo:lo + 3]) + "\n")

    def readint(self, path):
        """Read ray limits; returns (n1, n2, meth). The ray directions
        must match the surface this file was written from."""
        with open(path) as fh:
            toks = fh.read().split()
        n1, n2, meth = int(toks[0]), int(toks[1]), int(toks[2])
        self.n = np.asarray([float(v) for v in toks[3:6]])
        vals = [float(v) for v in toks[6:6 + self.nv]]
        if len(vals) != self.nv:
            raise ValueError("surface file does not match ray count")
        self.r = np.asarray(vals)
        return n1, n2, meth
