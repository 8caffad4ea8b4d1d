"""3D scene writers: OBJ / PLY / OFF.

Role of the reference graphics module (src/graphics.f90:39-47): a unified
scene of balls (icosahedra), sticks (prisms), and triangulated surfaces
written to Wavefront OBJ, Stanford PLY, or Geomview OFF - consumed by
CPREPORT/FLUXPRINT/BASINPLOT.
"""
from __future__ import annotations

import numpy as np

__all__ = ["Scene"]

# icosahedron for ball rendering
_PHI = (1 + 5 ** 0.5) / 2
_ICO_V = np.array([
    [-1, _PHI, 0], [1, _PHI, 0], [-1, -_PHI, 0], [1, -_PHI, 0],
    [0, -1, _PHI], [0, 1, _PHI], [0, -1, -_PHI], [0, 1, -_PHI],
    [_PHI, 0, -1], [_PHI, 0, 1], [-_PHI, 0, -1], [-_PHI, 0, 1]])
_ICO_V = _ICO_V / np.linalg.norm(_ICO_V[0])
_ICO_F = np.array([
    [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
    [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
    [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
    [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]])


class Scene:
    """Accumulate geometry; write to obj/ply/off by extension."""

    def __init__(self):
        self.v = []          # vertices (3,)
        self.f = []          # triangle faces (3 vertex ids, 0-based)
        self.seg = []        # polyline segments (2 vertex ids)
        self.vcol = []       # per-vertex color (3,) in 0..1

    def _addv(self, p, color):
        self.v.append(np.asarray(p, dtype=float))
        self.vcol.append(np.asarray(color, dtype=float))
        return len(self.v) - 1

    def ball(self, center, r=0.4, color=(0.5, 0.5, 0.5)):
        base = len(self.v)
        for p in _ICO_V:
            self._addv(np.asarray(center) + r * p, color)
        for tri in _ICO_F:
            self.f.append(base + tri)

    def stick(self, p0, p1, r=0.05, color=(0.6, 0.6, 0.6), nseg=8):
        p0 = np.asarray(p0, dtype=float)
        p1 = np.asarray(p1, dtype=float)
        d = p1 - p0
        n = np.linalg.norm(d)
        if n < 1e-12:
            return
        d = d / n
        a = np.array([1.0, 0, 0]) if abs(d[0]) < 0.9 else np.array([0, 1.0, 0])
        u = np.cross(d, a)
        u /= np.linalg.norm(u)
        w = np.cross(d, u)
        base = len(self.v)
        for t, p in ((0, p0), (1, p1)):
            for k in range(nseg):
                ang = 2 * np.pi * k / nseg
                self._addv(p + r * (np.cos(ang) * u + np.sin(ang) * w),
                           color)
        for k in range(nseg):
            k2 = (k + 1) % nseg
            self.f.append(np.array([base + k, base + nseg + k, base + k2]))
            self.f.append(np.array([base + k2, base + nseg + k,
                                    base + nseg + k2]))

    def path(self, points, color=(1.0, 0.2, 0.2)):
        base = len(self.v)
        for p in points:
            self._addv(p, color)
        for i in range(len(points) - 1):
            self.seg.append((base + i, base + i + 1))

    def surface(self, verts, faces, color=(0.2, 0.4, 0.9)):
        base = len(self.v)
        for p in verts:
            self._addv(p, color)
        for tri in faces:
            self.f.append(base + np.asarray(tri))

    # ------------------------------------------------------------------
    def write(self, path: str):
        low = path.lower()
        if low.endswith(".obj"):
            return self._write_obj(path)
        if low.endswith(".ply"):
            return self._write_ply(path)
        if low.endswith(".off"):
            return self._write_off(path)
        raise ValueError(f"unknown scene format: {path}")

    def _write_obj(self, path):
        with open(path, "w") as f:
            f.write("# critic2-tpu scene\n")
            for p in self.v:
                f.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
            for tri in self.f:
                f.write(f"f {tri[0] + 1} {tri[1] + 1} {tri[2] + 1}\n")
            for s in self.seg:
                f.write(f"l {s[0] + 1} {s[1] + 1}\n")

    def _write_ply(self, path):
        with open(path, "w") as f:
            f.write("ply\nformat ascii 1.0\n")
            f.write(f"element vertex {len(self.v)}\n")
            f.write("property float x\nproperty float y\nproperty float z\n")
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
            f.write(f"element face {len(self.f)}\n")
            f.write("property list uchar int vertex_indices\nend_header\n")
            for p, cc in zip(self.v, self.vcol):
                rgb = (np.asarray(cc) * 255).astype(int)
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                        f"{rgb[0]} {rgb[1]} {rgb[2]}\n")
            for tri in self.f:
                f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n")

    def _write_off(self, path):
        with open(path, "w") as f:
            f.write("OFF\n")
            f.write(f"{len(self.v)} {len(self.f)} 0\n")
            for p in self.v:
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
            for tri in self.f:
                f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n")
