"""Unit-cell metric utilities (host side, NumPy).

Role of the cell-metric part of the reference's crystal class
(src/crystalmod.f90:66-79 and tools_math m_x2c_from_cellpar): conversions
between cell parameters and the crystallographic-to-Cartesian matrix, cell
volume and metric tensors.

Conventions: column-vector matrices. ``m_x2c`` has the lattice vectors as
columns, so r_cart = m_x2c @ x_frac; lengths in bohr, angles in degrees.
"""
from __future__ import annotations

import numpy as np


def m_x2c_from_cellpar(aa, bb) -> np.ndarray:
    """Crystallographic-to-Cartesian matrix (columns = lattice vectors).

    aa: lengths (3,) in bohr; bb: angles (3,) in degrees (alpha, beta, gamma).
    Standard orientation: a along x, b in the xy plane.
    """
    aa = np.asarray(aa, dtype=float)
    cosa = np.cos(np.radians(np.asarray(bb, dtype=float)))
    # clamp numerically degenerate angle combinations
    gamma = np.radians(bb[2])
    singamma = np.sin(gamma)
    m = np.zeros((3, 3))
    m[0, 0] = aa[0]
    m[0, 1] = aa[1] * cosa[2]
    m[1, 1] = aa[1] * singamma
    m[0, 2] = aa[2] * cosa[1]
    m[1, 2] = aa[2] * (cosa[0] - cosa[1] * cosa[2]) / singamma
    m[2, 2] = np.sqrt(
        aa[2] ** 2 - m[0, 2] ** 2 - m[1, 2] ** 2
    )
    return m


def cellpar_from_m_x2c(m: np.ndarray):
    """Cell lengths (bohr) and angles (degrees) from the x2c matrix."""
    m = np.asarray(m, dtype=float)
    aa = np.linalg.norm(m, axis=0)
    cosa = np.array(
        [
            np.dot(m[:, 1], m[:, 2]) / (aa[1] * aa[2]),
            np.dot(m[:, 0], m[:, 2]) / (aa[0] * aa[2]),
            np.dot(m[:, 0], m[:, 1]) / (aa[0] * aa[1]),
        ]
    )
    bb = np.degrees(np.arccos(np.clip(cosa, -1.0, 1.0)))
    return aa, bb


def cell_volume(m_x2c: np.ndarray) -> float:
    return float(abs(np.linalg.det(m_x2c)))


def metric_tensor(m_x2c: np.ndarray) -> np.ndarray:
    """G = m^T m; fractional distance form d^2 = dx^T G dx."""
    return m_x2c.T @ m_x2c


def reciprocal_vectors(m_x2c: np.ndarray) -> np.ndarray:
    """Reciprocal lattice vectors (columns), with the 2*pi factor.

    Standard convention b1 = 2*pi/V a2 x a3 (the reference FFT operators,
    src/grid3mod@proc.f90:1104-1108, use the opposite sign, which is
    irrelevant for the quadratic forms G_i G_j they feed).
    """
    a1, a2, a3 = m_x2c[:, 0], m_x2c[:, 1], m_x2c[:, 2]
    vol = abs(np.linalg.det(m_x2c))
    b = np.empty((3, 3))
    b[:, 0] = np.cross(a2, a3)
    b[:, 1] = np.cross(a3, a1)
    b[:, 2] = np.cross(a1, a2)
    return 2.0 * np.pi / vol * b
