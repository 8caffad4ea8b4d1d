"""Trispline interpolation: periodic tensor-product cubic splines.

Role of the reference trispline mode (src/grid3mod@proc.f90:1705-1967 +
init_trispline :2167-2274): global C^2 cubic-spline interpolation of
periodic grids. The reference stores per-axis spline curvatures c2 and
evaluates with a "star" scheme that approximates the cross terms (and
computes off-diagonal Hessian entries by local polynomial interpolation).

Two evaluators, as in the JAX package:
  trispline_soa       the FULL tensor-product spline: all 2^3 mixed
                      curvature grids M^(abc) = (Dx^a Dy^b Dz^c) f are
                      precomputed (spline_coeffs), after which any
                      derivative up to second order is a separable
                      2-point formula - exact C^2 interpolation, 8 corner
                      gathers x 8 grids a point.
  trispline_star_soa  the reference's star scheme, point for point, over
                      the per-axis curvature grids (star_c2).

Dd, the periodic 1-D spline curvature operator along axis d, is the
cyclic tridiagonal (1, 4, 1) solve of the reference's init_trispline. One
helper (_curvature) serves spline_coeffs and star_c2: a dense LU solve of
the n x n cyclic matrix against all lines of the grid at once. The matrix
is circulant and an FFT along the axis would diagonalize it, but an FFT's
rounding error is relative to the largest value on the whole line: with a
nuclear cusp of 10^3 on the grid, the gradient of the spline carries an
absolute error near n * 10^-13 everywhere, which at 256^3 lies above the
Newton search's default 1e-12 threshold at the flat critical points far
from the nuclei. The LU solve of this diagonally dominant matrix keeps
the error relative to the values nearby.
"""
from __future__ import annotations

import torch

from .interp import _base_cell, _gather_stencil_soa

__all__ = ["spline_coeffs", "trispline_soa", "star_c2",
           "trispline_star_soa"]


def _curvature(f, axis: int):
    """Spline curvature operator along `axis` (periodic), batched over the
    other axes: M = 6 n^2 A^{-1} d2 with A = cyclic(1, 4, 1) and d2_i =
    f_{i+1} - 2 f_i + f_{i-1}. A is diagonally dominant, so its LU solve
    needs no pivoting and its rounding error stays local."""
    n = f.shape[axis]
    i = torch.arange(n, device=f.device)
    A = torch.zeros((n, n), dtype=f.dtype, device=f.device)
    A[i, i] = 4.0
    A[i, (i + 1) % n] += 1.0
    A[i, (i - 1) % n] += 1.0
    d2 = torch.roll(f, -1, axis) - 2.0 * f + torch.roll(f, 1, axis)
    rhs = d2.movedim(axis, 0)
    m = torch.linalg.solve(A, rhs.reshape(n, -1) * (6.0 * n * n))
    return m.reshape(rhs.shape).movedim(0, axis)


def spline_coeffs(f):
    """All 8 mixed-curvature grids, stacked (8, n1, n2, n3); index
    bit-packed abc with a = x-curvature, b = y, c = z."""
    out = torch.empty((8,) + tuple(f.shape), dtype=f.dtype, device=f.device)
    out[0] = f
    out[4] = _curvature(f, 0)             # fx
    out[2] = _curvature(f, 1)             # fy
    out[1] = _curvature(f, 2)             # fz
    out[6] = _curvature(out[4], 1)        # fxy
    out[5] = _curvature(out[4], 2)        # fxz
    out[3] = _curvature(out[2], 2)        # fyz
    out[7] = _curvature(out[6], 2)        # fxyz
    return out


def _axis_weights(t, n, order):
    """Weight pairs (w_value (2,N), w_curv (2,N)) for derivative order."""
    one = torch.ones_like(t)
    if order == 0:
        wv = torch.stack([1.0 - t, t])
        u0 = 1.0 - t
        wc = torch.stack([(u0 ** 3 - u0) / (6.0 * n * n),
                          (t ** 3 - t) / (6.0 * n * n)])
    elif order == 1:
        wv = torch.stack([-n * one, n * one])
        u0 = 1.0 - t
        wc = torch.stack([-(3.0 * u0 * u0 - 1.0) / (6.0 * n),
                          (3.0 * t * t - 1.0) / (6.0 * n)])
    else:
        wv = torch.stack([torch.zeros_like(t), torch.zeros_like(t)])
        wc = torch.stack([1.0 - t, t])
    return wv, wc


def trispline_soa(coeffs, xT, nder: int = 2):
    """Evaluate the tensor-product spline at fractional points (3, N).

    coeffs: spline_coeffs output (8, n1, n2, n3). Returns (y, yp (3, N),
    ypp6 (6, N)) in the interp_soa conventions.
    """
    n1, n2, n3 = coeffs.shape[1:]
    ns = (n1, n2, n3)
    i0, t, _ = _base_cell(coeffs[0], xT.to(coeffs.dtype))
    N = xT.shape[1]

    # corner gathers for all 8 grids: (8, 2, 2, 2, N)
    ix = torch.stack([torch.remainder(i0[0], n1),
                      torch.remainder(i0[0] + 1, n1)])        # (2, N)
    iy = torch.stack([torch.remainder(i0[1], n2),
                      torch.remainder(i0[1] + 1, n2)])
    iz = torch.stack([torch.remainder(i0[2], n3),
                      torch.remainder(i0[2] + 1, n3)])
    flat = (ix[:, None, None, :] * (n2 * n3)
            + iy[None, :, None, :] * n3 + iz[None, None, :, :])
    g = coeffs.reshape(8, -1).index_select(
        1, flat.reshape(-1)).reshape(8, 2, 2, 2, N)

    def evaluate(ox, oy, oz):
        wxv, wxc = _axis_weights(t[0], ns[0], ox)
        wyv, wyc = _axis_weights(t[1], ns[1], oy)
        wzv, wzc = _axis_weights(t[2], ns[2], oz)
        out = 0.0
        for a, wx in ((0, wxv), (1, wxc)):
            if ox == 2 and a == 0:
                continue
            for b, wy in ((0, wyv), (1, wyc)):
                if oy == 2 and b == 0:
                    continue
                for c, wz in ((0, wzv), (1, wzc)):
                    if oz == 2 and c == 0:
                        continue
                    G = g[(a << 2) | (b << 1) | c]        # (2,2,2,N)
                    term = (G * wx[:, None, None, :]
                            * wy[None, :, None, :]
                            * wz[None, None, :, :]).sum((0, 1, 2))
                    out = out + term
        return out

    y = evaluate(0, 0, 0)
    z3 = torch.zeros((3, N), dtype=coeffs.dtype, device=coeffs.device)
    z6 = torch.zeros((6, N), dtype=coeffs.dtype, device=coeffs.device)
    if nder < 1:
        return y, z3, z6
    yp = torch.stack([evaluate(1, 0, 0), evaluate(0, 1, 0),
                      evaluate(0, 0, 1)])
    if nder < 2:
        return y, yp, z6
    ypp6 = torch.stack([
        evaluate(2, 0, 0), evaluate(0, 2, 0), evaluate(0, 0, 2),
        evaluate(1, 1, 0), evaluate(1, 0, 1), evaluate(0, 1, 1)])
    return y, yp, ypp6


# ---------------------------------------------------------------------------
# Reference-parity "star" scheme (grinterp_trispline,
# src/grid3mod@proc.f90:1705-1967): directional spline averages for
# value/gradient/diagonal Hessian, local polynomial interpolation of the
# spline first-derivative fields for the off-diagonal Hessian. Matches
# the reference evaluation point-for-point (CP-position parity for
# TRISPLINE fields).
# ---------------------------------------------------------------------------

def star_c2(f):
    """Per-axis spline curvature grids (n1,n2,n3,3) exactly as
    init_trispline (:2167-2274): solve cyclic(1,4,1) c2 = 6 n^2 d2 along
    each axis. Stored axis-first and returned as a permuted view, so each
    c2[..., d] is a contiguous grid the stencil gather reads in place."""
    return torch.stack([_curvature(f, ax)
                        for ax in range(3)]).permute(1, 2, 3, 0)


def trispline_star_soa(f, c2, xfracT, nder: int = 2):
    """Batched star-scheme evaluation. f (n1,n2,n3), c2 (n1,n2,n3,3),
    xfracT (3, N) fractional. Returns (y, yp (3,N), ypp6 (6,N)) in the
    framework convention (derivatives w.r.t. fractional coords)."""
    xT = xfracT.to(f.dtype)
    N = xT.shape[1]
    dev = f.device
    i0, b, nn = _base_cell(f, xT)                 # b: bbb per axis, (3, N)

    offs = torch.arange(-1, 3, device=dev)
    S = _gather_stencil_soa(f, i0, offs)          # (4,4,4,N)
    Sx = _gather_stencil_soa(c2[..., 0], i0, offs)
    Sy = _gather_stencil_soa(c2[..., 1], i0, offs)
    Sz = _gather_stencil_soa(c2[..., 2], i0, offs)

    dix = 1.0 / nn                                # (3,)
    cof = torch.stack([1.0 - b, b])               # (2, 3, N)
    pomsq = (cof ** 3 - cof) / 6.0 * (dix ** 2)[None, :, None]
    pom2sq = (3.0 * cof ** 2 - 1.0) / 6.0 * dix[None, :, None]
    pom2sq = torch.stack([-pom2sq[0], pom2sq[1]])

    c1, c2_, c3 = cof[:, 0], cof[:, 1], cof[:, 2]         # each (2, N)
    p1, p2, p3 = pomsq[:, 0], pomsq[:, 1], pomsq[:, 2]
    q1, q2, q3 = pom2sq[:, 0], pom2sq[:, 1], pom2sq[:, 2]

    # corner slices: stencil indices 1..2 = offsets 0..1
    R = S[1:3, 1:3, 1:3]
    Dx = Sx[1:3, 1:3, 1:3]
    Dy = Sy[1:3, 1:3, 1:3]
    Dz = Sz[1:3, 1:3, 1:3]

    # ddstar (6, N)
    dd = [None] * 6
    for i in range(2):
        dd[i] = sum(c2_[j] * c3[k] * Dx[i, j, k]
                    for j in range(2) for k in range(2))
        dd[i + 2] = sum(c3[j] * c1[k] * Dy[k, i, j]
                        for j in range(2) for k in range(2))
        dd[i + 4] = sum(c1[j] * c2_[k] * Dz[j, k, i]
                        for j in range(2) for k in range(2))

    # sqder / sqvlr (6, 4 Fortran -> dict[(i, j)])
    sqd = {}
    sqv = {}
    for i in range(2):
        for j in range(2):
            sqd[(i, j)] = sum(c2_[k] * Dz[i, k, j] for k in range(2))
            sqd[(i, j + 2)] = sum(c3[k] * Dy[i, j, k] for k in range(2))
            sqd[(i + 2, j)] = sum(c3[k] * Dx[j, i, k] for k in range(2))
            sqd[(i + 2, j + 2)] = sum(c1[k] * Dz[k, i, j] for k in range(2))
            sqd[(i + 4, j)] = sum(c1[k] * Dy[k, j, i] for k in range(2))
            sqd[(i + 4, j + 2)] = sum(c2_[k] * Dx[j, k, i] for k in range(2))
            sqv[(i, j)] = sum(c2_[k] * R[i, k, j] + p2[k] * Dy[i, k, j]
                              for k in range(2))
            sqv[(i, j + 2)] = sum(c3[k] * R[i, j, k] + p3[k] * Dz[i, j, k]
                                  for k in range(2))
            sqv[(i + 2, j + 2)] = sum(c1[k] * R[k, i, j] + p1[k] * Dx[k, i, j]
                                      for k in range(2))
    for i in range(2):
        for j in range(2):
            sqv[(i + 2, j)] = sqv[(j, i + 2)]
            sqv[(i + 4, j)] = sqv[(j + 2, i + 2)]
            sqv[(i + 4, j + 2)] = sqv[(j, i)]

    rh = [None] * 6
    for i in range(2):
        rh[i] = sum(c3[j] * sqv[(i, j)] + p3[j] * sqd[(i, j)]
                    + c2_[j] * sqv[(i, j + 2)] + p2[j] * sqd[(i, j + 2)]
                    for j in range(2))
        rh[i + 2] = sum(c1[j] * sqv[(i + 2, j)] + p1[j] * sqd[(i + 2, j)]
                        + c3[j] * sqv[(i + 2, j + 2)]
                        + p3[j] * sqd[(i + 2, j + 2)] for j in range(2))
        rh[i + 4] = sum(c2_[j] * sqv[(i + 4, j)] + p2[j] * sqd[(i + 4, j)]
                        + c1[j] * sqv[(i + 4, j + 2)]
                        + p1[j] * sqd[(i + 4, j + 2)] for j in range(2))
    rh = [v * 0.5 for v in rh]

    def zeros(*shape):
        return torch.zeros(shape, dtype=f.dtype, device=dev)

    cofk = (c1, c2_, c3)
    pk = (p1, p2, p3)
    qk = (q1, q2, q3)
    y = zeros(N)
    yp = [zeros(N) for _ in range(3)]
    ypp = [[zeros(N) for _ in range(3)] for _ in range(3)]
    for k in range(3):
        for j in range(2):
            sgn = -1.0 if j == 0 else 1.0
            y = y + cofk[k][j] * rh[2 * k + j] + pk[k][j] * dd[2 * k + j]
            yp[k] = yp[k] + qk[k][j] * dd[2 * k + j] \
                + sgn * rh[2 * k + j] * nn[k]
            ypp[k][k] = ypp[k][k] + cofk[k][j] * dd[2 * k + j]
    y = y / 3.0
    if nder < 1:
        return y, zeros(3, N), zeros(6, N)
    ypT = torch.stack(yp)
    if nder < 2:
        return y, ypT, zeros(6, N)

    # --- off-diagonal Hessian: polynomial interpolation of the spline
    # first-derivative estimates along each axis (:1855-1947) ----------
    def newton_deriv(hh, tfrac, nk):
        """First derivative at tfrac of the cubic through 4 equally
        spaced nodes hh[a] at positions (a-1)/nk relative to the cell
        node; tfrac = b/nk is the in-cell position."""
        # divided differences with spacing 1/nk
        h1 = [(hh[a + 1] - hh[a]) * nk for a in range(3)]
        h2 = [(h1[a + 1] - h1[a]) * nk / 2.0 for a in range(2)]
        h3 = [(h2[1] - h2[0]) * nk / 3.0]
        # Newton form around node offsets (-1, 0, 1, 2)/nk; evaluate the
        # derivative at t = tfrac (distance from node offset -1 is
        # tfrac + 1/nk)
        t0 = tfrac + 1.0 / nk       # x - x_1
        t1 = tfrac                  # x - x_2
        t2 = tfrac - 1.0 / nk       # x - x_3
        # p(x) = c0 + c1 t0 + c2 t0 t1 + c3 t0 t1 t2
        # p'(x) = c1 + c2 (t0 + t1) + c3 (t0 t1 + t0 t2 + t1 t2)
        return (h1[0] + h2[0] * (t0 + t1)
                + h3[0] * (t0 * t1 + t0 * t2 + t1 * t2))

    tin = b * dix[:, None]      # in-cell fractional offset per axis (3,N)

    # axis x (ii=0): hh over stencil index a; mixed with y (nn=1) and z (2)
    hh_y = []
    hh_z = []
    for a in range(4):
        ddu0 = c3[0] * Sy[a, 1, 1] + c3[1] * Sy[a, 1, 2]
        ddu1 = c3[0] * Sy[a, 2, 1] + c3[1] * Sy[a, 2, 2]
        hrh0 = c3[0] * S[a, 1, 1] + c3[1] * S[a, 1, 2] \
            + p3[0] * Sz[a, 1, 1] + p3[1] * Sz[a, 1, 2]
        hrh1 = c3[0] * S[a, 2, 1] + c3[1] * S[a, 2, 2] \
            + p3[0] * Sz[a, 2, 1] + p3[1] * Sz[a, 2, 2]
        hh_y.append((hrh1 - hrh0) * nn[1] + q2[0] * ddu0 + q2[1] * ddu1)
        ddu0 = c2_[0] * Sz[a, 1, 1] + c2_[1] * Sz[a, 2, 1]
        ddu1 = c2_[0] * Sz[a, 1, 2] + c2_[1] * Sz[a, 2, 2]
        hrh0 = c2_[0] * S[a, 1, 1] + c2_[1] * S[a, 2, 1] \
            + p2[0] * Sy[a, 1, 1] + p2[1] * Sy[a, 2, 1]
        hrh1 = c2_[0] * S[a, 1, 2] + c2_[1] * S[a, 2, 2] \
            + p2[0] * Sy[a, 1, 2] + p2[1] * Sy[a, 2, 2]
        hh_z.append((hrh1 - hrh0) * nn[2] + q3[0] * ddu0 + q3[1] * ddu1)
    dxy = newton_deriv(hh_y, tin[0], nn[0])
    dxz = newton_deriv(hh_z, tin[0], nn[0])
    ypp[0][1] = ypp[0][1] + dxy
    ypp[1][0] = ypp[1][0] + dxy
    ypp[0][2] = ypp[0][2] + dxz
    ypp[2][0] = ypp[2][0] + dxz

    # axis y (ii=1): mixed with z (nn=2, hh(:,1)) and x (nn=0, hh(:,2))
    hh_z2 = []
    hh_x = []
    for a in range(4):
        ddu0 = c3[0] * Sx[1, a, 1] + c3[1] * Sx[1, a, 2]
        ddu1 = c3[0] * Sx[2, a, 1] + c3[1] * Sx[2, a, 2]
        hrh0 = c3[0] * S[1, a, 1] + c3[1] * S[1, a, 2] \
            + p3[0] * Sz[1, a, 1] + p3[1] * Sz[1, a, 2]
        hrh1 = c3[0] * S[2, a, 1] + c3[1] * S[2, a, 2] \
            + p3[0] * Sz[2, a, 1] + p3[1] * Sz[2, a, 2]
        hh_x.append((hrh1 - hrh0) * nn[0] + q1[0] * ddu0 + q1[1] * ddu1)
        ddu0 = c1[0] * Sz[1, a, 1] + c1[1] * Sz[2, a, 1]
        ddu1 = c1[0] * Sz[1, a, 2] + c1[1] * Sz[2, a, 2]
        hrh0 = c1[0] * S[1, a, 1] + c1[1] * S[2, a, 1] \
            + p1[0] * Sx[1, a, 1] + p1[1] * Sx[2, a, 1]
        hrh1 = c1[0] * S[1, a, 2] + c1[1] * S[2, a, 2] \
            + p1[0] * Sx[1, a, 2] + p1[1] * Sx[2, a, 2]
        hh_z2.append((hrh1 - hrh0) * nn[2] + q3[0] * ddu0 + q3[1] * ddu1)
    dyz = newton_deriv(hh_z2, tin[1], nn[1])
    dyx = newton_deriv(hh_x, tin[1], nn[1])
    ypp[1][2] = ypp[1][2] + dyz
    ypp[2][1] = ypp[2][1] + dyz
    ypp[1][0] = ypp[1][0] + dyx
    ypp[0][1] = ypp[0][1] + dyx

    # axis z (ii=2): mixed with x (nn=0, hh(:,1)) and y (nn=1, hh(:,2))
    hh_y2 = []
    hh_x2 = []
    for a in range(4):
        ddu0 = c1[0] * Sy[1, 1, a] + c1[1] * Sy[2, 1, a]
        ddu1 = c1[0] * Sy[1, 2, a] + c1[1] * Sy[2, 2, a]
        hrh0 = c1[0] * S[1, 1, a] + c1[1] * S[2, 1, a] \
            + p1[0] * Sx[1, 1, a] + p1[1] * Sx[2, 1, a]
        hrh1 = c1[0] * S[1, 2, a] + c1[1] * S[2, 2, a] \
            + p1[0] * Sx[1, 2, a] + p1[1] * Sx[2, 2, a]
        hh_y2.append((hrh1 - hrh0) * nn[1] + q2[0] * ddu0 + q2[1] * ddu1)
        ddu0 = c2_[0] * Sx[1, 1, a] + c2_[1] * Sx[1, 2, a]
        ddu1 = c2_[0] * Sx[2, 1, a] + c2_[1] * Sx[2, 2, a]
        hrh0 = c2_[0] * S[1, 1, a] + c2_[1] * S[1, 2, a] \
            + p2[0] * Sy[1, 1, a] + p2[1] * Sy[1, 2, a]
        hrh1 = c2_[0] * S[2, 1, a] + c2_[1] * S[2, 2, a] \
            + p2[0] * Sy[2, 1, a] + p2[1] * Sy[2, 2, a]
        hh_x2.append((hrh1 - hrh0) * nn[0] + q1[0] * ddu0 + q1[1] * ddu1)
    dzx = newton_deriv(hh_x2, tin[2], nn[2])
    dzy = newton_deriv(hh_y2, tin[2], nn[2])
    ypp[2][0] = ypp[2][0] + dzx
    ypp[0][2] = ypp[0][2] + dzx
    ypp[2][1] = ypp[2][1] + dzy
    ypp[1][2] = ypp[1][2] + dzy

    ypp6 = torch.stack([ypp[0][0], ypp[1][1], ypp[2][2],
                        ypp[0][1] / 2.0, ypp[0][2] / 2.0, ypp[1][2] / 2.0])
    return y, ypT, ypp6
