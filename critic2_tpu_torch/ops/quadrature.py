"""Quadrature engines: batched adaptive Gauss-Kronrod radial panels and
the Keast tetrahedral rules.

Role of the reference quadpack (QAGS/QNG/QAG used by int_radialquad,
src/integration@proc.f90:272-374). The reference adapts one ray at a
time with scalar quadpack; here ALL rays advance together: each
host-side round evaluates every active panel's 15 Kronrod nodes for
every ray in ONE device batch, accepts converged panels and bisects the
rest. The Keast rules (reference keast.f90) serve qtree's tetrahedral
cubature; their tables are data, read from the JAX package's
``keast.npz`` by file path.
"""
from __future__ import annotations

import functools
import os

import numpy as np

from ..param import DATA_DIR

__all__ = ["gauleg", "radial_gauleg", "radial_adaptive", "keast_rule",
           "keast_points"]

# 15-point Kronrod extension of 7-point Gauss (standard G7K15 pair)
_XK = np.array([
    -0.991455371120813, -0.949107912342759, -0.864864423359769,
    -0.741531185599394, -0.586087235467691, -0.405845151377397,
    -0.207784955007898, 0.0,
    0.207784955007898, 0.405845151377397, 0.586087235467691,
    0.741531185599394, 0.864864423359769, 0.949107912342759,
    0.991455371120813])
_WK = np.array([
    0.022935322010529, 0.063092092629979, 0.104790010322250,
    0.140653259715525, 0.169004726639267, 0.190350578064785,
    0.204432940075298, 0.209482141084728,
    0.204432940075298, 0.190350578064785, 0.169004726639267,
    0.140653259715525, 0.104790010322250, 0.063092092629979,
    0.022935322010529])
_WG = np.array([
    0.129484966168870, 0.279705391489277, 0.381830050505119,
    0.417959183673469,
    0.381830050505119, 0.279705391489277, 0.129484966168870])
_GIDX = np.arange(1, 15, 2)      # Gauss nodes are the odd Kronrod nodes


def gauleg(a, b, n):
    """Gauss-Legendre nodes/weights on [a, b] (reference gauleg,
    src/tools_math)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (b - a) * x + 0.5 * (b + a), 0.5 * (b - a) * w


def radial_gauleg(eval_batch, x0, units, r0, rend, nr: int = 50):
    """Fixed-order radial quadrature sum_k w_k r_k^2 f(x0 + r_k u) for a
    batch of rays (int_radialquad INT_gauleg branch,
    src/integration@proc.f90:318-336). r0/rend may be scalars or (M,).

    eval_batch(points (N,3)) -> (N,) or (N,P) property values.
    Returns (M,) or (M,P)."""
    x0 = np.atleast_2d(np.asarray(x0, float))
    units = np.atleast_2d(np.asarray(units, float))
    M = len(units)
    r0 = np.broadcast_to(np.asarray(r0, float), (M,))
    rend = np.broadcast_to(np.asarray(rend, float), (M,))
    xg, wg = np.polynomial.legendre.leggauss(nr)
    rr = 0.5 * (rend - r0)[:, None] * xg[None, :] \
        + 0.5 * (rend + r0)[:, None]                        # (M, nr)
    ww = 0.5 * (rend - r0)[:, None] * wg[None, :]
    pts = (x0 if len(x0) == M else np.repeat(x0, M, 0))[:, None, :] \
        + rr[..., None] * units[:, None, :]
    vals = np.asarray(eval_batch(pts.reshape(-1, 3)))
    vals = vals.reshape((M, nr) + vals.shape[1:])
    w = (ww * rr * rr)
    if vals.ndim == 3:
        w = w[..., None]
    return (vals * w).sum(axis=1)


def radial_adaptive(eval_batch, x0, units, r0, rend, abserr: float = 1e-10,
                    relerr: float = 1e-7, max_rounds: int = 30):
    """Adaptive G7K15 radial quadrature int r^2 f(x0 + r u) dr for a
    batch of rays, replacing quadpack QAGS/QNG/QAG
    (src/integration@proc.f90:338-366). All rays' active panels are
    evaluated in one device batch per round; failing panels bisect.

    Returns (integrals (M,) or (M,P), error (M,), neval)."""
    x0 = np.atleast_2d(np.asarray(x0, float))
    units = np.atleast_2d(np.asarray(units, float))
    M = len(units)
    if len(x0) != M:
        x0 = np.repeat(x0, M, 0)
    r0 = np.broadcast_to(np.asarray(r0, float), (M,))
    rend = np.broadcast_to(np.asarray(rend, float), (M,))
    sign = np.where(rend >= r0, 1.0, -1.0)

    ray = np.arange(M)
    a = np.minimum(r0, rend).copy()
    b = np.maximum(r0, rend).copy()

    total = None
    err_tot = np.zeros(M)
    neval = 0
    for rnd in range(max_rounds):
        if len(ray) == 0:
            break
        mid = 0.5 * (a + b)[:, None]
        half = 0.5 * (b - a)[:, None]
        rr = mid + half * _XK[None, :]                       # (npan, 15)
        pts = x0[ray][:, None, :] + rr[..., None] * units[ray][:, None, :]
        vals = np.asarray(eval_batch(pts.reshape(-1, 3)))
        neval += pts.shape[0] * pts.shape[1]
        multi = vals.ndim == 2
        vals = vals.reshape((len(ray), 15) + vals.shape[1:])
        integ = vals * (rr * rr if not multi else (rr * rr)[..., None])
        h = half[:, 0] if not multi else half[:, 0][:, None]
        k15 = (integ * (_WK[None, :, None] if multi else _WK[None, :])
               ).sum(axis=1) * h
        g7 = (integ[:, _GIDX] * (_WG[None, :, None] if multi
                                 else _WG[None, :])).sum(axis=1) * h
        perr = np.abs(k15 - g7)
        if multi:
            perr = perr.max(axis=1)

        if total is None:
            total = np.zeros((M,) + k15.shape[1:])
        mag = np.abs(k15).max(axis=1) if multi else np.abs(k15)
        tol = np.maximum(abserr, relerr * np.maximum(mag, 1e-300))
        done = (perr <= tol) | (b - a < 1e-12) | (rnd == max_rounds - 1)
        np.add.at(total, ray[done], k15[done])
        np.add.at(err_tot, ray[done], perr[done])
        keep = ~done
        if not keep.any():
            break
        ray = np.concatenate([ray[keep], ray[keep]])
        mids = 0.5 * (a[keep] + b[keep])
        a = np.concatenate([a[keep], mids])
        b = np.concatenate([mids, b[keep]])
    return total * (sign[:, None] if total.ndim == 2 else sign), \
        err_tot, neval


# ----------------------------------------------------------------- keast

@functools.lru_cache(maxsize=1)
def _keast_tables() -> dict:
    with np.load(os.path.join(DATA_DIR, "keast.npz")) as f:
        return {k: f[k] for k in f.files}


def keast_rule(rule: int):
    """(nodes (n,3) barycentric, weights (n,)) of Keast rule 1..10,
    weights summing to 1/6 (unit tetrahedron volume)."""
    t = _keast_tables()
    return t[f"nodes{rule}"], t[f"weights{rule}"]


def keast_points(tets, rule: int):
    """Quadrature points/weights for a batch of tetrahedra (T, 4, 3):
    returns (points (T, n, 3), weights (T, n)) with weights including
    the 6V scaling so sum w = volume."""
    nodes, w = keast_rule(rule)
    v0 = tets[:, 0]
    e = tets[:, 1:] - v0[:, None, :]                         # (T, 3, 3)
    # unit-tet coordinates (x, y, z): p = v0 + x e1 + y e2 + z e3
    pts = v0[:, None, :] + np.einsum("nj,tjd->tnd", nodes, e)
    vol6 = np.abs(np.einsum("ti,ti->t", np.cross(e[:, 0], e[:, 1]), e[:, 2]))
    wts = w[None, :] * vol6[:, None]
    return pts, wts
