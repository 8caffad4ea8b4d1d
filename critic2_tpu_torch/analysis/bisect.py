"""Interatomic-surface (IAS) determination by bisection, basin plotting,
and bisection-based basin/sphere integration.

Role of the reference bisect (src/bisect.f90 + @proc, 2.2 kLoC): from an
attractor, shoot rays; on each ray find the basin-boundary radius r_IAS
(the largest r whose uphill gradient path still terminates at the
attractor) by bisection; triangulated ray sets give BASINPLOT surfaces;
Gauss-Legendre radial quadrature up to r_IAS(theta, phi) gives basin
integrals (INTEGRALS), and fixed-radius sphere quadrature gives
SPHEREINTEGRALS.

Decomposition: all rays bisect in lockstep - every bisection step is one
batched gradient-path trace (ops/ode.trace_paths); the radial quadrature
evaluates nr x nrays points in one batch. Everything runs on the device
of the system's reference field; ray sets, radii and integrals are host
numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import FDTYPE, resolve_device
from ..ops.ode import trace_paths

__all__ = ["basin_rays", "bisect_basin", "basinplot", "basin_integral",
           "sphere_integral"]


def _attr_images(system, cpl=None):
    """Target list for path termination: nuclei (+ ncp CPs), with images
    and the owning center id."""
    c = system.crystal
    pos = np.asarray(c.x_frac)
    ids = np.arange(c.ncel)
    if c.ismolecule:
        return c.x2c(pos), ids
    shifts = np.array([[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1)
                       for k in (-1, 0, 1)])
    imgs = (pos[None, :, :] + shifts[:, None, :]).reshape(-1, 3)
    return c.x2c(imgs), np.tile(ids, len(shifts))


def _field_values(system, expr):
    """Host closure points (N, 3) numpy -> reference-field (or `expr`)
    values (N,) numpy, evaluated on the system's device."""
    dev = resolve_device(system.device)
    if expr is not None:
        from ..arithmetic import compile_expr

        fn = compile_expr(expr, system)

        def eval_expr(pts):
            xT = torch.as_tensor(np.ascontiguousarray(pts.T), dtype=FDTYPE,
                                 device=dev)
            return fn(xT).cpu().numpy()

        return eval_expr
    f = system.ref
    fn0 = f.eval_fn(nder=0)

    def eval_batch(pts):
        xT = torch.as_tensor(np.ascontiguousarray(pts.T), dtype=FDTYPE,
                             device=f.device)
        return fn0(xT)[0].cpu().numpy()

    return eval_batch


def basin_rays(level: int = 2):
    """Unit-sphere directions from recursive octahedron triangulation
    (reference minisurf spheretriang); returns (dirs (M,3), faces)."""
    from .autocp import _sphere_triangulation

    dirs = _sphere_triangulation(level)
    # build faces by convex hull of the direction set (host, small)
    faces = _hull_faces(dirs)
    return dirs, faces


def _hull_faces(pts):
    """Triangular faces of the convex hull of unit points (gift-wrap via
    normals; small sets only). Replaces qhull's basin triangulation
    (reference runqhull_basintriangulate, src/doqhull.c:132-180)."""
    from itertools import combinations

    n = len(pts)
    faces = []
    if n > 600:
        raise ValueError("too many rays for the naive hull; use level<=3")
    for i, j, k in combinations(range(n), 3):
        a, b, c = pts[i], pts[j], pts[k]
        nrm = np.cross(b - a, c - a)
        if np.linalg.norm(nrm) < 1e-12:
            continue
        s = pts @ nrm - a @ nrm
        if (s < 1e-9).all() or (s > -1e-9).all():
            if (s > -1e-9).all():
                faces.append((i, k, j))
            else:
                faces.append((i, j, k))
    return np.asarray(faces)


def bisect_basin(system, center_frac, dirs, rmax: float | None = None,
                 tol: float = 1e-4, maxit: int = 40, cpeps: float = 0.2):
    """IAS radius along each unit direction from the attractor at
    center_frac (reference bisect rays). Returns r (M,).

    rmax defaults to the WS-cell circumradius: beyond it a ray wraps into
    a periodic image of the basin and 'inside' stops being meaningful.
    """
    resolve_device(system.device)
    c = system.crystal
    f = system.ref
    if rmax is None:
        if c.ismolecule:
            rmax = float(np.max(np.asarray(c.aa)))
        else:
            rmax = float(np.linalg.norm(c.ws.vertices, axis=1).max())
    fn = f.eval_fn(nder=2)
    x0 = c.x2c(np.asarray(center_frac))
    tgt, tgt_ids = _attr_images(system)
    # which target id is "ours"
    own_id, d0 = c.identify_atom(np.asarray(center_frac), distmax=1e-2)
    rt = np.full(len(tgt), cpeps)

    M = len(dirs)
    dirsj = np.asarray(dirs)

    def inside(r):
        pts = x0[None, :] + r[:, None] * dirsj
        _, status, termid, _, _ = trace_paths(
            fn, torch.as_tensor(pts, dtype=FDTYPE, device=f.device), iup=1,
            targets=tgt, rterm=rt, mstep=600,
            m_c2x=c.m_c2x if c.ismolecule else None,
            molborder=c.molborder if c.ismolecule else None)
        status = status.cpu().numpy()
        termid = termid.cpu().numpy()
        ok = (status == 0) & (termid >= 0)
        owner = np.where(ok, tgt_ids[np.clip(termid, 0, len(tgt_ids) - 1)],
                         -1)
        return owner == own_id

    lo = np.full(M, 1e-3)
    hi = np.full(M, rmax)
    for _ in range(maxit):
        if np.max(hi - lo) < tol:
            break
        mid = 0.5 * (lo + hi)
        ins = inside(mid)
        lo = np.where(ins, mid, lo)
        hi = np.where(ins, hi, mid)
    return 0.5 * (lo + hi)


def basinplot(system, center_frac, level: int = 2, file: str | None = None,
              rmax: float | None = None, tol: float = 1e-4,
              maxit: int = 40):
    """Triangulated basin surface of the attractor (reference BASINPLOT;
    tol/maxit mirror the reference PREC option)."""
    from ..io.graphics import Scene

    dirs, faces = basin_rays(level)
    r = bisect_basin(system, center_frac, dirs, rmax=rmax, tol=tol,
                     maxit=maxit)
    x0 = system.crystal.x2c(np.asarray(center_frac))
    verts = x0[None, :] + r[:, None] * dirs
    scene = Scene()
    scene.surface(verts, faces)
    if file:
        scene.write(file)
    return verts, faces, r


def basin_integral(system, center_frac, expr: str = None, level: int = 2,
                   nr: int = 50, rmax: float | None = None,
                   radquad: str = "gauleg", rbeta: float = 0.0,
                   abserr: float = 1e-10, relerr: float = 1e-7):
    """Basin integral by bisection + radial quadrature (reference
    INTEGRALS, src/integration@proc.f90 int_radialquad).

    radquad: "gauleg" (fixed-order, INT_gauleg) or "qags" (batched
    adaptive Gauss-Kronrod panels replacing quadpack QAGS,
    src/integration@proc.f90:338-346). rbeta > 0 integrates the beta
    sphere around the CP separately with a cusp-adapted r = R u^2 map
    and quadratures each ray only over [rbeta, r_IAS] (reference
    beta-sphere split, :383-529).
    """
    from ..ops.lebedev import lebedev

    eval_batch = _field_values(system, expr)
    c = system.crystal
    # Lebedev angular nodes per level (reference INT_LEBEDEV sizes)
    nleb = {1: 74, 2: 194, 3: 302, 4: 590}.get(level, 194)
    sph, wang = lebedev(nleb)
    r_ias = bisect_basin(system, center_frac, sph, rmax=rmax)
    x0 = c.x2c(np.asarray(center_frac))

    rbeta = min(rbeta, float(r_ias.min())) if rbeta > 0 else 0.0
    total = 0.0
    if rbeta > 0:
        # beta sphere: cusp-adapted radial map r = rbeta u^2, full solid
        # angle at once
        xg, wg = np.polynomial.legendre.leggauss(nr)
        u = 0.5 * (xg + 1.0)
        wu = 0.5 * wg
        rr = rbeta * u ** 2
        wr = rbeta * 2.0 * u * wu
        pts = x0[None, None, :] + rr[None, :, None] * sph[:, None, :]
        vals = eval_batch(pts.reshape(-1, 3)).reshape(len(sph), nr)
        total += float(((vals * (rr * rr * wr)[None, :]).sum(axis=1)
                        * wang).sum() * 4.0 * np.pi)

    from ..ops.quadrature import radial_adaptive, radial_gauleg

    if radquad == "qags":
        radial, _, _ = radial_adaptive(eval_batch, x0, sph, rbeta, r_ias,
                                       abserr=abserr, relerr=relerr)
    elif rbeta > 0:
        radial = radial_gauleg(eval_batch, x0, sph, rbeta, r_ias, nr=nr)
    else:
        # cusp-adapted map r = R u^2 down to the nucleus
        xg, wg = np.polynomial.legendre.leggauss(nr)
        u = 0.5 * (xg + 1.0)
        wu = 0.5 * wg
        rr = r_ias[:, None] * u[None, :] ** 2
        wr = r_ias[:, None] * 2.0 * u[None, :] * wu[None, :]
        pts = x0[None, None, :] + rr[:, :, None] * sph[:, None, :]
        vals = eval_batch(pts.reshape(-1, 3)).reshape(len(sph), nr)
        radial = (vals * rr * rr * wr).sum(axis=1)
    total += float((radial * wang).sum() * 4.0 * np.pi)
    return total


def sphere_integral(system, center_frac, radius: float, expr: str = None,
                    deg: int = 29):
    """Integral of the field/expr over a sphere surface x radius^2
    (reference SPHEREINTEGRALS): returns the solid-angle average times
    4 pi r^2."""
    from ..ops.lebedev import lebedev, good_lebedev

    c = system.crystal
    sph, wang = lebedev(good_lebedev((deg + 1) ** 2 // 2))
    x0 = c.x2c(np.asarray(center_frac))
    pts = x0[None, :] + radius * sph
    vals = _field_values(system, expr)(pts)
    return float((vals * wang).sum() * 4.0 * np.pi * radius ** 2)
