"""Cell transformations: NEWCELL, Niggli/Delaunay reduction, primitive
cell.

Role of the reference newcell/cell_standard/cell_niggli/cell_delaunay
(src/crystalmod.f90:163-167, src/crystalmod@proc.f90): rebuild the
crystal in a different unit cell. Host-side crystallography (NumPy).
"""
from __future__ import annotations

import numpy as np

from .crystal import Crystal


def niggli_reduce(m_x2c: np.ndarray, eps: float = 1e-10,
                  maxiter: int = 10000):
    """Niggli reduction (Krivy & Gruber 1976, with the Grosse-Kunstleve
    2004 stabilization). Returns (m_new, T): m_new = m_x2c @ T, T an
    integer matrix with |det T| = 1."""
    m = np.asarray(m_x2c, float)
    T = np.eye(3, dtype=np.int64)

    def metrics():
        mm = m @ T
        g = mm.T @ mm
        return (g[0, 0], g[1, 1], g[2, 2],
                2 * g[1, 2], 2 * g[0, 2], 2 * g[0, 1])

    scale = np.linalg.norm(m) ** 2
    eps = eps * scale

    for _ in range(maxiter):
        A, B, C, xi, eta, zeta = metrics()

        def cls(v):
            return 1 if v > eps else (-1 if v < -eps else 0)

        # step 1: sort a <= b (single application, fall through)
        if A > B + eps or (abs(A - B) < eps and abs(xi) > abs(eta) + eps):
            T = T @ np.array([[0, -1, 0], [-1, 0, 0], [0, 0, -1]])
            A, B, C, xi, eta, zeta = metrics()
        # step 2: sort b <= c (restart)
        if B > C + eps or (abs(B - C) < eps and abs(eta) > abs(zeta) + eps):
            T = T @ np.array([[-1, 0, 0], [0, 0, -1], [0, -1, 0]])
            continue
        # steps 3/4: canonical sign fix (Krivy-Gruber l,m,n logic)
        l, mm_, n = cls(xi), cls(eta), cls(zeta)
        if l * mm_ * n == 1:
            s = np.array([(-1 if v == -1 else 1) for v in (l, mm_, n)],
                         dtype=np.int64)
            if not (s == 1).all():
                T = T @ np.diag(s)
                A, B, C, xi, eta, zeta = metrics()
        else:
            s = np.ones(3, dtype=np.int64)
            r = -1
            for idx, v in enumerate((l, mm_, n)):
                if v == 1:
                    s[idx] = -1
                elif v == 0:
                    r = idx
            if s.prod() == -1:
                s[r] = -1
            if not (s == 1).all():
                T = T @ np.diag(s)
                A, B, C, xi, eta, zeta = metrics()
        # step 5
        if abs(xi) > B + eps or (abs(xi - B) < eps and 2 * eta < zeta - eps) \
                or (abs(xi + B) < eps and zeta < -eps):
            sg = 1 if xi > 0 else -1
            T = T @ np.array([[1, 0, 0], [0, 1, -sg], [0, 0, 1]])
            continue
        # step 6
        if abs(eta) > A + eps or (abs(eta - A) < eps and 2 * xi < zeta - eps) \
                or (abs(eta + A) < eps and zeta < -eps):
            sg = 1 if eta > 0 else -1
            T = T @ np.array([[1, 0, -sg], [0, 1, 0], [0, 0, 1]])
            continue
        # step 7
        if abs(zeta) > A + eps or (abs(zeta - A) < eps and 2 * xi < eta - eps) \
                or (abs(zeta + A) < eps and eta < -eps):
            sg = 1 if zeta > 0 else -1
            T = T @ np.array([[1, -sg, 0], [0, 1, 0], [0, 0, 1]])
            continue
        # step 8
        if xi + eta + zeta + A + B < -eps or (
                abs(xi + eta + zeta + A + B) < eps
                and 2 * (A + eta) + zeta > eps):
            T = T @ np.array([[1, 0, 1], [0, 1, 1], [0, 0, 1]])
            continue
        break
    else:
        raise RuntimeError("Niggli reduction did not converge")
    out = m @ T
    if np.linalg.det(out) < 0:
        T = -T
        out = m @ T
    return out, T


def newcell(crystal: Crystal, m_frac, origin=None) -> Crystal:
    """Rebuild the crystal in a new cell whose vectors are the columns of
    `m_frac` in the old fractional basis (reference NEWCELL,
    src/crystalmod@proc.f90 newcell). |det| > 1 replicates atoms,
    |det| < 1 requires the smaller cell to be a true sublattice."""
    M = np.asarray(m_frac, float)
    det = np.linalg.det(M)
    if abs(det) < 1e-12:
        raise ValueError("NEWCELL matrix is singular")
    x0 = np.zeros(3) if origin is None else np.asarray(origin, float)
    m_new = np.asarray(crystal.m_x2c) @ M
    Minv = np.linalg.inv(M)

    # enough old-lattice translations to tile the new cell
    corners = np.array([[i, j, k] for i in (0, 1) for j in (0, 1)
                        for k in (0, 1)], float) @ M.T
    lo = np.floor(corners.min(axis=0)).astype(int) - 1
    hi = np.ceil(corners.max(axis=0)).astype(int) + 1
    shifts = np.array([[i, j, k]
                       for i in range(lo[0], hi[0] + 1)
                       for j in range(lo[1], hi[1] + 1)
                       for k in range(lo[2], hi[2] + 1)], float)

    xold = np.asarray(crystal.x_frac) - x0[None, :]
    cand = (xold[:, None, :] + shifts[None, :, :]).reshape(-1, 3) @ Minv.T
    spc = np.repeat(np.asarray(crystal.species_of), len(shifts))
    inside = cand - np.floor(cand)
    # dedupe in the new cell (cartesian metric)
    keep_x, keep_s = [], []
    for xx, ss in zip(inside, spc):
        dup = False
        for yy in keep_x:
            d = xx - yy
            d -= np.rint(d)
            if np.linalg.norm(m_new @ d) < 1e-5:
                dup = True
                break
        if not dup:
            keep_x.append(xx)
            keep_s.append(ss)
    nexp = len(crystal.x_frac) * abs(det)
    if abs(len(keep_x) - nexp) > 0.5:
        raise ValueError(
            f"NEWCELL: got {len(keep_x)} atoms, expected {nexp:g} - the new "
            "cell is not a lattice-compatible transform")
    return Crystal(m_x2c=m_new, x_frac=np.asarray(keep_x),
                   species_of=np.asarray(keep_s, dtype=int),
                   species=list(crystal.species),
                   ismolecule=crystal.ismolecule)


def centering_translations(crystal: Crystal, symprec: float = 1e-5):
    """Pure translations (fractional, nonzero) that map the crystal onto
    itself - the centering vectors of a non-primitive cell."""
    x = np.asarray(crystal.x_frac) % 1.0
    spof = np.asarray(crystal.species_of)
    m = np.asarray(crystal.m_x2c)
    counts = np.bincount(spof)
    rare = int(np.argmin(np.where(counts > 0, counts,
                                  np.iinfo(np.int64).max)))
    i0 = int(np.nonzero(spof == rare)[0][0])
    out = []
    for j in np.nonzero(spof == rare)[0]:
        t = (x[j] - x[i0]) % 1.0
        if np.linalg.norm(m @ (t - np.rint(t))) < 1e-6:
            continue
        ok = True
        for sp in np.unique(spof):
            a = (x[spof == sp] + t) % 1.0
            b = x[spof == sp]
            d = a[:, None, :] - b[None, :, :]
            d -= np.rint(d)
            dc = np.linalg.norm(d @ m.T, axis=-1)
            if not (dc.min(axis=1) < max(symprec * 100, 1e-3)).all():
                ok = False
                break
        if ok:
            out.append(t)
    return np.asarray(out)


def primitive_cell(crystal: Crystal, symprec: float = 1e-5) -> Crystal:
    """Reduce to a primitive cell using the detected centering
    translations (reference NEWCELL PRIMITIVE via spglib standardization,
    src/crystalmod.f90:163-167)."""
    cen = centering_translations(crystal, symprec)
    if len(cen) == 0:
        return crystal
    # candidate primitive vectors: centerings + unit vectors; choose 3
    # shortest independent ones whose cell volume = V / (ncen+1)
    cand = np.vstack([cen, np.eye(3)])
    m = np.asarray(crystal.m_x2c)
    lens = np.linalg.norm(cand @ m.T, axis=1)
    order = np.argsort(lens)
    target = 1.0 / (len(cen) + 1)
    best = None
    n = len(cand)
    for i in range(n):
        for j in range(i + 1, n):
            for k in range(j + 1, n):
                M = cand[order[[i, j, k]]].T
                d = abs(np.linalg.det(M))
                if abs(d - target) < 1e-8:
                    best = M
                    break
            if best is not None:
                break
        if best is not None:
            break
    if best is None:
        raise RuntimeError("could not build a primitive cell")
    out = newcell(crystal, best)
    mred, T = niggli_reduce(out.m_x2c)
    return newcell(out, T)
