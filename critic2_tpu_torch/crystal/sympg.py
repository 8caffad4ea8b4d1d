"""Molecular / site point-group detection and Schoenflies naming.

Role of the reference sympg module (`sym3d`, src/sympg.f90:26-44, from
tessel): find the point-group operations of a finite atom set and name
the group. The reference accumulates candidate operations from pair
alignments and classifies by operation counts; here the same two
stages are (a) a vectorized candidate-axis search (inertia axes, atom
directions, pair bisectors) with batched verification against the
species-labelled point cloud, and (b) a standard Schoenflies flowchart
on the found operations.
"""
from __future__ import annotations

import numpy as np

__all__ = ["point_ops", "schoenflies", "molecular_point_group"]

_MAXORDER = 8


def _verify(ops, pos, spec, eps):
    """Keep ops (k, 3, 3) that permute the labelled point cloud."""
    if not len(ops):
        return np.zeros((0, 3, 3))
    ops = np.asarray(ops)
    moved = np.einsum("kij,nj->kni", ops, pos)          # (k, n, 3)
    d = np.linalg.norm(moved[:, :, None, :] - pos[None, None, :, :],
                       axis=-1)                          # (k, n, n)
    same = spec[None, :, None] == spec[None, None, :]
    ok_pairs = (d < eps) & same
    ok = ok_pairs.any(-1).all(-1)
    return ops[ok]


def _uniq_axes(axes, eps=1e-4):
    out = []
    for a in axes:
        n = np.linalg.norm(a)
        if n < 1e-8:
            continue
        a = a / n
        if a[np.abs(a).argmax()] < 0:
            a = -a
        if not any(np.linalg.norm(a - b) < eps for b in out):
            out.append(a)
    return out


def _rot(axis, angle):
    a = axis / np.linalg.norm(axis)
    c, s = np.cos(angle), np.sin(angle)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return c * np.eye(3) + s * K + (1 - c) * np.outer(a, a)


def _mirror(normal):
    n = normal / np.linalg.norm(normal)
    return np.eye(3) - 2.0 * np.outer(n, n)


def point_ops(coords, spec, eps: float = 1e-3):
    """All orthogonal ops mapping the labelled point set onto itself.

    coords (n, 3) are centered internally at the species-weighted
    centroid (the reference centers at the barycenter too). Returns
    (k, 3, 3) including the identity."""
    pos = np.asarray(coords, dtype=float)
    spec = np.asarray(spec)
    pos = pos - pos.mean(axis=0)
    scale = max(np.linalg.norm(pos, axis=1).max(), 1e-10)
    eps_abs = eps * max(scale, 1.0) * 10

    # candidate axes: inertia eigenvectors, atom directions, same-species
    # pair bisectors and pair differences (reference pair-alignment scan)
    I = np.einsum("ni,nj->ij", pos, pos)
    _, evec = np.linalg.eigh(I)
    cands = [evec[:, i] for i in range(3)]
    cands += [p for p in pos]
    nsmall = len(pos)
    if nsmall <= 24:
        for i in range(nsmall):
            for j in range(i + 1, nsmall):
                if spec[i] != spec[j]:
                    continue
                cands.append(pos[i] + pos[j])
                cands.append(pos[i] - pos[j])
                cands.append(np.cross(pos[i], pos[j]))
    if nsmall <= 12:
        # triple sums reach the body-diagonal C3 axes of octahedral
        # coordination (e.g. the (1,1,1) axes of SF6)
        for i in range(nsmall):
            for j in range(i + 1, nsmall):
                for k in range(j + 1, nsmall):
                    if spec[i] == spec[j] == spec[k]:
                        cands.append(pos[i] + pos[j] + pos[k])
    axes = _uniq_axes(cands)

    found = [np.eye(3), -np.eye(3)]
    for ax in axes:
        m = _mirror(ax)
        for n in range(2, _MAXORDER + 1):
            for k in range(1, n):
                R = _rot(ax, 2 * np.pi * k / n)
                found.append(R)
                found.append(m @ R)            # S_n powers about the axis
        found.append(m)
    ops = _verify(found, pos, spec, eps_abs)
    # dedupe with a tolerance matched to the (approximate) geometry:
    # near-identical ops from imperfect coordinates must collapse
    keep = []
    for o in ops:
        if not any(np.abs(o - k).max() < 1e-3 for k in keep):
            keep.append(o)
    return np.stack(keep)


def _axis_of(R):
    """Rotation axis of a proper rotation (or normal of an improper)."""
    M = R if np.linalg.det(R) > 0 else -R
    w, v = np.linalg.eig(M)
    i = np.argmin(np.abs(w - 1.0))
    a = np.real(v[:, i])
    return a / np.linalg.norm(a)


def _order_of(R):
    """Smallest n with R^n = +-I tending to the rotation order."""
    det = np.linalg.det(R)
    M = R if det > 0 else -R
    tr = np.clip((np.trace(M) - 1.0) / 2.0, -1, 1)
    ang = np.arccos(tr)
    if ang < 1e-6:
        return 1 if det > 0 else 2        # E / sigma-or-i handled apart
    n = int(round(2 * np.pi / ang))
    return max(n, 2)


def schoenflies(ops, eps: float = 1e-5) -> str:
    """Schoenflies symbol of a finite orthogonal group (k, 3, 3)."""
    ops = np.asarray(ops)
    k = len(ops)
    dets = np.linalg.det(ops)
    has_i = any(np.abs(o + np.eye(3)).max() < 1e-5 for o in ops)
    proper = [o for o in ops if np.linalg.det(o) > 0
              and np.abs(o - np.eye(3)).max() > 1e-5]
    mirrors = [o for o in ops if np.linalg.det(o) < 0
               and abs(np.trace(o) - 1.0) < 1e-5]
    impropers = [o for o in ops if np.linalg.det(o) < 0
                 and abs(np.trace(o) - 1.0) > 1e-5
                 and np.abs(o + np.eye(3)).max() > 1e-5]

    orders = [_order_of(o) for o in proper]
    if not proper:
        if has_i:
            return "Ci"
        return "Cs" if mirrors else "C1"

    nmax = max(orders)
    c2_axes = _uniq_axes([_axis_of(o) for o, n in zip(proper, orders)
                          if n == 2])
    c3_axes = _uniq_axes([_axis_of(o) for o, n in zip(proper, orders)
                          if n == 3])
    c5_axes = _uniq_axes([_axis_of(o) for o, n in zip(proper, orders)
                          if n == 5])

    # icosahedral / cubic families
    if len(c5_axes) >= 2:
        return "Ih" if has_i else "I"
    if len(c3_axes) >= 4:
        c4 = any(n == 4 for n in orders)
        if c4:
            return "Oh" if has_i else "O"
        if has_i:
            return "Th"
        return "Td" if (mirrors or impropers) else "T"

    # axial families: principal axis = highest order
    paxis = _axis_of(proper[int(np.argmax(orders))])
    n = nmax
    perp_c2 = sum(1 for a in c2_axes
                  if abs(np.dot(a, paxis)) < 1e-4)
    sigma_h = any(abs(abs(np.dot(_axis_of(m), paxis)) - 1.0) < 1e-4
                  for m in mirrors)
    sigma_v = sum(1 for m in mirrors
                  if abs(np.dot(_axis_of(m), paxis)) < 1e-4)
    if perp_c2 >= n and n > 1:
        if sigma_h:
            return f"D{n}h"
        if sigma_v >= n or impropers:
            return f"D{n}d"
        return f"D{n}"
    if sigma_h:
        return f"C{n}h"
    if sigma_v >= n:
        return f"C{n}v"
    # S2n groups: improper rotation of order 2n about the principal axis
    for o in impropers:
        M = -o if np.linalg.det(o) < 0 else o
        tr = np.clip((np.trace(M) - 1.0) / 2.0, -1, 1)
        ang = np.arccos(tr)
        if ang > 1e-6 and abs(2 * np.pi / ang - 2 * n) < 1e-3 and \
                abs(abs(np.dot(_axis_of(o), paxis)) - 1.0) < 1e-4:
            return f"S{2 * n}"
    return f"C{n}"


def molecular_point_group(coords, spec, eps: float = 1e-3):
    """(symbol, ops) of a molecule (reference sym3d driver role).
    Linear molecules are reported as Coov / Dooh."""
    pos = np.asarray(coords, dtype=float)
    pos = pos - pos.mean(axis=0)
    if len(pos) == 1:
        return "Kh", np.eye(3)[None]
    # linear?
    _, s, _ = np.linalg.svd(pos)
    if s[1] < eps * max(s[0], 1.0):
        spec = np.asarray(spec)
        inv_ok = len(_verify([-np.eye(3)], pos, spec,
                             eps * max(s[0], 1.0) * 10)) == 1
        return ("Dooh" if inv_ok else "Coov"), None
    ops = point_ops(pos, spec, eps)
    return schoenflies(ops), ops
