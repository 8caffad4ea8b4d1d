"""Closed-form symmetric 3x3 eigen-decomposition, batched on the device.

Replaces the reference's LAPACK calls in hot loops (eig/eigns and the
LINPACK dgeco/dgedi Hessian inverse of the Newton search,
src/fieldmod@proc.f90:1860, src/tools_math@proc.f90 eig/rsindex): a batch
of millions of matrices needs a branch-free closed form, not a library
call per matrix.

Eigenvalues via the trigonometric solution of the characteristic cubic
(stable for symmetric matrices); eigenvectors via cross products of
shifted rows; inverse via the adjugate.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["eigvalsh3", "eigh3", "inv3", "det3", "rsindex",
           "det3s", "solve3s", "eigvalsh3s", "sym6_rotation", "linmap"]

SYM6 = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))


def linmap(A, v):
    """Apply a small host-constant matrix A (m, k) to batched rows v (k, ...)
    as unrolled scalar multiply-adds, skipping zero entries."""
    A = np.asarray(A)
    rows = []
    for i in range(A.shape[0]):
        acc = None
        for j in range(A.shape[1]):
            a = float(A[i, j])
            if a == 0.0:
                continue
            term = a * v[j]
            acc = term if acc is None else acc + term
        rows.append(acc if acc is not None else torch.zeros_like(v[0]))
    return torch.stack(rows)


def det3(m):
    """Determinant of (..., 3, 3)."""
    return (
        m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
        - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
        + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0])
    )


def inv3(m):
    """Inverse of (..., 3, 3) via the adjugate (batched, branch-free)."""
    a = m[..., 0, 0]; b = m[..., 0, 1]; c = m[..., 0, 2]
    d = m[..., 1, 0]; e = m[..., 1, 1]; f = m[..., 1, 2]
    g = m[..., 2, 0]; h = m[..., 2, 1]; i = m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F_ = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d
    det = a * A + b * B + c * C
    adj = torch.stack(
        [
            torch.stack([A, D, G], dim=-1),
            torch.stack([B, E, H], dim=-1),
            torch.stack([C, F_, I], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


def det3s(h6):
    """Determinant of symmetric matrices in SYM6 component form (6, N)."""
    xx, yy, zz, xy, xz, yz = h6
    return (xx * (yy * zz - yz * yz) - xy * (xy * zz - yz * xz)
            + xz * (xy * yz - yy * xz))


def solve3s(h6, g):
    """Solve H x = g for symmetric H in SYM6 form.

    h6: (6, N); g: (3, N). Returns (x (3, N), det (N,)) via the adjugate -
    the batch-last replacement for the reference's dgeco/dgedi Newton
    solve (src/fieldmod@proc.f90:1860-1861). Caller divides/masks on det.
    """
    xx, yy, zz, xy, xz, yz = h6
    A = yy * zz - yz * yz
    B = -(xy * zz - yz * xz)
    C = xy * yz - yy * xz
    E = xx * zz - xz * xz
    F_ = -(xx * yz - xy * xz)
    I = xx * yy - xy * xy
    det = xx * A + xy * B + xz * C
    x0 = A * g[0] + B * g[1] + C * g[2]
    x1 = B * g[0] + E * g[1] + F_ * g[2]
    x2 = C * g[0] + F_ * g[1] + I * g[2]
    return torch.stack([x0, x1, x2]), det


def _eig_closed_form(a, b, c, d, e, f):
    """Ascending eigenvalues (lo, mid, hi) of [[a,d,f],[d,b,e],[f,e,c]]
    (Smith's trigonometric solution; exact-degeneracy safe)."""
    q = (a + b + c) / 3.0
    da, db, dc = a - q, b - q, c - q
    p2 = da * da + db * db + dc * dc + 2.0 * (d * d + e * e + f * f)
    p = torch.sqrt(p2 / 6.0)
    pos = p > 0
    safe_p = torch.where(pos, p, torch.ones_like(p))
    # normalize ELEMENTS by p before the determinant: dividing det by p^3
    # at the end underflows to 0/0 = NaN for near-isotropic matrices
    # (p ~ 1e-18 in f32 makes p^3 flush to zero)
    na, nb, nc = da / safe_p, db / safe_p, dc / safe_p
    nd, ne, nf = d / safe_p, e / safe_p, f / safe_p
    r = (na * (nb * nc - ne * ne) - nd * (nd * nc - ne * nf)
         + nf * (nd * ne - nb * nf)) / 2.0
    r = torch.clamp(r, -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    return (torch.where(pos, e3, q), torch.where(pos, e2, q),
            torch.where(pos, e1, q))


def eigvalsh3s(h6):
    """Eigenvalues (3, N) ascending of symmetric matrices in SYM6 form
    (xx, yy, zz, xy, xz, yz), batch-last."""
    xx, yy, zz, xy, xz, yz = h6
    return torch.stack(_eig_closed_form(xx, yy, zz, xy, yz, xz))


def sym6_rotation(M):
    """(6, 6) matrix R with (M^T H M) in SYM6 form = R @ h6.

    Host-side constant: precomputes the congruence-transform action on
    symmetric components so the fractional->Cartesian Hessian rotation
    (reference src/fieldmod@proc.f90:739-741) is one small linear map
    against a (6, N) batch.
    """
    M = np.asarray(M, dtype=float)
    R = np.zeros((6, 6))
    for col, (k, l) in enumerate(SYM6):
        E = np.zeros((3, 3))
        E[k, l] = 1.0
        E[l, k] = 1.0
        out = M.T @ E @ M
        for row, (i, j) in enumerate(SYM6):
            R[row, col] = out[i, j]
    return R


def eigvalsh3(m):
    """Eigenvalues of symmetric (..., 3, 3), ascending, closed form."""
    return torch.stack(_eig_closed_form(
        m[..., 0, 0], m[..., 1, 1], m[..., 2, 2],
        m[..., 0, 1], m[..., 1, 2], m[..., 0, 2]), dim=-1)


def _unit(v, i):
    """Unit vector e_i shaped like v (..., 3)."""
    out = torch.zeros_like(v)
    out[..., i] = 1.0
    return out


def eigh3(m):
    """Eigenvalues (ascending) and eigenvectors of symmetric (..., 3, 3).

    Eigenvectors via cross products of rows of (m - lambda I); falls back
    between row pairs by magnitude for robustness near degeneracies.
    Returns (w (...,3), v (...,3,3)) with v[..., :, k] the k-th vector.
    """
    w = eigvalsh3(m)
    eye = torch.eye(3, dtype=m.dtype, device=m.device)

    def safe(n):
        return torch.where(n > 0, n, torch.ones_like(n))

    def vec(lam):
        mm = m - lam[..., None, None] * eye
        r0 = mm[..., 0, :]
        r1 = mm[..., 1, :]
        r2 = mm[..., 2, :]
        c01 = torch.linalg.cross(r0, r1)
        c02 = torch.linalg.cross(r0, r2)
        c12 = torch.linalg.cross(r1, r2)
        n01 = (c01 * c01).sum(-1)
        n02 = (c02 * c02).sum(-1)
        n12 = (c12 * c12).sum(-1)
        best = torch.argmax(torch.stack([n01, n02, n12], dim=-1), dim=-1)
        cand = torch.stack([c01, c02, c12], dim=-2)
        idx = best[..., None, None].expand(best.shape + (1, 3))
        v = torch.gather(cand, -2, idx)[..., 0, :]
        nrm = torch.sqrt((v * v).sum(-1, keepdim=True))
        # degenerate direction: any unit vector orthogonal works; pick x-hat
        return torch.where(nrm > 1e-30, v / safe(nrm), _unit(v, 0))

    v0 = vec(w[..., 0])
    v2 = vec(w[..., 2])
    # degeneracies can make v2 parallel to v0 (e.g. a multiple of the
    # identity); Gram-Schmidt against v0 with an orthogonal fallback keeps
    # the basis orthonormal and still satisfies the eigen-equation inside
    # the degenerate subspace.
    v2 = v2 - (v2 * v0).sum(-1, keepdim=True) * v0
    n2 = torch.sqrt((v2 * v2).sum(-1, keepdim=True))
    pick = torch.argmin(v0.abs(), dim=-1)
    e = F.one_hot(pick, 3).to(m.dtype)
    alt = torch.linalg.cross(v0, e)
    alt = alt / torch.sqrt((alt * alt).sum(-1, keepdim=True))
    v2 = torch.where(n2 > 1e-12, v2 / safe(n2), alt)
    # middle vector: orthogonal completion keeps the basis orthonormal even
    # for (near-)degenerate pairs
    v1 = torch.linalg.cross(v2, v0)
    n1 = torch.sqrt((v1 * v1).sum(-1, keepdim=True))
    v1 = torch.where(n1 > 1e-30, v1 / safe(n1), _unit(v1, 1))
    v = torch.stack([v0, v1, v2], dim=-1)
    return w, v


def rsindex(hess, eps: float = 1e-12):
    """Rank and signature of symmetric Hessian(s) (reference rsindex,
    src/tools_math@proc.f90:871): r = #(|eig|>eps), s = #pos - #neg.

    Returns (eigs, r, s)."""
    w = eigvalsh3(hess)
    npos = (w > eps).sum(dim=-1)
    nneg = (w < -eps).sum(dim=-1)
    return w, npos + nneg, npos - nneg
