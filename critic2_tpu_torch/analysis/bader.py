"""Bader grid basin assignment (Henkelman ongrid/neargrid) on the device.

Role of the reference bader (src/bader@proc.f90:81-463, Comput. Mater.
Sci. 36, 254): assign every grid point to the basin of the attractor its
steepest-ascent path reaches, walking trajectories point by point.

Reformulation (as in the JAX package): the ongrid ascent defines a static
successor function succ(i) = neighbor maximizing (rho_nbr - rho_i)/|dr|
(attractors map to themselves), i.e. a forest over the grid. Path
following becomes POINTER DOUBLING: succ^(2t) = succ^t o succ^t, so
log2(longest path) dense gather passes resolve every trajectory at once.

Two methods: `ongrid` approximates the reference's refine_edge
(src/bader@proc.f90:236-358) with iterative edge reassignment;
`neargrid` (the reference default) runs the exact correction-vector
walks, batched over the grid points. The walks run in blocks of
`walk_block` points, and walkers that have arrived leave the working set
after every segment of steps: each walk is independent of all others, so
the assignment does not depend on the blocking.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .yt import _as_grid

__all__ = ["bader_integrate", "BaderResult"]

WALK_SEGMENT = 16          # near-grid steps between two reads of `done`


def _neighbor_offsets26():
    offs = [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
            for k in (-1, 0, 1) if (i, j, k) != (0, 0, 0)]
    return np.asarray(offs, dtype=np.int64)


def _neighbor_flat(idx, offs, shape):
    """Flat indices (K, B) of the K offset neighbours of flat points idx."""
    n1, n2, n3 = shape
    x1 = idx // (n2 * n3)
    r = idx - x1 * (n2 * n3)
    x2 = r // n3
    x3 = r - x2 * n3
    o1 = torch.remainder(x1[None, :] + offs[:, 0:1], n1)
    o2 = torch.remainder(x2[None, :] + offs[:, 1:2], n2)
    o3 = torch.remainder(x3[None, :] + offs[:, 2:3], n3)
    return o1 * (n2 * n3) + o2 * n3 + o3


@dataclass
class BaderResult:
    crystal: object
    shape: tuple
    nattr: int
    xattr: np.ndarray            # (nattr, 3) fractional attractor positions
    iattr: np.ndarray            # (nattr,) flat grid index per attractor
    labels_d: torch.Tensor       # (n1,n2,n3) int64 basin per point, device
    _labels: np.ndarray = None

    @property
    def labels(self) -> np.ndarray:
        """(n1,n2,n3) int32 basin per point, on the host (lazy copy)."""
        if self._labels is None:
            self._labels = self.labels_d.cpu().numpy().astype(np.int32)
        return self._labels

    def integrate(self, field_flat) -> np.ndarray:
        """Basin sums of one integrand (N,) or a stack (nprops, N). The
        sums are index_add_ reductions: on CUDA the order of the additions
        is not fixed, so two runs agree to rounding, not bitwise."""
        lab = self.labels_d.reshape(-1)
        f = torch.as_tensor(field_flat, device=lab.device)
        single = f.numel() == lab.numel()
        f2 = f.reshape(1 if single else f.shape[0], -1)
        out = torch.zeros((f2.shape[0], self.nattr), dtype=f2.dtype,
                          device=lab.device)
        out.index_add_(1, lab, f2)
        q = out.cpu().numpy()
        return q[0] if single else q

    def basin_support(self, a: int, tol: float = 1e-15):
        """(flat indices, unit weights) of basin `a` (argmax labels)."""
        idx = torch.nonzero(self.labels_d.reshape(-1) == a)[:, 0]
        idx = idx.cpu().numpy()
        return idx, np.ones(idx.size)


def _val_pbc(f_flat, shape, p):
    """f at integer points p (..., 3) with pbc."""
    n1, n2, n3 = shape
    return f_flat[torch.remainder(p[..., 0], n1) * (n2 * n3)
                  + torch.remainder(p[..., 1], n2) * n3
                  + torch.remainder(p[..., 2], n3)]


def _ongrid_step(f_flat, shape, offs, invd, p):
    nbr = p[:, None, :] + offs[None, :, :]             # (B, 26, 3)
    meas = (_val_pbc(f_flat, shape, nbr)
            - _val_pbc(f_flat, shape, p)[:, None]) * invd[None, :]
    best, k = meas.max(dim=1)
    pm = torch.gather(nbr, 1, k[:, None, None].expand(-1, 1, 3))[:, 0]
    return torch.where((best > 0.0)[:, None], pm, p)


def _neargrid_step(state, f_flat, G, offs, invd, shape):
    p, dr, prev, done = state
    e = torch.eye(3, dtype=torch.int64, device=p.device)
    nshape = torch.tensor(shape, dtype=torch.int64, device=p.device)
    f0 = _val_pbc(f_flat, shape, p)
    fp = torch.stack([_val_pbc(f_flat, shape, p + e[d])
                      for d in range(3)], -1)
    fm = torch.stack([_val_pbc(f_flat, shape, p - e[d])
                      for d in range(3)], -1)
    glat = 0.5 * (fp - fm)
    glat = torch.where((fp < f0[:, None]) & (fm < f0[:, None]),
                       torch.zeros_like(glat), glat)
    # gdir = glat @ G.T as three products summed in a fixed order, so the
    # rint below sees the same rounding on every device
    gdir = torch.stack([glat[:, 0] * G[i][0] + glat[:, 1] * G[i][1]
                        + glat[:, 2] * G[i][2] for i in range(3)], -1)
    gmax = gdir.abs().max(dim=1).values
    flat = gmax < 1e-30

    nbr_any = (_val_pbc(f_flat, shape, p[:, None, :] + offs[None, :, :])
               > f0[:, None]).any(-1)
    ismax26 = ~nbr_any          # reference is_max (26 neighbors)

    g = gdir / torch.clamp(gmax, min=1e-300)[:, None]
    rg = torch.round(g)
    pm_g = p + rg.to(torch.int64)
    dr_g = dr + g - rg
    rdr = torch.round(dr_g)
    pm_g = pm_g + rdr.to(torch.int64)
    dr_g = dr_g - rdr

    pm_o = _ongrid_step(f_flat, shape, offs, invd, p)

    use_o = flat & ~ismax26
    pm = torch.where(use_o[:, None], pm_o, pm_g)
    zero = torch.zeros_like(dr_g)
    drn = torch.where((flat | use_o)[:, None], zero, dr_g)
    # cycle guard: revisiting the previous point -> ongrid + reset
    cyc = (torch.remainder(pm, nshape)
           == torch.remainder(prev, nshape)).all(-1) & ~done
    pm = torch.where(cyc[:, None], pm_o, pm)
    drn = torch.where(cyc[:, None], zero, drn)

    newdone = done | (flat & ismax26) | (pm == p).all(-1)
    pm = torch.where(newdone[:, None], p, pm)
    drn = torch.where(newdone[:, None], zero, drn)
    return pm, drn, p, newdone


def _lattice_metric(crystal, shape):
    """(lat2car (3,3), 26 neighbour offsets, their Cartesian lengths)."""
    lat2car = np.asarray(crystal.m_x2c) @ np.diag(
        1.0 / np.asarray(shape, dtype=float))
    offs_np = _neighbor_offsets26()
    dists = np.linalg.norm(offs_np @ lat2car.T, axis=1)
    return lat2car, offs_np, dists


def _neargrid_roots(crystal, rho, maxiter: int | None = None,
                    walk_block: int = 1 << 21):
    """Exact near-grid ascent (reference max_neargrid/step_neargrid,
    src/bader@proc.f90:363-431): every grid point walks uphill with the
    accumulated correction vector dr until it sits on a local maximum.

    The reference walks trajectories sequentially and shortcuts into
    already-assigned points (then patches the damage with refine_edge,
    :236-358). Here every point's walk is independent and batched, which
    removes the scan-order dependence, so no edge refinement is needed;
    the result is the assignment every trajectory would give in
    isolation. A two-step cycle guard falls back to the on-grid step with
    dr reset, mirroring the reference's known-point fallback (:422-427).

    Returns the flat attractor index of every grid point, (N,) int64 on
    the device of rho."""
    shape = tuple(int(s) for s in rho.shape)
    n1, n2, n3 = shape
    N = n1 * n2 * n3
    dev = rho.device
    f_flat = rho.reshape(-1)
    lat2car, offs_np, dists = _lattice_metric(crystal, shape)
    car2lat = np.linalg.inv(lat2car)
    # direct-coordinate gradient operator: res = C (C^T g_lat) with
    # C = car2lat (reference rho_grad_dir :468-503)
    G = (car2lat @ car2lat.T).tolist()
    offs = torch.as_tensor(offs_np, device=dev)
    invd = torch.as_tensor(1.0 / dists, dtype=rho.dtype, device=dev)
    if maxiter is None:
        maxiter = 4 * max(shape) + 64

    def flat_of(p):
        return (torch.remainder(p[:, 0], n1) * (n2 * n3)
                + torch.remainder(p[:, 1], n2) * n3
                + torch.remainder(p[:, 2], n3))

    roots = torch.empty(N, dtype=torch.int64, device=dev)
    for lo in range(0, N, walk_block):
        order = torch.arange(lo, min(N, lo + walk_block), device=dev)
        p = torch.stack([order // (n2 * n3), (order // n3) % n2,
                         order % n3], -1)
        state = (p, torch.zeros(p.shape, dtype=rho.dtype, device=dev),
                 p - 1, torch.zeros(len(order), dtype=torch.bool,
                                    device=dev))
        it = 0
        while it < maxiter and len(order):
            for _ in range(WALK_SEGMENT):
                state = _neargrid_step(state, f_flat, G, offs, invd, shape)
            it += WALK_SEGMENT
            done = state[3]
            if bool(done.any()):          # arrived walkers leave the set
                roots[order[done]] = flat_of(state[0][done])
                live = ~done
                order = order[live]
                state = tuple(v[live] for v in state)
        if len(order):
            roots[order] = flat_of(state[0])
    return roots


def _succ_block(idx, rho_flat, offs, invd, shape):
    N = rho_flat.shape[0]
    nbr = _neighbor_flat(idx, offs, shape)            # (K, B)
    grad = (rho_flat[nbr] - rho_flat[idx][None, :]) * invd[:, None]
    best, kbest = grad.max(dim=0)
    s = torch.gather(nbr, 0, kbest[None, :])[0]
    # exact plateaus (best == 0, e.g. zero-clamped vacuum): route to
    # the lowest-flat-index equal-rho neighbor below idx so a plateau
    # collapses to one representative instead of N self-mapped
    # attractors (reference walks plateaus to a single maximum,
    # src/bader@proc.f90)
    plat = torch.where((grad == 0.0) & (nbr < idx[None, :]),
                       nbr, torch.full_like(nbr, N))
    pmin = plat.min(dim=0).values
    s_plat = torch.where(pmin < N, pmin, idx)
    return torch.where(best > 0.0, s,
                       torch.where(best == 0.0, s_plat, idx))


def _refine_pass(labels, rho_flat, offs, invd, shape, block):
    """One edge-refinement pass: every point takes the label its steepest
    uphill neighbour has in the current labeling."""
    out = torch.empty_like(labels)
    N = rho_flat.shape[0]
    for lo in range(0, N, block):
        idx = torch.arange(lo, min(N, lo + block), device=labels.device)
        nbr = _neighbor_flat(idx, offs, shape)
        grad = (rho_flat[nbr] - rho_flat[idx][None, :]) * invd[:, None]
        best, kbest = grad.max(dim=0)
        s = torch.gather(nbr, 0, kbest[None, :])[0]
        out[idx] = torch.where(best > 0.0, labels[s], labels[idx])
    return out


def bader_integrate(crystal, rho, block: int = 1 << 18,
                    refine_iters: int = 4, method: str = "ongrid",
                    device=None):
    """Bader assignment: `ongrid` (pointer doubling + edge refinement)
    or `neargrid` (exact batched correction-vector walks).

    rho: (n1,n2,n3) tensor (it keeps its device unless `device` is given)
    or array (moved to `device`, cuda by default). Returns BaderResult.
    """
    rho = _as_grid(rho, device)
    if method == "neargrid":
        return _bader_from_roots(crystal, rho, _neargrid_roots(crystal, rho))
    if method != "ongrid":
        raise ValueError(f"unknown bader method {method}")
    shape = tuple(int(s) for s in rho.shape)
    N = int(np.prod(shape))
    dev = rho.device
    _, offs_np, dists = _lattice_metric(crystal, shape)
    offs = torch.as_tensor(offs_np, device=dev)
    invd = torch.as_tensor(1.0 / dists, dtype=rho.dtype, device=dev)

    rho_flat = rho.reshape(-1)
    root = torch.empty(N, dtype=torch.int64, device=dev)
    for lo in range(0, N, block):
        idx = torch.arange(lo, min(N, lo + block), device=dev)
        root[idx] = _succ_block(idx, rho_flat, offs, invd, shape)

    # pointer doubling to the attractor roots
    for _ in range(int(np.ceil(np.log2(max(N, 2)))) + 1):
        root = root[root]

    res = _bader_from_roots(crystal, rho, root)
    # edge refinement: recompute succ labels from the *current* labeling;
    # an edge point takes the label of its steepest uphill neighbor
    labels = res.labels_d.reshape(-1)
    for _ in range(refine_iters):
        new = _refine_pass(labels, rho_flat, offs, invd, shape, block)
        if torch.equal(new, labels):
            break
        labels = new
    res.labels_d = labels.reshape(shape)
    return res


def _bader_from_roots(crystal, rho, root_flat):
    """Build a BaderResult from per-point attractor flat indices (device
    tensor): torch.unique sorts, so basin b is the b-th lowest flat
    attractor index."""
    shape = tuple(int(s) for s in rho.shape)
    roots, labels = torch.unique(root_flat, return_inverse=True)
    i_at = roots.cpu().numpy()
    x1, x2, x3 = np.unravel_index(i_at, shape)
    xattr = np.stack([x1 / shape[0], x2 / shape[1], x3 / shape[2]], axis=1)
    return BaderResult(crystal=crystal, shape=shape, nattr=len(i_at),
                       xattr=xattr, iattr=i_at,
                       labels_d=labels.reshape(shape))
