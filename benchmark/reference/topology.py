"""Plain reference of the topology of a periodic grid density: critical
points (CPs) and the ends of bond and ring paths (critic2 AUTO and
makegraph, src/autocp@proc.f90), on critic2's tricubic interpolant.

- The interpolant: the tensor product of Catmull-Rom cubics through the
  grid values (critic2's Lekien-Marsden cell with central-difference
  corner derivatives), its gradient and Hessian in Cartesian
  coordinates, from the 4 x 4 x 4 nodes around a point.
- The search: Newton steps x <- x - H^-1 g from a regular lattice of
  seeds and the midpoints of near atom pairs; converged points are
  classified by the signs of the Hessian's eigenvalues and merged into
  orbits under the crystal's symmetry operations. Maxima within a grid
  spacing of an atom are that atom's nucleus.
- The paths: from each bond CP, 0.01 bohr either way along the Hessian's
  positive eigenvector, uphill along the normalised gradient by fourth-
  order Runge-Kutta steps to within 0.1 bohr of a maximum; from each
  ring CP, along the negative eigenvector downhill to a cage CP.
"""
from __future__ import annotations

import numpy as np
import torch

CHANGE = 1e-2          # bohr: a path's first step off its CP
RTERM = 0.1            # bohr: a path ends this near its target
STEP = 0.02            # bohr: one Runge-Kutta step
MAX_STEPS = 4000
NEWTON_ITERS = 60
# a Newton point has converged where |g| < GTOL_EPS * eps(dtype) * max rho
GTOL_EPS = 1e4
SEEDS_PER_AXIS = 12


def _weights(t):
    """Catmull-Rom weights over nodes -1..2 and their first and second
    derivatives, t: (...,) in [0, 1)."""
    t2, t3 = t * t, t * t * t
    w = torch.stack([0.5 * (-t3 + 2 * t2 - t), 0.5 * (3 * t3 - 5 * t2 + 2),
                     0.5 * (-3 * t3 + 4 * t2 + t), 0.5 * (t3 - t2)], -1)
    d = torch.stack([0.5 * (-3 * t2 + 4 * t - 1), 0.5 * (9 * t2 - 10 * t),
                     0.5 * (-9 * t2 + 8 * t + 1), 0.5 * (3 * t2 - 2 * t)], -1)
    s = torch.stack([0.5 * (-6 * t + 4), 0.5 * (18 * t - 10),
                     0.5 * (-18 * t + 8), 0.5 * (6 * t - 2)], -1)
    return w, d, s


class Interpolant:
    """critic2's tricubic interpolant of a periodic grid, in `dtype`."""

    def __init__(self, rho, lattice_bohr, dtype=torch.float64):
        self.f = rho.to(dtype)
        self.dt = dtype
        self.n = torch.tensor(rho.shape, device=rho.device)
        a = np.asarray(lattice_bohr, dtype=float)
        self.x2c = torch.as_tensor(a, dtype=dtype, device=rho.device)
        self.c2x = torch.as_tensor(np.linalg.inv(a), dtype=dtype,
                                   device=rho.device)

    def eval(self, xc):
        """(value (B,), Cartesian gradient (B, 3), Hessian (B, 3, 3)) at
        Cartesian points xc (B, 3)."""
        xf = xc.to(self.dt) @ self.c2x.T
        u = (xf - torch.floor(xf)) * self.n.to(self.dt)
        base = torch.floor(u)
        t = u - base
        w, d, s = _weights(t)                          # (B, 3, 4)
        off = torch.arange(-1, 3, device=xc.device)
        idx = (base.long()[:, :, None] + off) % self.n[None, :, None]
        n2, n3 = int(self.n[1]), int(self.n[2])
        flat = (idx[:, 0, :, None, None] * (n2 * n3)
                + idx[:, 1, None, :, None] * n3 + idx[:, 2, None, None, :])
        c = self.f.reshape(-1)[flat]                   # (B, 4, 4, 4)
        nn = self.n.to(self.dt)

        def contract(a0, a1, a2):
            return torch.einsum("bijk,bi,bj,bk->b", c, a0[:, 0], a1[:, 1],
                                a2[:, 2])

        val = contract(w, w, w)
        gf = torch.stack([contract(d, w, w), contract(w, d, w),
                          contract(w, w, d)], 1) * nn
        hf = torch.empty((len(xc), 3, 3), dtype=self.dt, device=xc.device)
        hf[:, 0, 0] = contract(s, w, w)
        hf[:, 1, 1] = contract(w, s, w)
        hf[:, 2, 2] = contract(w, w, s)
        hf[:, 0, 1] = hf[:, 1, 0] = contract(d, d, w)
        hf[:, 0, 2] = hf[:, 2, 0] = contract(d, w, d)
        hf[:, 1, 2] = hf[:, 2, 1] = contract(w, d, d)
        hf = hf * nn[None, :, None] * nn[None, None, :]
        # fractional -> Cartesian: g = C^T g_f, H = C^T H_f C (C = c2x)
        g = gf @ self.c2x
        h = self.c2x.T @ hf @ self.c2x
        return val, g, h


def signature(h):
    """Sum of the signs of the Hessian's eigenvalues: -3, -1, 1 or 3."""
    ev = torch.linalg.eigvalsh(h.double())
    return torch.sign(ev).sum(-1).long()


def images(x, rot, tr):
    """(ops, 3) fractional images of x, wrapped into [0, 1)."""
    y = np.einsum("oij,j->oi", rot, x) + tr
    return y - np.floor(y)


def frac_dist(lattice, x, ys):
    """Minimum-image Cartesian distances from x (3,) to ys (M, 3)."""
    d = ys - x[None, :]
    d -= np.rint(d)
    return np.linalg.norm(d @ lattice.T, axis=1)


class Orbits:
    """CP orbits under the crystal's operations: one representative, its
    type and its multiplicity in the cell."""

    def __init__(self, lattice, rot, tr, tol):
        self.lattice, self.rot, self.tr, self.tol = lattice, rot, tr, tol
        self.rep, self.typ, self.mult, self._img, self._owner = \
            [], [], [], np.zeros((0, 3)), np.zeros(0, dtype=int)

    def find(self, x, r=None) -> int:
        """The orbit with an image within r (default: tol) of fractional
        x, or -1."""
        if not len(self._img):
            return -1
        d = frac_dist(self.lattice, x, self._img)
        i = int(np.argmin(d))
        return int(self._owner[i]) if d[i] < (r or self.tol) else -1

    def gap(self, x, k) -> float:
        """Distance from fractional x to the nearest image of orbit k."""
        return float(frac_dist(self.lattice, x,
                               self._img[self._owner == k]).min())

    def add(self, x, typ) -> int:
        k = self.find(x)
        if k >= 0:
            return k
        img = images(x, self.rot, self.tr)
        # distinct images: the multiplicity
        keep = []
        for y in img:
            if all(frac_dist(self.lattice, y, np.array([z]))[0] >= self.tol
                   for z in keep):
                keep.append(y)
        k = len(self.rep)
        self.rep.append(np.asarray(x))
        self.typ.append(int(typ))
        self.mult.append(len(keep))
        self._img = np.concatenate([self._img, np.array(keep)])
        self._owner = np.concatenate([self._owner,
                                      np.full(len(keep), k)])
        return k


def _seeds(cfg):
    """A regular lattice of fractional seeds and the midpoints of atom
    pairs closer than 8 bohr."""
    st = cfg["structure"]
    a = np.asarray(st["lattice_bohr"], dtype=float)
    g = (np.arange(SEEDS_PER_AXIS) + 0.5) / SEEDS_PER_AXIS
    lat = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    x = np.asarray(st["x_frac"], dtype=float)
    mids = []
    for i in range(len(x)):
        d = x - x[i]
        d -= np.rint(d)
        close = np.linalg.norm(d @ a.T, axis=1) < 8.0
        close[i] = False
        mids.append(x[i] + 0.5 * d[close])
    return np.concatenate([lat] + mids) % 1.0


def search(interp, cfg):
    """Newton from the seeds; returns the converged Cartesian points."""
    a = np.asarray(cfg["structure"]["lattice_bohr"], dtype=float)
    x = torch.as_tensor(_seeds(cfg) @ a.T, dtype=interp.dt,
                        device=interp.f.device)
    scale = float(interp.f.abs().max())
    for _ in range(NEWTON_ITERS):
        _, g, h = interp.eval(x)
        step, info = torch.linalg.solve_ex(h, g.unsqueeze(-1))
        step = torch.where((info == 0)[:, None], step.squeeze(-1), 0.0)
        # at most half a bohr a step
        ns = torch.linalg.norm(step, dim=1, keepdim=True)
        x = x - step * torch.clamp(0.5 / torch.clamp(ns, min=1e-300),
                                   max=1.0)
    _, g, _ = interp.eval(x)
    tol = GTOL_EPS * torch.finfo(interp.dt).eps * scale
    ok = torch.linalg.norm(g.double(), dim=1) < tol
    return x[ok].double().cpu().numpy()


def cps(rho, cfg, dtype=torch.float64) -> dict:
    """The CP orbits of the density: representatives (fractional), types,
    multiplicities, nucleus flags, the atom each nucleus sits on, and each
    bond and ring CP's two path ends as orbit indices."""
    st = cfg["structure"]
    a = np.asarray(st["lattice_bohr"], dtype=float)
    rot = np.asarray(st["symmetry"]["rotations"], dtype=float)
    tr = np.asarray(st["symmetry"]["translations"], dtype=float)
    h = float(max(np.linalg.norm(a[:, i]) / rho.shape[i] for i in range(3)))
    interp = Interpolant(rho, a, dtype)
    xa = np.asarray(st["x_frac"], dtype=float)
    orb = Orbits(a, rot, tr, tol=1e-2)
    nucleus = {}
    for i, x in enumerate(xa):          # nuclei first, one orbit per atom
        k = orb.add(x, -3)
        nucleus.setdefault(k, i)
    pts = search(interp, cfg)
    if len(pts):
        _, _, hh = interp.eval(torch.as_tensor(pts, dtype=dtype,
                                               device=rho.device))
        sig = signature(hh).cpu().numpy()
        for p, s in zip(pts, sig):
            xf = np.linalg.solve(a, p) % 1.0
            if s == -3 and frac_dist(a, xf, xa).min() < 2.0 * h:
                continue                # the nucleus itself
            orb.add(xf, s)
    ends = _paths(interp, orb, a, dtype)
    return {"x": np.array(orb.rep), "typ": np.array(orb.typ),
            "mult": np.array(orb.mult),
            "isnuc": np.array([k in nucleus for k in range(len(orb.rep))]),
            "ends": ends, "orbits": orb}


def _paths(interp, orb, a, dtype):
    """{orbit index: sorted pair of end orbits} for every bond and ring
    CP; an end that reaches no target within MAX_STEPS reads -1."""
    dev = interp.f.device
    starts, owner = [], []
    for k, (x, t) in enumerate(zip(orb.rep, orb.typ)):
        if t not in (-1, 1):
            continue
        _, _, h = interp.eval(torch.as_tensor((x @ a.T)[None], dtype=dtype,
                                              device=dev))
        ev, vec = torch.linalg.eigh(h.double()[0])
        v = (vec[:, 2] if t == -1 else vec[:, 0]).cpu().numpy()
        for sgn in (1.0, -1.0):
            starts.append(x @ a.T + sgn * CHANGE * v)
            owner.append(k)
    if not starts:
        return {}
    up = np.array([1.0 if orb.typ[k] == -1 else -1.0 for k in owner])
    target_typ = np.where(up > 0, -3, 3)
    xs = torch.as_tensor(np.array(starts), dtype=dtype, device=dev)
    upt = torch.as_tensor(up, dtype=dtype, device=dev)[:, None]

    def vel(p):
        _, g, _ = interp.eval(p)
        return upt * g / torch.clamp(torch.linalg.norm(g, dim=1,
                                                       keepdim=True),
                                     min=1e-300)

    end = np.full(len(starts), -1)
    alive = np.ones(len(starts), dtype=bool)
    for _ in range(MAX_STEPS):
        k1 = vel(xs)
        k2 = vel(xs + 0.5 * STEP * k1)
        k3 = vel(xs + 0.5 * STEP * k2)
        k4 = vel(xs + STEP * k3)
        xs = xs + STEP / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        xf = np.linalg.solve(a, xs.double().cpu().numpy().T).T % 1.0
        for j in np.nonzero(alive)[0]:
            k = orb.find(xf[j], RTERM)
            if k >= 0 and orb.typ[k] == target_typ[j]:
                end[j] = k
                alive[j] = False
        if not alive.any():
            break
    out = {}
    for j in range(0, len(owner), 2):
        out[owner[j]] = tuple(sorted((int(end[j]), int(end[j + 1]))))
    return out
