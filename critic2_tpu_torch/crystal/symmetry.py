"""Space-group symmetry detection (spglib-equivalent core, pure host).

Role of the reference's vendored spglib (src/spglib/, 26 kLoC C) as used
through spglib_wrap (src/crystalmod@proc.f90:2992): find the crystal's
symmetry operations {W|t}, classify the crystal system, reduce atoms to
Wyckoff orbits (nneq sites + multiplicities), and provide site symmetry
for CP classification (reference sitesymm; CP dedup/multiplicity in
fieldmod addcp, src/fieldmod@proc.f90:1876-2016).

Algorithm (standard, independent of spglib's implementation):
1. lattice point group: all integer matrices W (entries -1..1) with
   W^T G W = G within tolerance on the (reduced) metric G;
2. space-group ops: for each W, candidate translations t = x_j - W x_0
   over atoms j of the rarest species; {W|t} kept if it permutes the
   whole atom set (species-preserving) within symprec;
3. orbits/multiplicities by transitive closure of the op action.

Cold host code by design - symmetry is O(atoms^2 x 48), never hot.
"""
from __future__ import annotations

from dataclasses import dataclass
from itertools import product

import numpy as np

__all__ = ["SpaceGroup", "find_symmetry", "lattice_point_group"]


def lattice_point_group(m_x2c, eps: float = 1e-5):
    """Integer rotations W with W^T G W = G (fractional basis)."""
    m = np.asarray(m_x2c)
    G = m.T @ m
    scale = np.linalg.norm(G)
    ops = []
    cols = [np.array(v) for v in product((-1, 0, 1), repeat=3)]
    # enumerate W column by column with early metric pruning
    for c1 in cols:
        if abs(c1 @ G @ c1 - G[0, 0]) > eps * scale:
            continue
        for c2 in cols:
            if abs(c2 @ G @ c2 - G[1, 1]) > eps * scale:
                continue
            if abs(c1 @ G @ c2 - G[0, 1]) > eps * scale:
                continue
            for c3 in cols:
                if abs(c3 @ G @ c3 - G[2, 2]) > eps * scale:
                    continue
                if abs(c1 @ G @ c3 - G[0, 2]) > eps * scale:
                    continue
                if abs(c2 @ G @ c3 - G[1, 2]) > eps * scale:
                    continue
                W = np.stack([c1, c2, c3], axis=1)
                if abs(abs(np.linalg.det(W)) - 1.0) < 1e-9:
                    ops.append(W)
    return ops


@dataclass
class SpaceGroup:
    rotations: np.ndarray        # (nop, 3, 3) int, fractional basis
    translations: np.ndarray     # (nop, 3) fractional
    crystal_system: str = ""
    nneq: int = 0
    irr_idx: np.ndarray = None   # (nneq,) representative cell-atom index
    orbit_of: np.ndarray = None  # (ncel,) orbit id per cell atom
    mult: np.ndarray = None      # (nneq,) orbit sizes

    @property
    def nops(self):
        return len(self.rotations)

    def site_symmetry_order(self, x_frac, symprec: float = 1e-5):
        """Number of ops leaving the fractional point invariant."""
        n = 0
        for W, t in zip(self.rotations, self.translations):
            d = W @ x_frac + t - x_frac
            d -= np.rint(d)
            if np.linalg.norm(d) < 10 * symprec:
                n += 1
        return n

    def orbit(self, x_frac, symprec: float = 1e-4):
        """Distinct images of a fractional point under all ops."""
        out = []
        for W, t in zip(self.rotations, self.translations):
            y = (W @ x_frac + t) % 1.0
            if not any(np.linalg.norm(np.rint(y - o) - (y - o)) < symprec
                       or np.linalg.norm(((y - o) - np.rint(y - o)))
                       < symprec for o in out):
                out.append(y)
        return np.asarray(out)

    def orbit_ops(self, x_frac, symprec: float = 1e-4):
        """(images (k,3), opidx (k,)) — like orbit(), but also the index
        of the first operation generating each distinct image (reference
        cpcel()%ir bookkeeping, src/autocp@proc.f90:1589-1594)."""
        out, ops = [], []
        for i, (W, t) in enumerate(zip(self.rotations, self.translations)):
            y = (W @ x_frac + t) % 1.0
            if not any(np.linalg.norm(((y - o) - np.rint(y - o)))
                       < symprec for o in out):
                out.append(y)
                ops.append(i)
        return np.asarray(out), np.asarray(ops, dtype=int)


def _crystal_system(nrot: int, rotations) -> str:
    """Crystal system from the point-group order and rotation types."""
    # count proper rotation orders
    orders = {1: 0, 2: 0, 3: 0, 4: 0, 6: 0}
    for W in rotations:
        det = round(np.linalg.det(W))
        tr = round(np.trace(W))
        key = {(1, 3): 1, (1, -1): 2, (1, 0): 3, (1, 1): 4, (1, 2): 6}.get(
            (det, tr))
        if key:
            orders[key] += 1
    if orders[6] > 0:
        return "hexagonal"
    if orders[3] >= 8:
        return "cubic"
    if orders[3] > 0:
        return "trigonal"
    if orders[4] > 0:
        return "tetragonal"
    if orders[2] >= 3:
        return "orthorhombic"
    if orders[2] == 1:
        return "monoclinic"
    return "triclinic"


def find_symmetry(crystal, symprec: float = 1e-5) -> SpaceGroup:
    """Detect the space-group operations of the crystal."""
    c = crystal
    x = np.asarray(c.x_frac) % 1.0
    spof = np.asarray(c.species_of)
    nat = len(x)
    if c.ismolecule or nat == 0:
        sg = SpaceGroup(rotations=np.eye(3, dtype=int)[None],
                        translations=np.zeros((1, 3)),
                        crystal_system="molecule")
        sg.nneq = nat
        sg.irr_idx = np.arange(nat)
        sg.orbit_of = np.arange(nat)
        sg.mult = np.ones(nat, dtype=int)
        return sg

    # detect the lattice point group in the Delaunay-reduced frame:
    # for a reduced basis every op has entries in -1..1, which the
    # column enumeration assumes; skewed input cells are handled by
    # transforming the reduced-frame ops back (T unimodular, so the
    # conjugated ops are exactly integer).
    T = np.asarray(c.m_xr2x)
    Tr = np.rint(T).astype(int)
    if not np.allclose(T, Tr, atol=1e-9):
        Ws = lattice_point_group(c.m_x2c, eps=100 * symprec)
    else:
        Tinv = np.rint(np.linalg.inv(T)).astype(int)
        Ws_r = lattice_point_group(np.asarray(c.m_xr2c),
                                   eps=100 * symprec)
        Ws = []
        seen = set()
        for Wr in Ws_r:
            W = Tr @ Wr @ Tinv
            key = W.tobytes()
            if key not in seen:
                seen.add(key)
                Ws.append(W)

    # reference species: the rarest
    counts = np.bincount(spof)
    rare = int(np.argmin(np.where(counts > 0, counts,
                                  np.iinfo(np.int64).max)))
    i0 = int(np.nonzero(spof == rare)[0][0])

    m = np.asarray(c.m_x2c)
    # min-image distances through the reduced frame: the naive
    # rint-wrap underestimates images only for reduced bases; skewed
    # input cells need the reduced-frame candidates
    m_x2xr = np.asarray(c.m_x2xr)
    m_xr2c = np.asarray(c.m_xr2c)
    _cand = np.array([[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1)
                      for k in (-1, 0, 1)], dtype=float)

    def _min_image_norm(d_frac):
        """(..., 3) fractional differences -> min-image Cartesian norms."""
        sh = d_frac.shape[:-1]
        xr = d_frac.reshape(-1, 3) @ m_x2xr.T
        xr -= np.round(xr)
        cart = (xr[:, None, :] + _cand[None, :, :]) @ m_xr2c.T
        return np.sqrt(np.einsum("nmk,nmk->nm", cart, cart)
                       .min(axis=1)).reshape(sh)

    def matches(W, t):
        y = (x @ W.T + t) % 1.0
        # each transformed atom must coincide with an atom of the same
        # species (within symprec, cartesian)
        for sp in np.unique(spof):
            a = y[spof == sp]
            b = x[spof == sp]
            dc = _min_image_norm(a[:, None, :] - b[None, :, :])
            if not (dc.min(axis=1) < max(symprec * 100, 1e-3)).all():
                return False
        return True

    rots, trans = [], []
    for W in Ws:
        for j in np.nonzero(spof == rare)[0]:
            t = (x[j] - W @ x[i0]) % 1.0
            if matches(W, t):
                t = np.where(np.abs(t - np.rint(t)) < 1e-8, 0.0, t)
                # snap to common fractions
                for den in (2, 3, 4, 6):
                    frac = t * den
                    t = np.where(np.abs(frac - np.rint(frac)) < 1e-6,
                                 np.rint(frac) / den, t)
                # dedupe
                dup = any((np.array_equal(W, Wp) and
                           np.linalg.norm((t - tp) - np.rint(t - tp))
                           < 1e-6) for Wp, tp in zip(rots, trans))
                if not dup:
                    rots.append(W)
                    trans.append(t)
                break   # one translation per W suffices for the group...

    # ...except for centered lattices described in conventional cells:
    # retry remaining (W, t) candidates to catch centering translations
    for W in Ws:
        for j in np.nonzero(spof == rare)[0]:
            t = (x[j] - W @ x[i0]) % 1.0
            dup = any((np.array_equal(W, Wp) and
                       np.linalg.norm((t - tp) - np.rint(t - tp)) < 1e-6)
                      for Wp, tp in zip(rots, trans))
            if dup:
                continue
            if matches(W, t):
                for den in (2, 3, 4, 6):
                    frac = t * den
                    t = np.where(np.abs(frac - np.rint(frac)) < 1e-6,
                                 np.rint(frac) / den, t)
                rots.append(W)
                trans.append(t)

    rot = np.asarray(rots, dtype=int)
    tra = np.asarray(trans)

    # orbits
    orbit_of = np.full(nat, -1, dtype=int)
    reps = []
    for i in range(nat):
        if orbit_of[i] >= 0:
            continue
        oid = len(reps)
        reps.append(i)
        for W, t in zip(rot, tra):
            y = (W @ x[i] + t) % 1.0
            dc = _min_image_norm(x - y[None, :])
            hit = np.nonzero((dc < max(symprec * 100, 1e-3))
                             & (spof == spof[i]))[0]
            for h in hit:
                orbit_of[h] = oid
    mult = np.bincount(orbit_of)

    sg = SpaceGroup(rotations=rot, translations=tra,
                    crystal_system=_crystal_system(len(rot), rot),
                    nneq=len(reps), irr_idx=np.asarray(reps),
                    orbit_of=orbit_of, mult=mult)
    return sg
