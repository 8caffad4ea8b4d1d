"""Fragments (atom subsets with lattice translations) and molecule
identification from covalent connectivity.

Role of the reference fragmentmod (src/fragmentmod.f90: fragment type
with merge/append) and crystalmod's listmolecules
(src/crystalmod@proc.f90, built on the covalent asterisms): walk the
bond graph with periodic image vectors, collect each connected
component as a fragment whose atoms carry the lattice translation that
makes the molecule whole, and report whether the full crystal is a
molecular crystal (no component connects to its own translate)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["Fragment", "list_molecules", "listatoms_sphcub",
           "listatoms_cells", "complete_molmotif"]


@dataclass
class Fragment:
    """A set of (cell atom, lattice vector) sites of a crystal."""

    crystal: object
    at_idx: np.ndarray           # (n,) cell-atom indices
    lvec: np.ndarray             # (n, 3) integer lattice translations
    discrete: bool = True        # False if it connects to its translate

    @property
    def n(self):
        return len(self.at_idx)

    @property
    def x_frac(self):
        return np.asarray(self.crystal.x_frac)[self.at_idx] + self.lvec

    @property
    def x_cart(self):
        return self.x_frac @ np.asarray(self.crystal.m_x2c).T

    @property
    def z(self):
        zs = np.asarray(self.crystal.zatoms)
        return zs[self.at_idx]

    def centroid_cart(self):
        return self.x_cart.mean(axis=0)

    def append(self, other: "Fragment") -> "Fragment":
        """Concatenate two fragments, dropping duplicate sites
        (reference fragment merge/append, src/fragmentmod.f90)."""
        keys = {(int(a), tuple(int(v) for v in l))
                for a, l in zip(self.at_idx, self.lvec)}
        idx = list(self.at_idx)
        lv = list(map(tuple, self.lvec))
        for a, l in zip(other.at_idx, other.lvec):
            k = (int(a), tuple(int(v) for v in l))
            if k not in keys:
                keys.add(k)
                idx.append(int(a))
                lv.append(k[1])
        return Fragment(crystal=self.crystal,
                        at_idx=np.asarray(idx, dtype=int),
                        lvec=np.asarray(lv, dtype=int),
                        discrete=self.discrete and other.discrete)

    @classmethod
    def merge(cls, frags) -> "Fragment":
        out = frags[0]
        for f in frags[1:]:
            out = out.append(f)
        return out


def listatoms_sphcub(crystal, rsph: float | None = None, xsph=(0, 0, 0),
                     rcub: float | None = None,
                     xcub=(0, 0, 0)) -> Fragment:
    """All periodic-image atoms inside a sphere of radius rsph (bohr)
    or a cube of half-side rcub centered at the fractional point
    xsph/xcub (reference listatoms_sphcub,
    src/crystalmod@proc.f90:1033-1096; the reference grows lattice
    shells until empty — here the needed shell range is bounded by the
    covering radius and the filter is one vectorized pass)."""
    if (rsph is None) == (rcub is None):
        raise ValueError("need exactly one of rsph or rcub")
    r = rsph if rsph is not None else float(rcub) * np.sqrt(3.0)
    m = np.asarray(crystal.m_x2c, dtype=float)
    x0 = np.asarray(xsph if rsph is not None else xcub, dtype=float)
    # lattice range: |n_i| <= r / d_i + 1 with d_i the interplanar
    # spacing of the i-th lattice direction (rows of inv(m) are the
    # reciprocal vectors / 2pi)
    rinv = np.linalg.inv(m)
    nmax = np.ceil(r * np.linalg.norm(rinv, axis=1)).astype(int) + 1
    rng = [np.arange(-nn, nn + 1) for nn in nmax]
    lv = np.stack(np.meshgrid(*rng, indexing="ij"), axis=-1).reshape(-1, 3)
    xf = np.asarray(crystal.x_frac, dtype=float)          # (nat, 3)
    # (nlv, nat, 3) fractional offsets from the center
    xall = xf[None, :, :] + lv[:, None, :].astype(float) - x0
    cart = xall @ m.T
    if rsph is not None:
        keep = np.einsum("lad,lad->la", cart, cart) < rsph * rsph
    else:
        keep = np.all(np.abs(cart) <= rcub, axis=-1)
    il, ia = np.nonzero(keep)
    return Fragment(crystal=crystal, at_idx=ia.astype(int),
                    lvec=lv[il].astype(int))


def listatoms_cells(crystal, ix=(1, 1, 1), doborder: bool = False) -> Fragment:
    """All atoms of an ix supercell, plus (doborder) atoms of
    neighboring cells within 0.01 fractional of the supercell faces
    (reference listatoms_cells, src/crystalmod@proc.f90:975-1031)."""
    rthr = 0.01
    xf = np.asarray(crystal.x_frac, dtype=float)
    nat = len(xf)
    idx, lvs = [], []
    for i in range(ix[0]):
        for j in range(ix[1]):
            for k in range(ix[2]):
                idx.append(np.arange(nat))
                lvs.append(np.tile([i, j, k], (nat, 1)))
    if doborder:
        for i in range(-1, ix[0] + 1):
            for j in range(-1, ix[1] + 1):
                for k in range(-1, ix[2] + 1):
                    if 0 <= i < ix[0] and 0 <= j < ix[1] and 0 <= k < ix[2]:
                        continue
                    skip = np.zeros(nat, dtype=bool)
                    for d, v in enumerate((i, j, k)):
                        if v == -1:
                            skip |= xf[:, d] < 1 - rthr
                        elif v == ix[d]:
                            skip |= xf[:, d] > rthr
                    sel = np.nonzero(~skip)[0]
                    if len(sel):
                        idx.append(sel)
                        lvs.append(np.tile([i, j, k], (len(sel), 1)))
    return Fragment(crystal=crystal,
                    at_idx=np.concatenate(idx).astype(int),
                    lvec=np.concatenate(lvs).astype(int))


def complete_molmotif(crystal, frag: Fragment) -> Fragment:
    """Extend an atom selection so every touched molecule is whole
    (reference MOLMOTIF: listmolecules over the fragment + merge,
    src/crystalmod@proc.f90:3720-3723)."""
    frags, _ = list_molecules(crystal)
    mol_of = {}
    for fr in frags:
        for a, lv in zip(fr.at_idx, fr.lvec):
            mol_of[int(a)] = (fr, np.asarray(lv, dtype=int))
    keys = set()
    for a, lv in zip(frag.at_idx, frag.lvec):
        fr, lm = mol_of[int(a)]
        base = np.asarray(lv, dtype=int) - lm
        for a2, lv2 in zip(fr.at_idx, fr.lvec):
            keys.add((int(a2), tuple(base + np.asarray(lv2, dtype=int))))
    items = sorted(keys)
    return Fragment(crystal=crystal,
                    at_idx=np.asarray([a for a, _ in items], dtype=int),
                    lvec=np.asarray([l for _, l in items], dtype=int))


def list_molecules(crystal, bondfactor: float = 1.4):
    """Connected molecular fragments of a crystal (reference
    listmolecules / fill_molecular_fragments). Returns
    (fragments, ismolecular): each fragment's lvec places its atoms so
    the molecule is geometrically whole; `discrete` is False for
    components that bond to their own periodic translate (polymeric /
    framework directions), and ismolecular is True only when every
    component is discrete."""
    n = crystal.ncel
    adj = [[] for _ in range(n)]
    for i, j, lvec in crystal.bonds(bondfactor):
        adj[i].append((j, np.asarray(lvec, dtype=int)))

    assigned = np.full(n, -1, dtype=int)
    frags = []
    for start in range(n):
        if assigned[start] >= 0:
            continue
        comp = {start: np.zeros(3, dtype=int)}
        stack = [start]
        discrete = True
        while stack:
            a = stack.pop()
            la = comp[a]
            for b, lv in adj[a]:
                lb = la + lv
                if b in comp:
                    if not np.array_equal(comp[b], lb):
                        # bonds back to its own translate: periodic chain
                        discrete = False
                else:
                    comp[b] = lb
                    stack.append(b)
        idx = np.asarray(sorted(comp), dtype=int)
        lv = np.asarray([comp[i] for i in idx], dtype=int)
        for i in idx:
            assigned[i] = len(frags)
        frags.append(Fragment(crystal=crystal, at_idx=idx, lvec=lv,
                              discrete=discrete))
    ismolecular = all(f.discrete for f in frags) and len(frags) > 0
    return frags, ismolecular
