"""The Crystal class: host-side structure, frames and periodic images.

Role of the reference's crystalmod (src/crystalmod.f90): cell metrics and
coordinate frames (input-crystallographic / Delaunay-reduced / Cartesian),
atom lists, Wigner-Seitz cell, shortest-vector searches and the
periodic-image environment that feeds promolecular evaluation.

Host code (NumPy), a copy of the JAX package's crystal module: space-group
naming (crystal/spgs.py), Wyckoff letters (crystal/wyckoff.py) and the
nearest-atom lists (scipy's cKDTree) included.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dfield

import numpy as np

from .. import param
from . import cell as cellmod
from .wscell import WignerSeitz, reduced_basis, wigner_seitz


@dataclass
class Species:
    name: str
    z: int


@dataclass
class Crystal:
    """An immutable crystal or molecular structure; atoms are the full
    cell list in fractional coordinates (the reference's `atcel`)."""

    m_x2c: np.ndarray                 # (3,3) columns = lattice vectors (bohr)
    x_frac: np.ndarray                # (ncel, 3) fractional coords
    species_of: np.ndarray            # (ncel,) index into species
    species: list                     # list[Species]
    ismolecule: bool = False
    molx0: np.ndarray | None = None   # molecule origin shift (Cartesian)
    molborder: np.ndarray = dfield(default_factory=lambda: np.zeros(3))

    m_c2x: np.ndarray = dfield(init=False)
    volume: float = dfield(init=False)
    aa: np.ndarray = dfield(init=False)
    bb: np.ndarray = dfield(init=False)

    def __post_init__(self):
        self.m_x2c = np.asarray(self.m_x2c, dtype=float)
        self.x_frac = np.atleast_2d(np.asarray(self.x_frac, dtype=float))
        self.species_of = np.asarray(self.species_of, dtype=int)
        self.m_c2x = np.linalg.inv(self.m_x2c)
        self.volume = cellmod.cell_volume(self.m_x2c)
        self.aa, self.bb = cellmod.cellpar_from_m_x2c(self.m_x2c)
        self._ws = None
        self._mxr = None
        self._sg = None
        self._nstar = None

    @property
    def ncel(self) -> int:
        return len(self.x_frac)

    @property
    def zatoms(self) -> np.ndarray:
        """Atomic number per atom in the cell."""
        zs = np.array([s.z for s in self.species], dtype=int)
        return zs[self.species_of]

    @property
    def x_cart(self) -> np.ndarray:
        return self.x_frac @ self.m_x2c.T

    def x2c(self, x):
        return np.asarray(x, dtype=float) @ self.m_x2c.T

    def c2x(self, c):
        return np.asarray(c, dtype=float) @ self.m_c2x.T

    # ------------------------------------------------------------------
    # Delaunay-reduced frame (shortest-vector searches)
    # ------------------------------------------------------------------
    @property
    def m_xr2x(self) -> np.ndarray:
        """Reduced-crystallographic to input-crystallographic matrix."""
        if self._mxr is None:
            self._mxr = (np.eye(3) if self.ismolecule
                         else reduced_basis(self.m_x2c))
        return self._mxr

    @property
    def m_x2xr(self) -> np.ndarray:
        return np.linalg.inv(self.m_xr2x)

    @property
    def m_xr2c(self) -> np.ndarray:
        return self.m_x2c @ self.m_xr2x

    def shortest_vector(self, dx_frac):
        """Shortest lattice-translated Cartesian vector(s) for fractional
        difference(s) dx (N,3) or (3,): wrap in the Delaunay-reduced frame,
        then check the 27 surrounding reduced-lattice translations."""
        dx = np.atleast_2d(np.asarray(dx_frac, dtype=float))
        if self.ismolecule:
            out = dx @ self.m_x2c.T
            return out if np.asarray(dx_frac).ndim == 2 else out[0]
        xr = dx @ self.m_x2xr.T
        xr -= np.round(xr)
        cand = np.array(
            [[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1)
             for k in (-1, 0, 1)], dtype=float)
        cart = (xr[:, None, :] + cand[None, :, :]) @ self.m_xr2c.T
        d2 = np.einsum("nmk,nmk->nm", cart, cart)
        out = cart[np.arange(len(cart)), np.argmin(d2, axis=1)]
        return out if np.asarray(dx_frac).ndim == 2 else out[0]

    def distance(self, x1_frac, x2_frac):
        """Minimum-image distance(s) between fractional coordinates."""
        d = self.shortest_vector(np.asarray(x1_frac) - np.asarray(x2_frac))
        return np.linalg.norm(d, axis=-1)

    def distmat(self, x1_frac, x2_frac, cutoff: float | None = None):
        """Minimum-image distance matrix (n, m) between two fractional
        coordinate sets (n,3) and (m,3) - the vectorized form of
        `distance` used by batch CP dedup.

        With `cutoff` set, uses a wrap-only fast path (no neighbor-cell
        expansion): exact for distances below half the shortest
        reduced-lattice vector, possible overestimates beyond - correct
        for threshold tests `d < cutoff` with small cutoffs."""
        X = np.atleast_2d(np.asarray(x1_frac, dtype=float))
        Y = np.atleast_2d(np.asarray(x2_frac, dtype=float))
        dx = (X[:, None, :] - Y[None, :, :]).reshape(-1, 3)
        if cutoff is not None and not self.ismolecule:
            xr = dx @ self.m_x2xr.T
            xr -= np.round(xr)
            d = np.linalg.norm(xr @ self.m_xr2c.T, axis=1)
            return d.reshape(len(X), len(Y))
        sv = np.atleast_2d(self.shortest_vector(dx))
        return np.linalg.norm(sv, axis=1).reshape(len(X), len(Y))

    def identify_atom(self, x, icrd=param.ICRD_CRYS, distmax=1e-5):
        """Index (0-based) of the cell atom within distmax of point x, or -1.

        Role of reference identify_atom (src/crystalmod@proc.f90).
        """
        x = np.asarray(x, dtype=float)
        single = x.ndim == 1
        x = np.atleast_2d(x)
        if icrd == param.ICRD_CART:
            x = self.c2x(x)
        if self.ncel == 0:
            res = np.full(len(x), -1)
            return (int(res[0]), np.inf) if single else res
        d = np.stack(
            [self.distance(x, self.x_frac[i][None, :].repeat(len(x), 0))
             for i in range(self.ncel)], axis=1
        )
        nid = np.argmin(d, axis=1)
        dmin = d[np.arange(len(x)), nid]
        nid = np.where(dmin <= distmax, nid, -1)
        if single:
            return int(nid[0]), float(dmin[0])
        return nid, dmin

    # ------------------------------------------------------------------
    # symmetry
    # ------------------------------------------------------------------
    @property
    def spacegroup(self):
        """Lazy space-group symmetry dataset (crystal/symmetry.py).
        Honors `nosym` (P1, reference NOSYMM) and `symprec` attributes
        (reference SYMPREC keyword, src/global.f90)."""
        if self._sg is None:
            from .symmetry import SpaceGroup, find_symmetry

            if getattr(self, "nosym", False):
                nat = self.ncel
                sg = SpaceGroup(rotations=np.eye(3, dtype=int)[None],
                                translations=np.zeros((1, 3)),
                                crystal_system="triclinic")
                sg.nneq = nat
                sg.irr_idx = np.arange(nat)
                sg.orbit_of = np.arange(nat)
                sg.mult = np.ones(nat, dtype=int)
                self._sg = sg
            else:
                self._sg = find_symmetry(
                    self, symprec=getattr(self, "symprec", 1e-5))
        return self._sg

    def spg_name(self):
        """Hermann-Mauguin symbol + ITA number of the detected space
        group, or (None, 0) when the setting is not in the database
        (role of the reference spgs naming, src/spgs.f90:30-32; the
        reference itself never names DETECTED groups)."""
        if getattr(self, "_spgname", None) is None:
            from .spgs import identify_from_ops

            sg = self.spacegroup
            st = identify_from_ops(sg.rotations, sg.translations)
            self._spgname = (st.short, st.ita_number) if st else (None, 0)
        return self._spgname

    def wyckoffs(self, symprec: float = 1e-4):
        """Wyckoff letters of the nonequivalent atoms (spglib
        site-symmetry database; see crystal/wyckoff.py). Returns a list
        aligned with spacegroup.irr_idx, or None when the group/setting
        cannot be resolved."""
        if getattr(self, "_wyck", None) is None:
            from .wyckoff import wyckoff_letters

            _, ita = self.spg_name()
            if not ita:
                self._wyck = (None,)
            else:
                sg = self.spacegroup
                reps = np.asarray(sg.irr_idx)
                letters, _ = wyckoff_letters(
                    sg.rotations, sg.translations,
                    np.asarray(self.x_frac)[reps], ita, self.m_x2c,
                    symprec=symprec)
                self._wyck = (letters,)
        return self._wyck[0]

    @property
    def ws(self) -> WignerSeitz:
        if self._ws is None:
            self._ws = wigner_seitz(self.m_x2c)
        return self._ws

    # ------------------------------------------------------------------
    # periodic-image environment (device-feeding arrays)
    # ------------------------------------------------------------------
    def atomic_environment(self, rmax: float):
        """All atom images within rmax of any point of the unit cell.

        Returns (pos_cart (M,3), spc (M,), cellidx (M,)): a static
        candidate list that the promolecular sum contracts densely."""
        if self.ismolecule:
            return self.x_cart, self.species_of.copy(), np.arange(self.ncel)
        widths = 1.0 / np.linalg.norm(self.m_c2x, axis=1)
        nimg = np.ceil(rmax / widths).astype(int) + 1
        rng = [np.arange(-n, n + 1) for n in nimg]
        shifts = np.stack(np.meshgrid(*rng, indexing="ij"),
                          axis=-1).reshape(-1, 3)
        pos = (self.x_frac[None, :, :] + shifts[:, None, :]).reshape(-1, 3)
        spc = np.tile(self.species_of, len(shifts))
        cidx = np.tile(np.arange(self.ncel), len(shifts))
        cart = pos @ self.m_x2c.T
        # conservative prune: fractional bounding box of the cell + rmax
        fbuf = rmax / widths
        ok = np.all((pos > -fbuf - 1e-9) & (pos < 1.0 + fbuf + 1e-9), axis=1)
        return cart[ok], spc[ok], cidx[ok]

    # ------------------------------------------------------------------
    # covalent connectivity (asterisms)
    # ------------------------------------------------------------------
    def list_near_atoms(self, x, icrd=param.ICRD_CRYS, up2d: float = None,
                        up2n: int = None):
        """Atoms near point(s) x, sorted by distance (role of the
        reference environ list_near_atoms, src/environmod@proc.f90:895,
        with its up2d / up2n cutoff modes). The spatial hash becomes a
        cKDTree over the periodic image environment, cached per radius.

        Returns (eid (list per point), dist, lvec): cell-atom indices,
        distances and integer lattice vectors, nearest first."""
        from scipy.spatial import cKDTree

        x = np.asarray(x, dtype=float)
        single = x.ndim == 1
        x = np.atleast_2d(x)
        if icrd == param.ICRD_CRYS:
            x = self.x2c(x)
        if up2d is None:
            if up2n is None:
                raise ValueError("need up2d or up2n")
            # conservative search radius from the number of atoms asked
            vol_per_atom = self.volume / max(self.ncel, 1)
            up2d_eff = 2.0 * (up2n * vol_per_atom) ** (1.0 / 3.0) + 2.0
        else:
            up2d_eff = up2d
        key = round(float(up2d_eff), 6)
        cache = getattr(self, "_nn_cache", None)
        if cache is None or cache[0] < key:
            pos, spc, cidx = self.atomic_environment(up2d_eff)
            tree = cKDTree(pos)
            self._nn_cache = (key, tree, pos, cidx)
        _, tree, pos, cidx = self._nn_cache
        out_eid, out_d, out_lv = [], [], []
        frac = self.c2x(pos)
        for p in x:
            if up2n is not None:
                d, idx = tree.query(p, k=min(up2n, len(pos)))
                d = np.atleast_1d(d)
                idx = np.atleast_1d(idx)
                if up2d is not None:
                    sel = d <= up2d
                    d, idx = d[sel], idx[sel]
            else:
                idx = np.asarray(sorted(tree.query_ball_point(p, up2d)),
                                 dtype=int)
                d = np.linalg.norm(pos[idx] - p, axis=1)
                order = np.argsort(d)
                d, idx = d[order], idx[order]
            out_eid.append(cidx[idx])
            out_d.append(d)
            out_lv.append(np.rint(frac[idx]
                                  - self.x_frac[cidx[idx]]).astype(int))
        if single:
            return out_eid[0], out_d[0], out_lv[0]
        return out_eid, out_d, out_lv

    # ------------------------------------------------------------------
    # covalent connectivity (asterisms)
    # ------------------------------------------------------------------
    def bonds(self, bondfactor: float = 1.4):
        """Covalent bond list [(i, j, lvec)] using covalent radii, the role
        of find_asterisms_covalent (src/environmod@proc.f90:1334)."""
        if self._nstar is not None:
            return self._nstar
        zs = self.zatoms
        rad = np.array([param.covalent_radius(z) for z in zs])
        rmax = (rad[:, None] + rad[None, :]).max() * bondfactor \
            if len(rad) else 0.0
        pos, spc, cidx = self.atomic_environment(rmax + 1e-6)
        out = []
        cart = self.x_cart
        radspc = np.array([param.covalent_radius(s.z) for s in self.species])
        frac_img = self.c2x(pos)
        for i in range(self.ncel):
            d = np.linalg.norm(pos - cart[i], axis=1)
            cut = (rad[i] + radspc[spc]) * bondfactor
            sel = np.where((d > 1e-6) & (d <= cut))[0]
            for j in sel:
                lvec = np.rint(frac_img[j] - self.x_frac[cidx[j]]).astype(int)
                out.append((i, int(cidx[j]), tuple(lvec)))
        self._nstar = out
        return out

    def __repr__(self):
        kind = "molecule" if self.ismolecule else "crystal"
        return (f"Crystal({kind}, {self.ncel} atoms, "
                f"a={self.aa.round(4)}, angles={self.bb.round(2)})")
