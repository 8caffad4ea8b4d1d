"""Localization/delocalization indices from Wannier functions.

Role of the reference intgrid_deloc_wannier + calc_sij_wannier
(src/integration@proc.f90:1183-1640, 1679-1879): atomic overlap matrices
S^A_ij = int_A w_i*(r) w_j(r) dr over Bader/YT basins for the full set of
lattice-translated (optionally U-rotated) occupied Wannier/Bloch
functions, then Fa(A,B,R) = sum_ij Re[ S^A_ji S^B_{T_R i, T_R j} ], from
which LI(A) = fspin |Fa(A,A,0)| and DI(A,B+R) = 2 fspin |Fa(A,B,R)|
(int_output_deloc_wannier, src/integration@proc.f90:2047-2093).

Device formulation (vs the reference's per-band scratch-file loops with
masked whole-grid sums):
- all Wannier images on the home cell come from one (nlat, nks) phase
  matrix times the Bloch stack (fields/qe.py); the whole stack W
  (nlat*nb, Npts) complex128 stays on the device,
- each basin's overlap block is ONE matrix product
  M = (W[:, pts] * w) @ W[:, pts]^T over the basin's support points,
- basin pieces that belong to a lattice-translated attractor image are
  folded back by an index permutation (the reference's packidx shifts,
  src/integration@proc.f90:2512-2526), accumulated with one index_put_,
- Fa is a permuted-trace einsum batched over attractor pairs per lattice
  vector.
The basin supports come one attractor at a time from the decomposition
(for YT, one forward solve each, through the CUDA kernels on a card).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..config import resolve_device


def _pack_perm(nk, nb, shift):
    """Permutation q with q[b + nb*ilat(R)] = b + nb*ilat(R - shift).

    ilat enumerates R in C-order over (k1,k2,k3) (QEData.rvectors); this
    is the reference packidx/unpackidx pair (integration@proc.f90:2492-2526)
    with the modulo-nk lattice translation."""
    nk = np.asarray(nk, dtype=np.int64)
    r = QE_rvectors(nk)                                          # (nlat,3)
    rs = (r - np.asarray(shift, dtype=np.int64)[None, :]) % nk[None, :]
    ilat_s = rs[:, 2] + nk[2] * (rs[:, 1] + nk[1] * rs[:, 0])
    q = (np.arange(nb)[None, :] + nb * ilat_s[:, None]).reshape(-1)
    return q  # length nlat*nb


def _attractor_shifts(crystal, shape, xattr, support_idx, attr_of_pt):
    """Lattice shift p (per support point) of the nearest attractor image:
    p = nint(x - c2x(shortest(x))), x = grid_frac - xattr[A]
    (reference remapping, src/integration@proc.f90:1374-1438)."""
    n = np.asarray(shape, dtype=np.int64)
    i1 = support_idx // (n[1] * n[2])
    rr = support_idx - i1 * (n[1] * n[2])
    i2 = rr // n[2]
    i3 = rr - i2 * n[2]
    xg = np.stack([i1 / n[0], i2 / n[1], i3 / n[2]], axis=1)
    x = xg - xattr[attr_of_pt]
    xs = crystal.shortest_vector(x)                       # (N,3) cartesian
    m_c2x = np.linalg.inv(np.asarray(crystal.m_x2c))
    p = np.rint(x - xs @ m_c2x.T).astype(np.int64)
    return p


@dataclass
class DelocResult:
    nspin: int
    fspin: float
    nk: np.ndarray                 # (3,)
    nbndw: np.ndarray              # (nspin,)
    sij: list                      # per spin: (nattr, nmo, nmo) complex
    fa: np.ndarray                 # (nspin, nattr, nattr, nlat)
    xattr: np.ndarray              # (nattr, 3) raw attractor fractions
    rvec: np.ndarray               # (nlat, 3)

    @property
    def nattr(self):
        return self.fa.shape[1]

    @property
    def nlat(self):
        return self.fa.shape[3]

    def li(self):
        """Localization indices per attractor (R = 0 diagonal)."""
        r0 = int(np.where((self.rvec == 0).all(axis=1))[0][0])
        return self.fspin * np.abs(self.fa[:, :, :, r0]).sum(0).diagonal()

    def population(self):
        """Basin electron populations from the Fa sum rule."""
        return self.fspin * np.abs(self.fa).sum(axis=(0, 3)).sum(axis=1)

    def di(self, a: int, b: int, r=None):
        """Delocalization index between attractor a and image b+R."""
        if r is None:
            ir = slice(None)
        else:
            ir = int(np.where((self.rvec == np.asarray(r)).all(axis=1))[0][0])
        return 2.0 * self.fspin * np.abs(self.fa[:, a, b, ir]).sum(0)

    def aggregate(self, attr_map, nrows: int) -> "DelocResult":
        """Sum Fa blocks of raw attractors merged into the same output row
        (IntegrationResult.attr_map)."""
        amap = np.asarray(attr_map)
        fa = np.zeros((self.nspin, nrows, nrows, self.nlat))
        for a in range(self.fa.shape[1]):
            if amap[a] < 0:      # DISCARDed attractor
                continue
            for b in range(self.fa.shape[2]):
                if amap[b] >= 0:
                    fa[:, amap[a], amap[b], :] += self.fa[:, a, b, :]
        xat = np.zeros((nrows, 3))
        for a in range(self.fa.shape[1]):
            if amap[a] >= 0:
                xat[amap[a]] = self.xattr[a]
        return DelocResult(nspin=self.nspin, fspin=self.fspin, nk=self.nk,
                           nbndw=self.nbndw, sij=[], fa=fa, xattr=xat,
                           rvec=self.rvec)

    def table(self, names=None) -> str:
        li = self.li()
        pop = self.population()
        out = ["# LI/DI from Wannier overlaps (fa sum rule populations)",
               "# at   name        LI              N"]
        for a in range(self.nattr):
            nm = names[a] if names else "--"
            out.append(f"{a + 1:4d}  {nm:<8s} {li[a]:14.8f} {pop[a]:14.8f}")
        out.append("# DI pairs (a, b, R): 2*fspin*|Fa|")
        for a in range(self.nattr):
            for b in range(a, self.nattr):
                for k in range(self.nlat):
                    d = float(2.0 * self.fspin
                              * np.abs(self.fa[:, a, b, k]).sum(0))
                    if d > 1e-6 and not (a == b and (self.rvec[k] == 0).all()):
                        r = self.rvec[k]
                        out.append(f"  {a + 1:3d} {b + 1:3d}  "
                                   f"({r[0]:2d},{r[1]:2d},{r[2]:2d})  {d:12.8f}")
        return "\n".join(out)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def deloc_wannier(crystal, decomp, qe, useu: bool = True,
                  wancut: float | None = None, *, device=None,
                  stats: dict | None = None) -> DelocResult:
    """Compute Sij/Fa/LI/DI on a basin decomposition (`yt_integrate` /
    `bader_integrate` result) using QE states `qe` (fields/qe.QEData)
    read onto `device` (cuda by default).

    useu: rotate Bloch states by the wannier90 U matrices (needs a chk
    file loaded); wancut: overlap-discarding cutoff in units of summed
    spreads (reference default 4.0; None = exact, keep all overlaps).
    stats: a dict, filled with the wall (s) of the basin supports, the
    Wannier stack, the Sij assembly and Fa.
    """
    dev = resolve_device(device)
    if qe.device.type != dev.type:
        raise ValueError(f"the QE states live on {qe.device}, not {dev}: "
                         "read them with the same device")
    shape = tuple(decomp.shape)
    if tuple(qe.n) != shape:
        raise ValueError(f"QE grid {qe.n} != basin grid {shape}")
    nspin = qe.nspin
    fspin = 2.0 if nspin == 1 else 1.0
    nk = np.asarray(qe.nk, dtype=np.int64)
    nlat = int(np.prod(nk))
    ntot = int(np.prod(shape))
    nattr = decomp.nattr
    xattr = np.asarray(decomp.xattr)
    walls = {"support": 0.0, "wannier": 0.0, "sij": 0.0, "fa": 0.0}

    if qe.iswan:
        nbndw = qe.nbndw[:nspin].astype(np.int64)
    elif not useu:
        if nspin == 1:
            nbndw = np.array([qe.nbnd], dtype=np.int64)
        else:
            nbndw = np.array(
                [int(round((qe.occ[s * qe.nks:(s + 1) * qe.nks]
                            / qe.wk[:, None]).sum(1).mean()))
                 for s in range(2)], dtype=np.int64)
    else:
        raise ValueError("useu=True requires wannier chk data")

    # ---- group basin support points by (attractor, lattice shift) --------
    t0 = time.perf_counter()
    groups = {}
    for a in range(nattr):
        idx, w = decomp.basin_support(a)
        if idx.size == 0:
            continue
        p = _attractor_shifts(crystal, shape, xattr,
                              idx, np.full(idx.size, a))
        key = (p[:, 0] * 1000003 + p[:, 1] * 1009 + p[:, 2])
        for uk in np.unique(key):
            sel = key == uk
            groups.setdefault(a, []).append(
                (tuple(p[sel][0]),
                 torch.as_tensor(idx[sel], device=dev),
                 torch.as_tensor(w[sel], device=dev)))
    walls["support"] += time.perf_counter() - t0

    rvec = np.asarray(QE_rvectors(nk))
    sij_all, fa_all = [], []
    for s in range(nspin):
        nb = int(nbndw[s])
        nmo = nlat * nb
        # ---- Wannier stack on the home cell: (nlat*nb, ntot) -------------
        t0 = time.perf_counter()
        W = torch.empty((nlat, nb, ntot), dtype=torch.complex128,
                        device=dev)
        for b in range(nb):
            W[:, b, :] = qe.wannier_home(s, b, useu=useu).reshape(nlat, ntot)
        W = W.reshape(nmo, ntot)
        _sync(dev)
        walls["wannier"] += time.perf_counter() - t0

        # optional spread-based screening mask on (imo, jmo)
        t0 = time.perf_counter()
        mask = None
        if wancut is not None and wancut > 0 and useu and qe.iswan:
            cen = qe.center[s, :nb]                          # (nb,3) supercell
            pos = (cen[None, :, :] + rvec[:, None, :]).reshape(nmo, 3) / nk
            spr = np.broadcast_to(qe.spread[s, :nb], (nlat, nb)).reshape(nmo)
            d = np.zeros((nmo, nmo))
            for i in range(nmo):
                dv = crystal_supercell_shortest(crystal, nk,
                                                pos - pos[i][None, :])
                d[i] = np.linalg.norm(dv, axis=1)
            mask = torch.as_tensor(d <= (spr[:, None] + spr[None, :])
                                   * wancut, device=dev)

        S = torch.zeros((nattr, nmo, nmo), dtype=torch.complex128,
                        device=dev)
        for a, glist in groups.items():
            Sa = S[a]
            for (p, idx, w) in glist:
                Wp = W[:, idx]
                # S[imo, jmo] = sum_x w(x) conj(w_imo) w_jmo  (conj(f1)*f2,
                # calc_sij_wannier src/integration@proc.f90:1790-1800)
                M = (Wp.conj() * w[None, :]) @ Wp.T
                if mask is not None:
                    M = torch.where(mask, M, torch.zeros_like(M))
                q = torch.as_tensor(_pack_perm(nk, nb, p), device=dev)
                Sa.index_put_((q[:, None], q[None, :]), M, accumulate=True)
        S /= ntot
        del W
        _sync(dev)
        walls["sij"] += time.perf_counter() - t0

        # ---- Fa: permuted traces over lattice vectors --------------------
        t0 = time.perf_counter()
        fa = torch.empty((nattr, nattr, nlat), dtype=torch.float64,
                         device=dev)
        for k in range(nlat):
            q = torch.as_tensor(_pack_perm(nk, nb, rvec[k]), device=dev)
            Sp = S[:, q][:, :, q]
            fa[:, :, k] = torch.einsum("aji,bij->ab", S, Sp).real
        fa_all.append(fa.cpu().numpy())
        sij_all.append(S.cpu().numpy())
        walls["fa"] += time.perf_counter() - t0

    if stats is not None:
        stats.update(walls)
    return DelocResult(nspin=nspin, fspin=fspin, nk=nk,
                       nbndw=np.asarray(nbndw), sij=sij_all,
                       fa=np.stack(fa_all), xattr=xattr, rvec=rvec)


def QE_rvectors(nk):
    k1, k2, k3 = np.meshgrid(np.arange(nk[0]), np.arange(nk[1]),
                             np.arange(nk[2]), indexing="ij")
    return np.stack([k1.ravel(), k2.ravel(), k3.ravel()], axis=1)


def crystal_supercell_shortest(crystal, nk, dx_super):
    """Shortest cartesian images of supercell-fractional differences
    (supercell = cell scaled by nk; reference builds an auxiliary crystal,
    calc_sij_wannier src/integration@proc.f90:1723-1737)."""
    m = np.asarray(crystal.m_x2c) * np.asarray(nk, dtype=float)[None, :]
    dx = np.atleast_2d(dx_super) - np.rint(np.atleast_2d(dx_super))
    cand = np.array([[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1)
                     for k in (-1, 0, 1)], dtype=float)
    cart = (dx[:, None, :] + cand[None, :, :]) @ m.T
    d2 = np.einsum("nmk,nmk->nm", cart, cart)
    return cart[np.arange(len(cart)), np.argmin(d2, axis=1)]


# ------------------------------------------------------------- checkpoints

def write_sijchk(path, res: DelocResult):
    """Sij checkpoint (role of write_sijchk, integration@proc.f90:1593)."""
    np.savez_compressed(path, nspin=res.nspin, nk=res.nk, nbndw=res.nbndw,
                        xattr=res.xattr,
                        **{f"sij{s}": res.sij[s] for s in range(res.nspin)})


def read_sijchk(path):
    d = np.load(path)
    return d


def write_fachk(path, res: DelocResult):
    np.savez_compressed(path, nspin=res.nspin, nk=res.nk, nbndw=res.nbndw,
                        xattr=res.xattr, fa=res.fa)


def read_fachk(path, decomp=None) -> DelocResult:
    d = np.load(path)
    fa = d["fa"]
    nspin = int(d["nspin"])
    return DelocResult(nspin=nspin, fspin=2.0 if nspin == 1 else 1.0,
                       nk=d["nk"], nbndw=d["nbndw"], sij=[], fa=fa,
                       xattr=d["xattr"], rvec=QE_rvectors(d["nk"]))
