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
  src/integration@proc.f90:2512-2526), accumulated with one index_put_;
  the image of each support point and the spread screening are found
  for all points, or all orbital pairs, at once on the device, and a
  basin's product runs over blocks of at most SIJ_BLOCK points, so the
  call's peak memory does not follow the basins' sizes,
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
from ..utils import trace


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


def _upload(x, dev):
    """A host array on the device: a copy from pageable memory, which
    waits for the device's queue."""
    trace.count("host_syncs")
    return torch.as_tensor(x, device=dev)


def _to_host(t):
    """t as a numpy array on the host. From a card the copy lands in
    page-locked memory: a DMA at the link's rate, into pages the caching
    host allocator hands back to the next call, where a fresh pageable
    array would take its page faults and a host-side copy."""
    trace.count("host_syncs")
    if t.device.type != "cuda":
        return t.cpu().numpy()
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h.numpy()


def _attractor_shifts(crystal, shape, xattr, support_idx):
    """Lattice shift p ((npts, 3) int64 on the points' device) of the
    image of the attractor at fractional `xattr` nearest each support
    point (flat grid indices, a device tensor): p = nint(x -
    c2x(shortest(x))), x = grid_frac - xattr (reference remapping,
    src/integration@proc.f90:1374-1438), shortest(x) by
    Crystal.shortest_vector's rule, the Delaunay-reduced frame and its 27
    neighbouring translations, batched on the device."""
    dev = support_idx.device
    m_c2x = np.linalg.inv(np.asarray(crystal.m_x2c, dtype=float))
    frame = (crystal.m_x2c, np.eye(3)) if crystal.ismolecule else \
        (crystal.m_x2xr, crystal.m_xr2c)
    # the attractor, the frame's two matrices, c2x and the translations
    # in one copy
    consts = _upload(np.concatenate(
        [np.asarray(xattr, dtype=float)[None, :]]
        + [np.asarray(m, dtype=float) for m in frame] + [m_c2x, _CAND]),
        dev)
    xa, m1, m2, c2x, cand = (consts[0], consts[1:4], consts[4:7],
                             consts[7:10], consts[10:])
    n1, n2, n3 = (int(v) for v in shape)
    i1 = support_idx // (n2 * n3)
    rr = support_idx - i1 * (n2 * n3)
    i2 = rr // n3
    i3 = rr - i2 * n3
    xg = torch.stack([i.to(torch.float64) / n
                      for i, n in ((i1, n1), (i2, n2), (i3, n3))], 1)
    x = xg - xa[None, :]
    if crystal.ismolecule:
        xs = x @ m1.T
    else:
        xr = x @ m1.T
        xr = xr - torch.round(xr)
        cart = (xr[:, None, :] + cand[None, :, :]) @ m2.T
        best = torch.argmin((cart * cart).sum(-1), dim=1)
        xs = cart[torch.arange(len(cart), device=dev), best]
    return torch.round(x - xs @ c2x.T).to(torch.int64)


# the 27 translations around a reduced or wrapped difference
_CAND = np.array([[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1)
                  for k in (-1, 0, 1)], dtype=float)
# points of one overlap product at most: bounds the gathered block of the
# Wannier stack (nmo x SIJ_BLOCK complex128, twice) and so the call's
# peak memory, whatever a basin's size
SIJ_BLOCK = 32768


def _support_groups(crystal, decomp, a, dev):
    """[(lattice shift, flat indices, weights)] of basin `a`'s support
    points grouped by the attractor image they belong to (groups in
    ascending shift key, points ascending within a group), each group cut
    into blocks of at most SIJ_BLOCK points; the index and weight blocks
    on the device."""
    idx, w = decomp.basin_support(a)
    if idx.size == 0:
        return []
    idx, w = _upload(idx, dev), _upload(w, dev)
    p = _attractor_shifts(crystal, decomp.shape,
                          np.asarray(decomp.xattr)[a], idx)
    key = p[:, 0] * 1000003 + p[:, 1] * 1009 + p[:, 2]
    # unique's size, then the group sizes and shifts: two host reads
    trace.count("host_syncs", 2)
    _, inv, cnt = torch.unique(key, return_inverse=True, return_counts=True)
    order = torch.argsort(inv, stable=True)
    first = order[torch.cumsum(cnt, 0) - cnt]
    head = torch.cat([cnt[:, None], p[first]], 1).cpu().numpy()
    idx, w = idx[order], w[order]
    out, lo = [], 0
    for n, *shift in head.tolist():
        trace.count("deloc.groups")
        for b0 in range(lo, lo + n, SIJ_BLOCK):
            b1 = min(b0 + SIJ_BLOCK, lo + n)
            out.append((tuple(shift), idx[b0:b1], w[b0:b1]))
        lo += n
    trace.count("deloc.support_points", int(lo))
    return out


def _screening(crystal, nk, pos, spr, wancut, dev, rows: int = 128):
    """(nmo, nmo) bool mask on the device of the overlaps kept: the
    minimum-image distance in the k-point supercell (pos: supercell
    fractions) at most wancut times the summed spreads. The minimum image
    is the nearest of the wrapped difference and its 26 neighbouring
    supercell translations (the reference's auxiliary supercell crystal,
    calc_sij_wannier, src/integration@proc.f90:1723-1737); `rows` rows at
    a time."""
    m = _upload(np.asarray(crystal.m_x2c, dtype=float)
                * np.asarray(nk, dtype=float)[None, :], dev)
    pos = _upload(pos, dev)
    spr = _upload(np.ascontiguousarray(spr), dev)
    cand = _upload(_CAND, dev)
    nmo = len(pos)
    keep = torch.empty((nmo, nmo), dtype=torch.bool, device=dev)
    for i0 in range(0, nmo, rows):
        dx = pos[None, :, :] - pos[i0:i0 + rows, None, :]
        dx = dx - torch.round(dx)
        cart = (dx[:, :, None, :] + cand) @ m.T
        d = torch.sqrt((cart * cart).sum(-1).min(-1).values)
        keep[i0:i0 + rows] = d <= (spr[i0:i0 + rows, None]
                                   + spr[None, :]) * wancut
    return keep


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
    Wannier stack, the Sij assembly (the screening mask included) and Fa
    (the readback included).

    While the program's record is on (utils/trace.py) the call is the
    root span `deloc` with `deloc.support`, `deloc.wannier`,
    `deloc.mask`, `deloc.sij`, `deloc.fa` and `deloc.readback` inside,
    and counts `deloc.groups` (attractor, shift) groups,
    `deloc.support_points` (their sizes summed), `deloc.zgemm_flops`
    (8 m n k for each complex128 matrix product: the U rotation, the
    stack's phase matrix, the Sij products and Fa's traces) and
    `host_syncs`.
    """
    with trace.span("deloc"):
        return _deloc_wannier(crystal, decomp, qe, useu, wancut, device,
                              stats)


def _deloc_wannier(crystal, decomp, qe, useu, wancut, device, stats):
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
    with trace.span("deloc.support"):
        groups = {a: g for a in range(nattr)
                  if (g := _support_groups(crystal, decomp, a, dev))}
    walls["support"] += time.perf_counter() - t0

    rvec = np.asarray(QE_rvectors(nk))
    sij_all, fa_all = [], []
    for s in range(nspin):
        nb = int(nbndw[s])
        nmo = nlat * nb
        # ---- Wannier stack on the home cell: (nlat*nb, ntot) -------------
        t0 = time.perf_counter()
        with trace.span("deloc.wannier"):
            W = torch.empty((nlat, nb, ntot), dtype=torch.complex128,
                            device=dev)
            for b in range(nb):
                W[:, b, :] = qe.wannier_home(s, b, useu=useu).reshape(
                    nlat, ntot)
            # per band: the U rotation (1 x nb by nb x npwx a k-point),
            # then the (nlat, nks) phase matrix times the Bloch stack
            rot = 8 * qe.nks * nb * qe.igk_k.shape[1] \
                if useu and qe.iswan else 0
            trace.count("deloc.zgemm_flops",
                        nb * (rot + 8 * nlat * qe.nks * ntot))
            W = W.reshape(nmo, ntot)
            _sync(dev)
        walls["wannier"] += time.perf_counter() - t0

        # optional spread-based screening mask on (imo, jmo)
        t0 = time.perf_counter()
        mask = None
        if wancut is not None and wancut > 0 and useu and qe.iswan:
            with trace.span("deloc.mask"):
                cen = qe.center[s, :nb]                  # (nb,3) supercell
                pos = (cen[None, :, :] + rvec[:, None, :]).reshape(nmo, 3) \
                    / nk
                spr = np.broadcast_to(qe.spread[s, :nb],
                                      (nlat, nb)).reshape(nmo)
                mask = _screening(crystal, nk, pos, spr, wancut, dev)

        # q of every lattice translation, one row per R (ilat order)
        perms = _upload(np.stack([_pack_perm(nk, nb, r) for r in rvec]), dev)
        with trace.span("deloc.sij"):
            S = torch.zeros((nattr, nmo, nmo), dtype=torch.complex128,
                            device=dev)
            for a, glist in groups.items():
                Sa = S[a]
                for (p, idx, w) in glist:
                    Wp = W[:, idx]
                    # S[imo, jmo] = sum_x w(x) conj(w_imo) w_jmo
                    # (conj(f1)*f2, calc_sij_wannier
                    # src/integration@proc.f90:1790-1800)
                    M = (Wp.conj() * w[None, :]) @ Wp.T
                    trace.count("deloc.zgemm_flops",
                                8 * nmo * nmo * int(idx.shape[0]))
                    if mask is not None:
                        M = torch.where(mask, M, torch.zeros_like(M))
                    r = np.asarray(p) % nk
                    q = perms[int(r[2] + nk[2] * (r[1] + nk[1] * r[0]))]
                    Sa.index_put_((q[:, None], q[None, :]), M,
                                  accumulate=True)
            S /= ntot
            del W
            _sync(dev)
        walls["sij"] += time.perf_counter() - t0

        # ---- Fa: permuted traces over lattice vectors --------------------
        t0 = time.perf_counter()
        with trace.span("deloc.fa"):
            fa = torch.empty((nattr, nattr, nlat), dtype=torch.float64,
                             device=dev)
            for k in range(nlat):
                q = perms[k]
                Sp = S[:, q][:, :, q]
                fa[:, :, k] = torch.einsum("aji,bij->ab", S, Sp).real
            trace.count("deloc.zgemm_flops",
                        8 * nlat * nattr * nattr * nmo * nmo)
        with trace.span("deloc.readback"):
            fa_all.append(_to_host(fa))
            sij_all.append(_to_host(S))
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
