"""Quantum ESPRESSO Kohn-Sham states and Wannier functions (pwc files).

Role of the reference qedat type and its grid3mod machinery
(src/grid3mod.f90:26-46; read_pwc src/grid3mod@proc.f90:734-852;
read_wannier_chk :899-1038; rotate_qe_evc :1440-1497; get_qe_wnr
:1507-1624). The reference streams plane-wave coefficients band by band
from scratch files and assembles one Wannier function at a time with
per-k FFT loops. Here the coefficient block lives on the device: the
Bloch orbitals come from one index_put_ of the whole (k, band) stack
onto the FFT grid and one batched inverse FFT, the U rotation is one
einsum over the band axis, and every lattice-translated Wannier image on
the home cell is a single (nlat, nks) phase matrix times the (nks, Npts)
Bloch stack.

Conventions (as the reference's):
- pwc record layout as written by QE's pw2critic.x (read_pwc cites the
  record order); Fortran sequential unformatted with 4-byte markers.
- cfftnd(+1) is an UNSCALED backward transform (src/cfftnd.f90:34-40),
  i.e. torch.fft.ifftn(x, norm="forward").
- Grids are Fortran-ordered flat (n1 fastest); nl/igk_k are 1-based.
- Lattice vectors R are enumerated ilat = k3 + nk3*(k2 + nk2*k1)
  (C-order over (k1,k2,k3)), the order the reference derives from the
  k-point list (get_qe_wnr, src/grid3mod@proc.f90:1594-1599).

The file metadata (k-points, occupations, index maps, the wannier90 U
matrices, centres and spreads) stays host numpy; the coefficients `evc`
are a complex128 tensor on the device the file was read onto.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dfield

import numpy as np
import torch

from ..config import FDTYPE, resolve_device
from ..utils import trace

CDTYPE = torch.complex128


# ---------------------------------------------------------------- file layer

class FortranFile:
    """Sequential Fortran unformatted records (4-byte length markers)."""

    def __init__(self, path, mode="rb"):
        self.fh = open(path, mode)

    def read_record(self, dtype=None, count=-1):
        head = self.fh.read(4)
        if len(head) < 4:
            raise EOFError("no more records")
        nbytes = int(np.frombuffer(head, np.int32)[0])
        raw = self.fh.read(nbytes)
        tail = self.fh.read(4)
        if len(tail) < 4 or int(np.frombuffer(tail, np.int32)[0]) != nbytes:
            raise ValueError("corrupt Fortran record")
        if dtype is None:
            return raw
        return np.frombuffer(raw, dtype=dtype, count=count)

    def write_record(self, *arrays):
        raw = b"".join(np.asarray(a).tobytes() for a in arrays)
        mark = np.int32(len(raw)).tobytes()
        self.fh.write(mark + raw + mark)

    def close(self):
        self.fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


# ------------------------------------------------------------------ QE data

@dataclass
class QEData:
    """In-memory image of a pwc file (+ optional wannier90 chk data)."""

    nks: int                 # number of k-points
    nk: np.ndarray           # (3,) k-grid dimensions
    nbnd: int
    nspin: int
    gamma_only: bool
    n: tuple                 # (n1, n2, n3) real-space grid
    at: np.ndarray           # (3,3) lattice vectors (columns), pwc units
    kpt: np.ndarray          # (nks, 3) crystallographic k-points
    wk: np.ndarray           # (nks,)
    ek: np.ndarray           # (nspin*nks, nbnd) band energies [Ha]
    occ: np.ndarray          # (nspin*nks, nbnd)
    ngk: np.ndarray          # (nks,)
    igk_k: np.ndarray        # (nks, npwx) 1-based
    nl: np.ndarray           # (ngms,)  1-based flat Fortran grid index
    nlm: np.ndarray | None   # (ngms,)  gamma-only partner
    evc: torch.Tensor        # (nspin, nks, nbnd, npwx) complex128, device
    fpwc: str = ""
    # wannier (read_wannier_chk)
    iswan: bool = False
    nbndw: np.ndarray = dfield(default_factory=lambda: np.zeros(2, np.int64))
    center: np.ndarray | None = None   # (nspin, nbndw, 3) cryst (supercell)
    spread: np.ndarray | None = None   # (nspin, nbndw) bohr
    u: np.ndarray | None = None        # (nspin, nks, nbndw, nbndw)
    _fft_index: tuple = dfield(default=None, repr=False, compare=False)
    # constants of the states uploaded once: the k-points, the lattice
    # vectors, the U matrices of a spin (cleared by attach_wannier)
    _dev: dict = dfield(default_factory=dict, repr=False, compare=False)

    @property
    def nlat(self) -> int:
        return int(np.prod(self.nk))

    @property
    def device(self) -> torch.device:
        return self.evc.device

    def rvectors(self) -> np.ndarray:
        """(nlat, 3) integer lattice vectors, ilat = k3+nk3*(k2+nk2*k1)."""
        k1, k2, k3 = np.meshgrid(np.arange(self.nk[0]), np.arange(self.nk[1]),
                                 np.arange(self.nk[2]), indexing="ij")
        return np.stack([k1.ravel(), k2.ravel(), k3.ravel()], axis=1)

    # ---------------------------------------------------- in-memory builds

    @classmethod
    def from_arrays(cls, at, nk, n, kpt, wk, ek, occ, ngk, igk_k, nl, nlm,
                    evc: torch.Tensor, fpwc: str = "") -> "QEData":
        """A QEData from the records of a pwc file, in their layout and
        units: `at` (3,3) lattice vectors as columns, `kpt` (nks,3)
        Cartesian k-points (kpt @ at is crystallographic), `wk` (nks,),
        `ek` (nspin*nks, nbnd) in Ry, `occ` (nspin*nks, nbnd) the band
        weights, `ngk` (nks,), `igk_k` (nks, npwx) and `nl`, `nlm`
        (ngms,) 1-based, `nlm` None unless gamma-only; `evc` (nspin, nks,
        nbnd, npwx) complex128, already on the device the states are to
        live on. Converts the k-points to crystallographic and the
        energies to Ha, as read_pwc does."""
        nspin, nks, nbnd, _ = (int(v) for v in evc.shape)
        # cart (2pi/alat) -> crystallographic; Ry -> Ha
        kpt = np.asarray(kpt, dtype=np.float64) @ at
        ek = 0.5 * np.asarray(ek, dtype=np.float64)
        return cls(nks=nks, nk=np.asarray(nk, dtype=np.int64), nbnd=nbnd,
                   nspin=nspin, gamma_only=nlm is not None,
                   n=tuple(int(v) for v in n), at=at, kpt=kpt,
                   wk=np.asarray(wk, dtype=np.float64), ek=ek,
                   occ=np.asarray(occ, dtype=np.float64),
                   ngk=np.asarray(ngk, dtype=np.int64),
                   igk_k=np.asarray(igk_k, dtype=np.int64),
                   nl=np.asarray(nl, dtype=np.int64),
                   nlm=None if nlm is None else np.asarray(nlm, np.int64),
                   evc=evc, fpwc=fpwc)

    def density(self) -> torch.Tensor:
        """The electron density (n1, n2, n3), f64 on the states' device:
        rho = fspin/(det(at) sum(wk)) * sum_{s,k,b} occ |ifft(evc)|^2
        (read_pwc, src/grid3mod@proc.f90:734-852), one batch of bands per
        (spin, k)."""
        dev = self.device
        fspin = 2.0 if self.nspin == 1 else 1.0
        rho = torch.zeros(self.n, dtype=FDTYPE, device=dev)
        trace.count("host_syncs")
        occ_d = torch.tensor(self.occ, dtype=FDTYPE, device=dev)
        for ispin in range(self.nspin):
            for ik in range(self.nks):
                psi = self._to_grid(self.evc[ispin, ik], torch.full(
                    (self.nbnd,), ik, dtype=torch.int64, device=dev))
                w = occ_d[ispin * self.nks + ik][:, None, None, None]
                rho += (w * psi.abs() ** 2).sum(0)
        rho *= fspin / (abs(np.linalg.det(self.at)) * self.wk.sum())
        return rho

    def attach_wannier(self, u, centres_cart_ang, spreads_sq_ang2,
                       rlatt) -> "QEData":
        """Attach wannier90 data; each argument holds one entry per spin
        channel (per chk file): u (nks, nw, nw) complex, U[k, i, j] as
        rotate_qe_evc takes it; centres (nw, 3) Cartesian in angstrom;
        spreads (nw,) in angstrom^2; rlatt (3, 3) lattice vectors as rows,
        in angstrom. Converts the centres to crystallographic coordinates
        of the k-point supercell (cell fractions wrapped into [0, nk)) and
        the spreads to bohr, as read_wannier_chk does; returns self."""
        nspin = self.nspin
        nk = self.nk
        bohrtoa = 0.52917720859
        nbndw = np.zeros(2, np.int64)
        udata, cdata, sdata = [], [], []
        for is_, (uu, cen, spr, rl) in enumerate(zip(
                u, centres_cart_ang, spreads_sq_ang2, rlatt)):
            nbndw[is_] = uu.shape[1]
            # centers: cartesian (ang) -> supercell crystallographic
            cen = cen @ np.linalg.inv(rl)
            cen = np.where(cen > nk[None, :], cen - nk[None, :], cen)
            cen = np.where(cen < 0.0, cen + nk[None, :], cen)
            udata.append(uu)
            cdata.append(cen)
            sdata.append(np.sqrt(spr) / bohrtoa)

        jb = int(nbndw[:len(udata)].max())
        self.nbndw = nbndw if nspin == 2 else np.array([nbndw[0], nbndw[0]])
        self.u = np.zeros((nspin, self.nks, jb, jb), np.complex128)
        self.center = np.zeros((nspin, jb, 3))
        self.spread = np.zeros((nspin, jb))
        for is_ in range(len(udata)):
            b = int(nbndw[is_])
            self.u[is_, :, :b, :b] = udata[is_]
            self.center[is_, :b] = cdata[is_]
            self.spread[is_, :b] = sdata[is_]
        self.iswan = True
        self._dev.clear()
        return self

    # ------------------------------------------------------- device programs

    def _on_device(self, name, make):
        """The array make() on the states' device, uploaded at the first
        call (a copy from pageable memory, a host sync) and kept."""
        t = self._dev.get(name)
        if t is None:
            trace.count("host_syncs")
            t = self._dev[name] = torch.as_tensor(make(), device=self.device)
        return t

    def _index(self):
        """Flat 0-based Fortran grid index of every (k, plane wave) slot,
        its validity mask and the gamma-only partner index, on the
        device (built once)."""
        if self._fft_index is None:
            npwx = self.igk_k.shape[1]
            valid = np.arange(npwx)[None, :] < self.ngk[:, None]
            ig = np.where(valid, self.igk_k, 1) - 1
            idx = self.nl[ig] - 1
            idxm = None if (not self.gamma_only or self.nlm is None) else \
                self.nlm[ig] - 1
            dev = self.device
            trace.count("host_syncs", 2 if idxm is None else 3)
            self._fft_index = (
                torch.as_tensor(idx, device=dev),
                torch.as_tensor(valid, device=dev),
                None if idxm is None else torch.as_tensor(idxm, device=dev))
        return self._fft_index

    def _to_grid(self, coef, ks):
        """Unscaled inverse FFT of plane-wave rows: coef (B, npwx) complex
        for k-points ks (B,) -> (B, n1, n2, n3) complex on the device
        (ks a device tensor, or host integers copied over).
        One index_put_ writes every row's coefficients (the gamma-only
        conjugate partners after them, as the reference writes them)."""
        n1, n2, n3 = self.n
        idx, valid, idxm = self._index()
        B = coef.shape[0]
        if not isinstance(ks, torch.Tensor):
            trace.count("host_syncs")
            ks = torch.as_tensor(ks, device=self.device)
        sel = valid[ks]                                        # (B, npwx)
        rows = torch.arange(B, device=self.device)[:, None].expand_as(sel)
        grids = torch.zeros((B, n1 * n2 * n3), dtype=CDTYPE,
                            device=self.device)
        grids.index_put_((rows[sel], idx[ks][sel]), coef[sel])
        if idxm is not None:
            grids.index_put_((rows[sel], idxm[ks][sel]), coef[sel].conj())
        # Fortran-flat -> (n1, n2, n3); cfftnd(+1) == ifftn(norm="forward")
        g = grids.reshape(B, n3, n2, n1).permute(0, 3, 2, 1)
        return torch.fft.ifftn(g, dim=(1, 2, 3), norm="forward")

    def bloch_on_grid(self, spin: int, band: int, useu: bool = True):
        """Periodic parts u_k(r) of (optionally U-rotated) band `band`:
        (nks, n1, n2, n3) complex tensor on the device. Batched-FFT
        replacement for the reference scratch-file pipeline
        (rotate_qe_evc + the per-k FFT in get_qe_wnr,
        src/grid3mod@proc.f90:1440-1580)."""
        if useu and self.iswan:
            nb = int(self.nbndw[spin])
            # evcnew_k = sum_j U[k, j, band] evc_{k j}  (rotate_qe_evc)
            u = self._on_device(("u", spin),
                                lambda: self.u[spin])[:, :nb, band]
            coef = torch.einsum("kj,kjp->kp", u, self.evc[spin, :, :nb, :])
        else:
            coef = self.evc[spin, :, band, :]
        return self._to_grid(coef, torch.arange(self.nks,
                                                device=self.device))

    def wannier_home(self, spin: int, band: int, useu: bool = True,
                     phase_fix: bool = True):
        """All lattice images of Wannier function `band` on the home cell:
        W[ilat, i, j, k] = w_{band, R_ilat}(x_ijk)  (nlat, n1, n2, n3),
        a complex tensor on the device.

        Equals the reference get_qe_wnr supercell output read per cell
        copy (src/grid3mod@proc.f90:1507-1624): the supercell value at
        cell copy R is the home-cell value of the image translated by R.
        The k-sum is a (nlat, nks) phase matrix times the Bloch stack.
        """
        n1, n2, n3 = self.n
        dev = self.device
        u = self.bloch_on_grid(spin, band, useu=useu)         # (nks, n1,n2,n3)
        kpt = self._on_device("kpt", lambda: self.kpt)
        fx = torch.arange(n1, dtype=FDTYPE, device=dev) / n1
        fy = torch.arange(n2, dtype=FDTYPE, device=dev) / n2
        fz = torch.arange(n3, dtype=FDTYPE, device=dev) / n3
        ph = torch.exp(2j * torch.pi * (
            kpt[:, 0, None, None, None] * fx[None, :, None, None]
            + kpt[:, 1, None, None, None] * fy[None, None, :, None]
            + kpt[:, 2, None, None, None] * fz[None, None, None, :]))
        psi = (u * ph).reshape(self.nks, -1)                  # (nks, N)
        rvec = self._on_device("rvec",
                               lambda: self.rvectors().astype(np.float64))
        E = torch.exp(-2j * torch.pi * (rvec @ kpt.T)) / self.nlat
        W = E @ psi                                           # (nlat, N)
        if phase_fix:
            # reference tnorm: rotate the global abs-max value to real+
            # (gathered on the device, the argmax never read)
            t = W.reshape(-1).gather(0, torch.argmax(W.abs()).reshape(1))[0]
            W = W * (t.abs() / t)
        return W.reshape(self.nlat, n1, n2, n3)


def read_pwc(path: str, *, device=None) -> tuple[QEData, torch.Tensor]:
    """Read a pwc file (pw2critic.x); returns (QEData, rho grid
    (n1,n2,n3) f64 tensor), both on `device` (cuda by default).

    Mirrors src/grid3mod@proc.f90:734-852: the records are parsed here,
    `QEData.from_arrays` converts them (kpt_cryst = kpt @ at, Ry -> Ha)
    and `QEData.density` builds the density."""
    dev = resolve_device(device)
    fh = FortranFile(path)
    fh.read_record()                      # version
    fh.read_record()                      # nsp, nat
    fh.read_record()                      # atm
    fh.read_record()                      # ityp
    fh.read_record()                      # tau
    at = fh.read_record(np.float64)[:9].reshape(3, 3, order="F")
    hdr = fh.read_record(np.int32)
    nks, nbnd, nspin = int(hdr[0]), int(hdr[1]), int(hdr[2])
    gamma_only = bool(hdr[3])
    nk = fh.read_record(np.int32)[:3].astype(np.int64)
    n = tuple(int(v) for v in fh.read_record(np.int32)[:3])
    npwx, ngms = (int(v) for v in fh.read_record(np.int32)[:2])
    nkstot = nspin * nks
    kpt = fh.read_record(np.float64).reshape(nks, 3)          # (nks,3) cart
    wk = fh.read_record(np.float64)[:nks]
    ek = fh.read_record(np.float64).reshape(nkstot, nbnd)
    occ = fh.read_record(np.float64).reshape(nkstot, nbnd)
    ngk = fh.read_record(np.int32)[:nks].astype(np.int64)
    igk_k = fh.read_record(np.int32).reshape(nks, npwx).astype(np.int64)
    nl = fh.read_record(np.int32)[:ngms].astype(np.int64)
    nlm = None
    if gamma_only:
        nlm = fh.read_record(np.int32)[:ngms].astype(np.int64)

    evc = np.zeros((nspin, nks, nbnd, npwx), np.complex128)
    for ispin in range(nspin):
        for ik in range(nks):
            for ib in range(nbnd):
                evc[ispin, ik, ib, :ngk[ik]] = fh.read_record(
                    np.complex128)[:ngk[ik]]
    fh.close()

    trace.count("host_syncs")
    qe = QEData.from_arrays(at, nk, n, kpt, wk, ek, occ, ngk, igk_k, nl,
                            nlm, torch.as_tensor(evc, device=dev),
                            fpwc=path)
    return qe, qe.density()


def read_wannier_chk(qe: QEData, fileup: str, filedn: str | None = None):
    """Attach wannier90 .chk data (U matrices, centers, spreads) to `qe`.

    Mirrors src/grid3mod@proc.f90:899-1038: the records are parsed here,
    rejecting excluded bands and disentanglement and checking k-point
    consistency; `QEData.attach_wannier` converts them."""
    nspin = qe.nspin
    if (filedn is not None) != (nspin == 2):
        raise ValueError("chk files inconsistent with nspin")
    files = [fileup] + ([filedn] if filedn else [])

    udata, cdata, sdata, ldata = [], [], [], []
    for fname in files:
        fh = FortranFile(fname)
        fh.read_record()                                   # header
        nbnd = int(fh.read_record(np.int32)[0])
        jexcl = int(fh.read_record(np.int32)[0])
        if jexcl > 0:
            raise ValueError("number of excluded bands must be 0")
        if nbnd != qe.nbnd and nspin == 1:
            raise ValueError("number of bands different in wannier and qe")
        fh.read_record()                                   # excluded list
        rlatt = fh.read_record(np.float64)[:9].reshape(3, 3, order="F")
        fh.read_record(np.float64)                         # recip lattice
        nks = int(fh.read_record(np.int32)[0])
        nk = fh.read_record(np.int32)[:3].astype(np.int64)
        if nks == 0 or np.any(nk == 0) or nks != int(np.prod(nk)):
            raise ValueError("error in number of k-points (wannier)")
        if nks != qe.nks:
            raise ValueError("number of k-points from wannier != qe")
        kpt = fh.read_record(np.float64).reshape(nks, 3)
        ik = np.rint(kpt * nk[None, :])
        if np.max(np.abs(kpt * nk[None, :] - ik)) > 1e-5:
            raise ValueError("not a uniform monkhorst-pack grid")
        if np.max(np.abs(kpt - qe.kpt)) > 1e-5:
            raise ValueError("inconsistent wannier/qe k-point coordinates")
        qe.nk = nk
        fh.read_record()                                   # nntot
        jb = int(fh.read_record(np.int32)[0])              # num wann
        fh.read_record()                                   # chkpt position
        disent = bool(fh.read_record(np.int32)[0])
        if disent:
            raise ValueError("cannot handle disentangled wannier functions")
        u = fh.read_record(np.complex128).reshape(nks, jb, jb)
        u = u.transpose(0, 2, 1)                           # (k, i, j) col-major
        fh.read_record()                                   # m matrix
        cen = fh.read_record(np.float64).reshape(jb, 3)
        spr = fh.read_record(np.float64)[:jb]
        fh.close()
        udata.append(u)
        cdata.append(cen)
        sdata.append(spr)
        ldata.append(rlatt)
    return qe.attach_wannier(udata, cdata, sdata, ldata)
