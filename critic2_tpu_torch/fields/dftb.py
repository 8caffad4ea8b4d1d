"""DFTB+ wavefunction fields (Slater-Koster basis).

Role of the reference dftb_private (src/dftb_private.f90:63-65,
src/dftb_private@proc.f90): read a DFTB+ calculation (detailed.xml for
dimensions/k-points/occupations, eigenvec.bin for eigenvectors, and the
wfc .hsd file for the Slater basis) and evaluate rho / grad rho / H /
G(r) at arbitrary points.

The basis: per species and angular momentum l, a radial function
R_l(r) = sum_i exp(-a_i r) sum_j c_ij r^{l+j-1} (reference calculate_rl,
src/dftb_private@proc.f90:940-982) times real spherical harmonics; an
AO on atom A with k-point phase e^{i k.L} per periodic image L. MOs are
psi_sk = sum_AO evec[AO, s, k] chi_AO and
rho = sum_sk occ_sk w_k |psi_sk|^2.

Device mapping: the reference walks a per-point neighbor list and
hand-assembles ylmderiv tables (src/dftb_private@proc.f90:230-526).
Here the candidate periodic images whose cutoff reaches a block of
points enter one masked batch: the real AO-image values chi (points x
rows) and their first
and second derivatives come from forward-mode differentiation
(torch.func.jvp with tangent e_k on every point, nested once for the
Hessian). The MOs are linear in chi, so the image->cell-AO reduction
with the k phase is one dense (rows, nAO) matrix per k and the AO->MO
contraction one matmul per (spin, k), applied alike to the values and
the derivatives. The radial part is evaluated EXACTLY (the reference
default interpolates a precomputed log grid; `exact=True` semantics).
Values stay float64 / complex128 on every device.
"""
from __future__ import annotations

import re
import struct as _struct
from dataclasses import dataclass

import numpy as np
import torch

from ..config import FDTYPE, resolve_device

__all__ = ["DftbBasisOrbital", "DftbData", "DftbField",
           "read_detailed_xml", "read_eigenvec_bin", "read_hsd_basis"]

CDTYPE = torch.complex128


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------
def read_detailed_xml(path: str) -> dict:
    """Parse the DFTB+ detailed.xml: flags, k-points (x 2pi, weights
    folded into occupations) and occupations (reference dftb_read first
    and second xml passes, src/dftb_private@proc.f90:76-120)."""
    text = open(path).read()
    low = text.lower()

    def tagval(name):
        m = re.search(rf"<{name}>\s*([^<]+)\s*</{name}>", low)
        if not m:
            raise ValueError(f"detailed.xml: missing <{name}>")
        return m.group(1).strip()

    isreal = tagval("real") in ("yes", "true", ".true.", "t", "1")
    nkpt = int(tagval("nrofkpoints"))
    nspin = int(tagval("nrofspins"))
    nstates = int(tagval("nrofstates"))
    norb = int(tagval("nroforbitals"))

    m = re.search(r"<kpointsandweights>(.*?)</kpointsandweights>", low,
                  re.S)
    if not m:
        raise ValueError("detailed.xml: missing <kpointsandweights>")
    vals = np.array([float(v) for v in m.group(1).split()])
    if vals.size != 4 * nkpt:
        raise ValueError("detailed.xml: bad kpointsandweights block")
    vals = vals.reshape(nkpt, 4)
    kpts = vals[:, :3] * (2.0 * np.pi)
    w = vals[:, 3]

    m = re.search(r"<occupations>(.*)</occupations>", low, re.S)
    if not m:
        raise ValueError("detailed.xml: missing <occupations>")
    occ = np.zeros((nstates, nkpt, nspin))
    body = m.group(1)
    # per spin, per k: a <kN> ... </kN> block of nstates numbers
    pos = 0
    for ispin in range(nspin):
        for ik in range(nkpt):
            mk = re.search(rf"<k{ik + 1}>(.*?)</k{ik + 1}>", body[pos:],
                           re.S)
            if not mk:
                raise ValueError(f"detailed.xml: missing occupations "
                                 f"<k{ik + 1}> (spin {ispin + 1})")
            nums = [float(v) for v in mk.group(1).split()]
            if len(nums) < nstates:
                raise ValueError("detailed.xml: short occupation block")
            occ[:, ik, ispin] = nums[:nstates]
            pos += mk.end()
    occ = occ * w[None, :, None]      # fold in k weights (reference :115)
    return dict(isreal=isreal, nkpt=nkpt, nspin=nspin, nstates=nstates,
                norb=norb, kpts=kpts, occ=occ)


def read_eigenvec_bin(path: str, norb: int, nstates: int, nkpt: int,
                      nspin: int, isreal: bool):
    """Fortran sequential unformatted eigenvec.bin: one int record
    (identity), then per spin (x kpt) x state one record of norb f64 or
    complex128 (reference dftb_read, src/dftb_private@proc.f90:122-142)."""
    buf = open(path, "rb").read()
    off = 0

    def rec():
        nonlocal off
        (n,) = _struct.unpack_from("<i", buf, off)
        off += 4
        payload = buf[off:off + n]
        off += n
        (n2,) = _struct.unpack_from("<i", buf, off)
        off += 4
        if n2 != n:
            raise ValueError("eigenvec.bin: bad record markers")
        return payload

    rec()                                           # identity
    if isreal:
        ev = np.empty((norb, nstates, nspin))
        for i in range(nspin):
            for k in range(nstates):
                ev[:, k, i] = np.frombuffer(rec(), dtype="<f8", count=norb)
        return ev
    ev = np.empty((norb, nstates, nkpt, nspin), dtype=complex)
    for i in range(nspin):
        for j in range(nkpt):
            for k in range(nstates):
                ev[:, k, j, i] = np.frombuffer(rec(), dtype="<c16",
                                               count=norb)
    return ev


@dataclass
class DftbBasisOrbital:
    l: int
    occ: float
    cutoff: float
    eexp: np.ndarray            # (nexp,)
    coef: np.ndarray            # (nexp, ncoef)


def read_hsd_basis(path: str) -> dict:
    """Parse the wfc .hsd basis file: {z: [DftbBasisOrbital, ...]}
    (reference next_hsd_atom, src/dftb_private@proc.f90 hsd parser)."""
    text = open(path).read()
    # tokenize into a brace tree
    toks = re.findall(r"\{|\}|=|[^\s{}=]+", text)
    i = 0

    def parse_block():
        nonlocal i
        items = []
        while i < len(toks):
            if toks[i] == "}":
                i += 1
                return items
            name = toks[i]
            i += 1
            if i < len(toks) and toks[i] == "=":
                i += 1
                # value: either scalar or block
                if toks[i] == "{":
                    i += 1
                    items.append((name.lower(), parse_block()))
                else:
                    items.append((name.lower(), toks[i]))
                    i += 1
            elif i < len(toks) and toks[i] == "{":
                i += 1
                items.append((name.lower(), parse_block()))
            else:
                items.append((name.lower(), None))
        return items

    tree = parse_block()
    out = {}
    for name, body in tree:
        if not isinstance(body, list):
            continue
        z = None
        orbs = []
        for key, val in body:
            if key == "atomicnumber":
                z = int(float(val))
            elif key == "orbital" and isinstance(val, list):
                d = dict(val)
                nums = [float(k) for k, _ in d.get("exponents", [])]
                coefs = [float(k) for k, _ in d.get("coefficients", [])]
                nexp = len(nums)
                if nexp == 0 or len(coefs) % nexp:
                    raise ValueError(f"hsd: bad orbital block for {name}")
                nc = len(coefs) // nexp
                orbs.append(DftbBasisOrbital(
                    l=int(float(d["angularmomentum"])),
                    occ=float(d.get("occupation", 0.0)),
                    cutoff=float(d["cutoff"]),
                    eexp=np.asarray(nums),
                    coef=np.asarray(coefs).reshape(nexp, nc)))
        if z is None:
            raise ValueError(f"hsd: atom block {name} missing "
                             "AtomicNumber")
        out[z] = orbs
    return out


# ---------------------------------------------------------------------------
# field
# ---------------------------------------------------------------------------
@dataclass
class DftbData:
    isreal: bool
    kpts: np.ndarray           # (nkpt, 3) already x 2pi
    occ: np.ndarray            # (nstates, nkpt, nspin) x k-weight
    evec: np.ndarray           # real: (norb, nstates, nspin);
    #                            complex: (norb, nstates, nkpt, nspin)
    basis: dict                # z -> [DftbBasisOrbital]


class DftbField:
    """Evaluator for rho/grad/H/gkin of a DFTB+ wavefunction, on a
    device (cuda by default)."""

    def __init__(self, crystal, data: DftbData, *, device=None):
        self.crystal = crystal
        self.data = data
        self._device = resolve_device(device)
        c = crystal
        zs = [c.species[s].z for s in np.asarray(c.species_of)]
        for z in zs:
            if z not in data.basis:
                raise ValueError(f"dftb basis missing for Z={z}")
        # AO order: cell atoms in order, per atom its orbitals, per
        # orbital m = -l..l (reference idxorb, dftb_read :172-190)
        self.norb = sum(2 * o.l + 1 for z in zs for o in data.basis[z])
        if self.norb != data.evec.shape[0]:
            raise ValueError(
                f"AO count {self.norb} != eigenvector rows "
                f"{data.evec.shape[0]}")
        self._zs = zs
        self.globalcutoff = max(o.cutoff for z in set(zs)
                                for o in data.basis[z])
        self._images = self._build_images()
        self._tables = None

    @property
    def device(self) -> torch.device:
        return self._device

    # -- periodic images whose basis sphere can reach the cell ----------
    def _build_images(self):
        c = self.crystal
        x = np.asarray(c.x_frac)
        if getattr(c, "ismolecule", False):
            lvecs = np.zeros((1, 3))
        else:
            # enough lattice shells to cover the global cutoff from any
            # point in the home cell
            m = np.asarray(c.m_x2c)
            inv = np.linalg.inv(m)
            h = 1.0 / np.linalg.norm(inv, axis=1)    # plane spacings
            nsh = np.maximum(1, np.ceil(self.globalcutoff / h + 1)
                             .astype(int))
            rng = [np.arange(-n, n + 1) for n in nsh]
            lvecs = np.stack(np.meshgrid(*rng, indexing="ij"),
                             axis=-1).reshape(-1, 3)
        # images: (nimg, 3) cart position, atom index, lattice vector
        pos, iat, lat = [], [], []
        mm = np.asarray(c.m_x2c)
        for L in lvecs:
            pc = (x + L) @ mm.T
            pos.append(pc)
            iat.append(np.arange(len(x)))
            lat.append(np.tile(L, (len(x), 1)))
        return (np.concatenate(pos), np.concatenate(iat),
                np.concatenate(lat))

    # -- AO tables -------------------------------------------------------
    def _ao_tables(self):
        """Static per-AO-image arrays for the dense masked batch."""
        data = self.data
        zs = self._zs
        pos, iat, lat = self._images
        # per (image, orbital-of-that-atom): radial params padded
        rows = []
        maxexp = max(len(o.eexp) for z in set(zs) for o in data.basis[z])
        maxco = max(o.coef.shape[1] for z in set(zs)
                    for o in data.basis[z])
        ao_first = np.cumsum([0] + [sum(2 * o.l + 1 for o in data.basis[z])
                                    for z in zs])
        for ii in range(len(iat)):
            z = zs[iat[ii]]
            ao0 = int(ao_first[iat[ii]])
            for io, orb in enumerate(data.basis[z]):
                for m in range(-orb.l, orb.l + 1):
                    ee = np.zeros(maxexp)
                    cc = np.zeros((maxexp, maxco))
                    ee[:len(orb.eexp)] = orb.eexp
                    cc[:orb.coef.shape[0], :orb.coef.shape[1]] = orb.coef
                    rows.append((pos[ii], lat[ii], ao0, orb.l, m,
                                 orb.cutoff, ee, cc))
                    ao0 += 1
        pos_a = np.array([r[0] for r in rows])
        lat_a = np.array([r[1] for r in rows])
        ao_a = np.array([r[2] for r in rows], dtype=np.int64)
        l_a = np.array([r[3] for r in rows], dtype=np.int64)
        m_a = np.array([r[4] for r in rows], dtype=np.int64)
        cut_a = np.array([r[5] for r in rows])
        ee_a = np.array([r[6] for r in rows])
        cc_a = np.array([r[7] for r in rows])
        return pos_a, lat_a, ao_a, l_a, m_a, cut_a, ee_a, cc_a

    def _device_tables(self):
        """The AO-image rows, the row -> AO maps (one per k, with the k
        phase; one real 0/1 map at Gamma) and the eigenvectors and
        occupations, on the device (built once)."""
        if self._tables is not None:
            return self._tables
        data = self.data
        dev = self.device
        (pos_a, lat_a, ao_a, l_a, m_a, cut_a, ee_a, cc_a) = \
            self._ao_tables()
        R, nAO = len(ao_a), self.norb

        def t(a):
            return torch.as_tensor(np.asarray(a, dtype=float), dtype=FDTYPE,
                                   device=dev)

        tab = {"pos": t(pos_a), "ee": t(ee_a), "cc": t(cc_a),
               "cut2": t(cut_a ** 2), "lmax": int(l_a.max()),
               # index of the real spherical harmonic (l, m), ops/rlm order
               "rlm": torch.as_tensor(l_a * l_a + l_a + m_a, device=dev),
               "occ": t(data.occ)}                         # (S, K, nspin)
        if data.isreal:
            P = np.zeros((R, nAO))
            P[np.arange(R), ao_a] = 1.0
            tab["P"] = t(P)[None]                          # (1, R, nAO)
            tab["ev"] = t(data.evec)[:, :, None, :]        # (nAO, S, 1, ns)
            tab["occ"] = tab["occ"][:, :1, :]
        else:
            kph = np.exp(1j * (lat_a @ data.kpts.T))       # (R, K)
            P = np.zeros((data.kpts.shape[0], R, nAO), complex)
            P[:, np.arange(R), ao_a] = kph.T
            tab["P"] = torch.as_tensor(P, dtype=CDTYPE, device=dev)
            tab["ev"] = torch.as_tensor(data.evec, dtype=CDTYPE, device=dev)
        self._tables = tab
        return tab

    # -- evaluation -------------------------------------------------------
    def _rows(self, x):
        """Indices of the AO-image rows whose cutoff sphere reaches the
        bounding box of the points x (N, 3); every other row is exactly
        zero at every one of them."""
        tab = self._device_tables()
        reach = torch.sqrt(tab["cut2"].max())
        lo = x.min(0).values - reach
        hi = x.max(0).values + reach
        inbox = ((tab["pos"] >= lo) & (tab["pos"] <= hi)).all(1)
        return torch.nonzero(inbox).reshape(-1)

    def _chi(self, x, rows):
        """AO-image values (N, R) at points x (N, 3) for the rows `rows`:
        R_l(r)/r^l times the real solid harmonic, zero beyond each
        orbital's cutoff."""
        from ..ops.rlm import solid_harmonics

        tab = self._device_tables()
        d = x[:, None, :] - tab["pos"][rows][None, :, :]        # (N, R, 3)
        r2 = (d * d).sum(-1)
        r = torch.sqrt(torch.clamp(r2, min=1e-12))
        # radial part / r^l (smooth): sum_i e^{-a r} sum_j c r^{j-1}
        cc = tab["cc"][rows]
        rp = torch.stack([r ** j for j in range(cc.shape[2])], -1)
        poly = (cc[None] * rp[:, :, None, :]).sum(-1)           # (N, R, ne)
        rad = (torch.exp(-tab["ee"][rows][None] * r[..., None])
               * poly).sum(-1)
        # chi = R_l Y_lm = (R_l / r^l) (r^l Y_lm) = rad * S_lm with S_lm
        # the real SOLID harmonic (polynomial in x,y,z): the whole
        # expression is smooth, so nested forward derivatives are exact
        N, R = r.shape
        S = solid_harmonics(d.reshape(-1, 3).T, tab["lmax"])    # (nlm, N*R)
        Ssel = S.reshape(S.shape[0], N, R).gather(
            0, tab["rlm"][rows][None, None, :].expand(1, N, R))[0]
        return torch.where(r2 <= tab["cut2"][rows][None, :], rad * Ssel,
                           0.0)

    def _psi(self, chi, rows):
        """MO values (N, S, K, nspin) of AO-image values chi (N, R) of
        the rows `rows`: the row -> AO map of each k, then the
        eigenvectors."""
        tab = self._device_tables()
        P, ev = tab["P"][:, rows], tab["ev"]
        xao = torch.einsum("nr,kra->kna", chi.to(P.dtype), P)  # (K, N, nAO)
        return torch.einsum("kna,askp->nskp", xao, ev)

    def _eval_block(self, x, nder):
        from torch.func import jvp

        tab = self._device_tables()
        occ = tab["occ"]                                    # (S, K, nspin)
        rows = self._rows(x)

        def chi(y):
            return self._chi(y, rows)

        E = torch.eye(3, dtype=FDTYPE, device=x.device)
        tang = [E[k].expand_as(x) for k in range(3)]
        psi = self._psi(chi(x), rows)
        dpsi = [self._psi(jvp(chi, (x,), (tang[k],))[1], rows)
                for k in range(3)]
        rho = (occ * (psi * psi.conj()).real).sum((1, 2, 3))
        g = torch.stack([2.0 * (occ * (psi.conj() * dp).real).sum((1, 2, 3))
                         for dp in dpsi], dim=1)            # (N, 3)
        gk = 0.5 * sum((occ * (dp * dp.conj()).real).sum((1, 2, 3))
                       for dp in dpsi)
        H = torch.zeros((x.shape[0], 3, 3), dtype=FDTYPE, device=x.device)
        if nder >= 2:
            for a in range(3):
                for b in range(a, 3):
                    d2chi = jvp(lambda y: jvp(chi, (y,), (tang[a],))[1],
                                (x,), (tang[b],))[1]
                    d2psi = self._psi(d2chi, rows)
                    hab = 2.0 * (occ * (dpsi[b].conj() * dpsi[a]
                                        + psi.conj() * d2psi).real
                                 ).sum((1, 2, 3))
                    H[:, a, b] = hab
                    H[:, b, a] = hab
        return rho, g, H, gk

    def eval(self, points, nder: int = 2, block: int = 1024):
        """points (N, 3) Cartesian -> (rho (N,), grad (N,3), H (N,3,3),
        gkin (N,)), `block` points at a time."""
        x = torch.atleast_2d(torch.as_tensor(points, dtype=FDTYPE,
                                             device=self.device))
        outs = [self._eval_block(x[lo:lo + block], nder)
                for lo in range(0, x.shape[0], block)]
        return tuple(torch.cat([o[i] for o in outs]) for i in range(4))

    @classmethod
    def from_files(cls, crystal, xml_path: str, bin_path: str,
                   hsd_path: str, *, device=None) -> "DftbField":
        dev = resolve_device(device)
        meta = read_detailed_xml(xml_path)
        ev = read_eigenvec_bin(bin_path, meta["norb"], meta["nstates"],
                               meta["nkpt"], meta["nspin"],
                               meta["isreal"])
        data = DftbData(isreal=meta["isreal"], kpts=meta["kpts"],
                        occ=meta["occ"], evec=ev,
                        basis=read_hsd_basis(hsd_path))
        return cls(crystal, data, device=dev)
