"""aiPI (pi7) atom-centered STO densities.

Role of the reference pi_private (src/pi_private.f90:52-54,
src/pi_private@proc.f90:53-300 pi_read/rho2, :305-490 read_ion): each
species carries an ion description - STO primitives per angular symmetry
(quantum number n, exponent z, normalization sqrt((2z)^(2n+1)/(2n)!)),
orbital coefficients and occupations - and the promolecular-style
density is the spherically-averaged sum rho = (1/4pi) sum_orb
nelec * phi(r)^2 over all atoms in range.

Device design: instead of the reference's per-point neighbor-list loops
over symmetries/orbitals/primitives, the ion basis is flattened into a
block-diagonal coefficient matrix C (norb x nsto) per species and padded
across species, so one batched evaluation is
  bval[pair, j] = N_j r^(n_j-1) e^(-z_j r)        (pairs x nsto)
  phi           = bval @ C^T                      (batched matmul)
  rho           = sum_o nelec_o phi_o^2
with the radial derivatives from the same products (phi', phi''),
evaluated over blocks of points so the (points, images, nsto) arrays stay
bounded. Gradient/Hessian assembly matches rho2
(src/pi_private@proc.f90:255-268).
"""
from __future__ import annotations

from dataclasses import dataclass
from math import factorial

import numpy as np
import torch

from ..config import FDTYPE, resolve_device

PI_CUTDENS = 1e-12     # density cutoff for the species radius (pi_read)
# elements of the (points, images, nsto) and (points, images, 3, 3)
# arrays a block of points may hold
PAIR_ELEMENTS = 1 << 24


def read_ion(path: str) -> dict:
    """Parse a pi5/pi7 STO ion file (read_ion,
    src/pi_private@proc.f90:305-490). Returns nsym, nsto/naos per
    symmetry, nn, z, xnsto, block coefficients and occupations."""
    toks = []
    lines = open(path, errors="replace").read().splitlines()

    # version line: PI7 / STO / very old (no marker)
    first = lines[0].split()
    start = 1
    if first and first[0].upper().startswith(("PI7", "STO")):
        pass
    elif first and first[0].upper().startswith(("GTO", "CGTO")):
        raise ValueError("pi ion file with GTO basis not supported")
    else:
        start = 0
    # flatten remaining numeric tokens; second line is the title card
    # "tition zn" which read with a fixed format - skip it plus the
    # descriptive line before it
    body = lines[start + 1:]
    # first body line: "name  Z"
    body = body[1:]
    for ln in body:
        toks.extend(ln.replace("D", "E").replace("d", "e").split())

    pos = 0

    def geti(n=1):
        nonlocal pos
        out = [int(float(toks[pos + i])) for i in range(n)]
        pos += n
        return out if n > 1 else out[0]

    def getf(n=1):
        nonlocal pos
        out = [float(toks[pos + i]) for i in range(n)]
        pos += n
        return out if n > 1 else out[0]

    nsym = geti()
    nsto = geti(nsym) if nsym > 1 else [geti()]
    ntsto = sum(nsto)
    nn = geti(ntsto) if ntsto > 1 else [geti()]
    z = getf(ntsto) if ntsto > 1 else [getf()]
    xn = [np.sqrt((2.0 * z[k]) ** (2 * nn[k] + 1) / factorial(2 * nn[k]))
          for k in range(ntsto)]
    naos = geti(nsym) if nsym > 1 else [geti()]
    ntaos = sum(naos)
    nelec = getf(ntaos) if ntaos > 1 else [getf()]
    if ntaos == 1:
        nelec = [nelec] if not isinstance(nelec, list) else nelec
    getf(ntaos)                      # orbital energies (unused)
    # coefficients: per symmetry, per orbital, per sto
    c = []
    for isy in range(nsym):
        for _ in range(naos[isy]):
            c.append(getf(nsto[isy]) if nsto[isy] > 1 else [getf()])
    return {"nsym": nsym, "nsto": nsto, "naos": naos,
            "nn": np.asarray(nn, np.int64), "z": np.asarray(z),
            "xnsto": np.asarray(xn), "c": c,
            "nelec": np.asarray(nelec, float)}


def _flatten_ion(ion):
    """Block-diagonal (ntaos, ntsto) coefficient matrix including the
    STO normalizations."""
    ntsto = int(sum(ion["nsto"]))
    ntaos = int(sum(ion["naos"]))
    C = np.zeros((ntaos, ntsto))
    io = 0
    for isy in range(ion["nsym"]):
        off = int(sum(ion["nsto"][:isy]))
        for _ in range(ion["naos"][isy]):
            C[io, off:off + ion["nsto"][isy]] = ion["c"][io]
            io += 1
    C = C * ion["xnsto"][None, :]
    return C


def _rho_radial(ion, r):
    """Exact rho(r), rho'(r), rho''(r) of one ion (NumPy, host): the
    reference rhoex1 kernel used both exactly and to fill tables."""
    r = np.atleast_1d(np.asarray(r, float))
    C = _flatten_ion(ion)
    n = ion["nn"].astype(float)
    zz = ion["z"]
    rr = r[:, None]
    b = rr ** (n - 1) * np.exp(-zz * rr)
    bp = b * ((n - 1) / rr - zz)
    bpp = b * ((n - 2) * (n - 1) / rr**2 - 2 * zz * (n - 1) / rr + zz * zz)
    phi = b @ C.T
    php = bp @ C.T
    phpp = bpp @ C.T
    w = ion["nelec"][None, :]
    pi4 = 4 * np.pi
    rho = (w * phi * phi).sum(1) / pi4
    rhop = 2 * (w * phi * php).sum(1) / pi4
    rhopp = 2 * (w * (php * php + phi * phpp)).sum(1) / pi4
    return rho, rhop, rhopp


@dataclass
class PiField:
    """All species ions + crystal images, evaluated in device batches."""

    atpos: torch.Tensor       # (M, 3) image positions (cartesian)
    atspc: torch.Tensor       # (M,) species->ion index
    nn: torch.Tensor          # (nspc, J) padded quantum numbers
    z: torch.Tensor           # (nspc, J) exponents
    C: torch.Tensor           # (nspc, O, J) padded block coefficients
    nelec: torch.Tensor       # (nspc, O)
    cutoff: np.ndarray        # (nspc,) per-species radius

    @property
    def device(self) -> torch.device:
        return self.atpos.device

    @classmethod
    def from_files(cls, crystal, ion_of_species: dict, *,
                   device=None) -> "PiField":
        """ion_of_species: {species index (0-based) or species name:
        ion file path}. Mirrors pi_read (src/pi_private@proc.f90:53-153)
        including the density-based species cutoff. The tables live on
        `device` (cuda by default)."""
        dev = resolve_device(device)
        ions = {}
        for key, path in ion_of_species.items():
            if isinstance(key, str):
                idx = [i for i, s in enumerate(crystal.species)
                       if s.name.lower() == key.lower()]
                if not idx:
                    raise ValueError(f"unknown species for pi ion: {key}")
                key = idx[0]
            ions[int(key)] = read_ion(path)
        nspc = len(crystal.species)
        used = sorted(ions)
        # per-species cutoff: extend until rho < PI_CUTDENS (pi_read)
        cutoff = np.zeros(nspc)
        for i in used:
            crad = 10.0
            while _rho_radial(ions[i], crad)[0][0] > PI_CUTDENS:
                crad *= 1.05
            cutoff[i] = crad

        J = max(int(sum(ions[i]["nsto"])) for i in used)
        O = max(int(sum(ions[i]["naos"])) for i in used)
        nn = np.ones((nspc, J))
        zz = np.full((nspc, J), 1.0)
        C = np.zeros((nspc, O, J))
        ne = np.zeros((nspc, O))
        for i in used:
            ion = ions[i]
            j = int(sum(ion["nsto"]))
            o = int(sum(ion["naos"]))
            nn[i, :j] = ion["nn"]
            zz[i, :j] = ion["z"]
            C[i, :o, :j] = _flatten_ion(ion)
            ne[i, :o] = ion["nelec"]

        rmax = float(cutoff.max())
        pos, spc, _ = crystal.atomic_environment(rmax)
        keep = np.isin(spc, used)
        pos, spc = pos[keep], spc[keep]

        def t(a):
            return torch.as_tensor(np.asarray(a, dtype=float), dtype=FDTYPE,
                                   device=dev)

        return cls(atpos=t(pos),
                   atspc=torch.as_tensor(np.asarray(spc), dtype=torch.int64,
                                         device=dev),
                   nn=t(nn), z=t(zz), C=t(C), nelec=t(ne), cutoff=cutoff)

    def eval(self, points_cart, nder: int = 2):
        """(rho, grad (N,3), hess (N,3,3)) with the assembly of rho2
        (src/pi_private@proc.f90:255-268), in blocks of points."""
        x = torch.atleast_2d(torch.as_tensor(points_cart, dtype=FDTYPE,
                                             device=self.device))
        M, J = self.atpos.shape[0], self.nn.shape[1]
        block = max(1, PAIR_ELEMENTS // max(M * max(J, 9), 1))
        outs = [self._eval_block(x[lo:lo + block], nder)
                for lo in range(0, x.shape[0], block)]
        return tuple(torch.cat([o[i] for o in outs]) for i in range(3))

    def _eval_block(self, x, nder):
        d = x[:, None, :] - self.atpos[None, :, :]          # (N, M, 3)
        r2 = (d * d).sum(-1)
        r = torch.sqrt(torch.clamp(r2, min=1e-14))
        cut = torch.as_tensor(self.cutoff, dtype=FDTYPE,
                              device=x.device)[self.atspc]
        mask = r <= cut[None, :]

        nn = self.nn[self.atspc]                            # (M, J)
        zz = self.z[self.atspc]
        C = self.C[self.atspc]                              # (M, O, J)
        ne = self.nelec[self.atspc]                         # (M, O)
        rr = r[..., None]                                   # (N, M, 1)
        b = rr ** (nn - 1.0) * torch.exp(-zz * rr)
        bp = b * ((nn - 1.0) / rr - zz)
        bpp = b * ((nn - 2.0) * (nn - 1.0) / rr**2
                   - 2.0 * zz * (nn - 1.0) / rr + zz * zz)
        phi = torch.einsum("nmj,moj->nmo", b, C)
        php = torch.einsum("nmj,moj->nmo", bp, C)
        phpp = torch.einsum("nmj,moj->nmo", bpp, C)
        pi4 = 4 * torch.pi
        w = ne[None, :, :] * mask[..., None]
        rho_a = (w * phi * phi).sum(-1) / pi4               # (N, M)
        rhop_a = 2 * (w * phi * php).sum(-1) / pi4
        rhopp_a = 2 * (w * (php * php + phi * phpp)).sum(-1) / pi4

        rho = rho_a.sum(-1)
        r1 = 1.0 / r
        grad = ((rhop_a * r1)[..., None] * d).sum(1)
        if nder < 2:
            return rho, grad, torch.zeros(x.shape[:1] + (3, 3),
                                          dtype=FDTYPE, device=x.device)
        rfac = rhopp_a - rhop_a * r1                        # (N, M)
        u = d * r1[..., None]                               # unit vectors
        eye = torch.eye(3, dtype=FDTYPE, device=x.device)
        h = (rfac[..., None, None] * u[..., :, None] * u[..., None, :]
             + (rhop_a * r1)[..., None, None]
             * eye[None, None, :, :]).sum(1)
        return rho, grad, h
