"""Elk LAPW density evaluator (STATE.OUT + GEOMETRY.OUT).

Reference behavior: src/elk_private.f90:50-53 with the implementation
src/elk_private@proc.f90 - read_out (:55), rho2 (:100), tolap (:232),
elk_geometry (:289), read_elk_state (:330). The field is rho_lm(r) real
spherical-harmonic radial tables per cell atom inside muffin tins, and a
plane-wave sum over the ngvec shortest G vectors of the FFT of the
interstitial grid density outside.

Design as fields/wien.py: host-side parsing (Fortran sequential
unformatted STATE.OUT records through fields/qe.FortranFile,
GEOMETRY.OUT text) into dense device
tables; batched evaluation with the angular part as one (nY, N) solid
harmonics block (ops/rlm) contracted against per-atom coefficient rows,
the radial part as a 4-node Lagrange gather on the log grid (reference
tools_math radial_derivs node scheme) that gathers only each point's
four radial nodes, (N, nY, 4), never a point's whole (nY, nrmt) table,
and the interstitial as a G-by-points phase matmul in point blocks.
Gradients and Hessians by autograd (fields/wien.lapw_derivs), Hessian
rows in the order [xx, xy, xz, yy, yz, zz].

Real-harmonic convention: rho2 combines Condon-Shortley Y_lm as
  m > 0:  (Y_lm + (-1)^m Y_l,-m)/sqrt(2)          = (-1)^m  S_lm
  m < 0:  (Y_lm - (-1)^m Y_l,-m)/(i sqrt(2))      = -S_lm
  m = 0:  Y_l0                                    = S_l0
with S_lm the ops/rlm real tesseral basis; the sign factors are folded
into the coefficient tables on the host.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..config import FDTYPE, resolve_device
from .qe import FortranFile
from .wien import PHASE_ELEMENTS, lagrange4, lapw_derivs, nearest_sphere

__all__ = ["ElkField", "read_geometry", "read_state"]


def read_geometry(path: str) -> dict:
    """Parse elk GEOMETRY.OUT (reference elk_geometry,
    src/elk_private@proc.f90:289-330): lattice vectors (columns of x2c)
    and the species/atom list."""
    lines = [ln.rstrip() for ln in open(path)]
    i = 0

    def seek(tag):
        nonlocal i
        while i < len(lines) and not lines[i].strip().startswith(tag):
            i += 1
        i += 1

    seek("avec")
    x2c = np.zeros((3, 3))
    for j in range(3):
        x2c[:, j] = [float(v) for v in lines[i + j].split()[:3]]
    seek("atoms")
    nspecies = int(lines[i].split()[0])
    i += 1
    species, natoms, pos = [], [], []
    for _ in range(nspecies):
        name = lines[i].split()[0].strip("'\"")
        species.append(name.replace(".in", ""))
        i += 1
        na = int(lines[i].split()[0])
        i += 1
        nat_sp = []
        for _ in range(na):
            nat_sp.append([float(v) for v in lines[i].split()[:3]])
            i += 1
        natoms.append(na)
        pos.append(np.asarray(nat_sp))
    return {"x2c": x2c, "species": species, "natoms": natoms,
            "pos_frac": pos}


def read_state(path: str, ncell: int) -> dict:
    """Parse the STATE.OUT binary (reference read_elk_state,
    src/elk_private@proc.f90:330-476). ncell = total atoms in the cell
    (from GEOMETRY.OUT)."""
    with FortranFile(path) as fh:
        def ints(count=None):
            d = fh.read_record("<i4")
            return d if count is None else d[:count]

        def floats():
            return fh.read_record("<f8")

        version = ints(3)

        def newer(i, j, k):
            v = tuple(int(x) for x in version)
            return v >= (i, j, k)

        fh.read_record()                 # spinpol logical
        nspecies = int(ints(1)[0])
        lmmaxvr = int(ints(1)[0])
        lmaxvr = int(round(math.sqrt(lmmaxvr))) - 1
        nrmtmax = int(ints(1)[0])
        if newer(2, 1, 22):
            ints(1)                      # nrcmtmax
        spr = np.zeros((nspecies, nrmtmax))
        nrmt = np.zeros(nspecies, dtype=int)
        for isp in range(nspecies):
            ints(1)                      # natoms(is)
            nrmt[isp] = int(ints(1)[0])
            spr[isp, :nrmt[isp]] = floats()[:nrmt[isp]]
            if newer(2, 1, 22):
                ints(1)                  # nrcmt(is)
                floats()                 # rcmt
        ngrid = ints(3)
        ngvec = int(ints(1)[0])
        ints()                           # ndmag
        ints()                           # nspinor
        if newer(2, 1, 22):
            ints()                       # fixspin/fsmtype
        if newer(2, 3, 16):
            ints()                       # ftmtype
        ints()                           # ldapu/dftu
        ints()                           # lmmaxdm
        data = floats()
    ngrtot = int(np.prod(ngrid))
    nmt = lmmaxvr * nrmtmax * ncell
    rhomt = data[:nmt].reshape(ncell, nrmtmax, lmmaxvr)  # fortran order:
    # rhotmp(lmmaxvr, nrmtmax, ncell) stored column-major == this C view
    rhoir = data[nmt:nmt + ngrtot]
    return {"version": version, "lmaxvr": lmaxvr, "nrmt": nrmt,
            "spr": spr, "ngrid": np.asarray(ngrid, dtype=int),
            "ngvec": ngvec, "rhomt": rhomt, "rhoir": rhoir}


class ElkField:
    """Batched elk LAPW density evaluator (Cartesian bohr points) on a
    device."""

    def __init__(self, geo: dict, st: dict, *, device=None):
        dev = resolve_device(device)

        def t(a):
            return torch.as_tensor(np.asarray(a, dtype=float), dtype=FDTYPE,
                                   device=dev)

        self.geo, self.stt = geo, st
        x2c = geo["x2c"]
        self.lmax = st["lmaxvr"]
        nY = (self.lmax + 1) ** 2

        # per-cell-atom data (species-major order, like the reference env)
        pos_cart, spc_of = [], []
        for isp, posl in enumerate(geo["pos_frac"]):
            for p in posl:
                pos_cart.append(x2c @ p)
                spc_of.append(isp)
        self.pos_cart = t(np.asarray(pos_cart))
        self.spc_of = np.asarray(spc_of, dtype=int)

        nrmt = st["nrmt"]
        self.rmt = np.array([st["spr"][s, nrmt[s] - 1]
                             for s in range(len(nrmt))])
        self.rmt_of = t(self.rmt[self.spc_of])
        self.spr_a = np.array([st["spr"][s, 0] for s in range(len(nrmt))])
        self.spr_b = np.array([
            math.log(self.rmt[s] / self.spr_a[s]) / (nrmt[s] - 1)
            for s in range(len(nrmt))])
        self.nrmt = nrmt
        # per cell atom: log-grid start, step and node count
        self._a = t(self.spr_a[self.spc_of])
        self._b = t(self.spr_b[self.spc_of])
        self._nr = torch.as_tensor(nrmt[self.spc_of], dtype=torch.int64,
                                   device=dev)

        # coefficient tables in the ops/rlm S basis: (ncell, nY, nrmt)
        sign = np.ones(nY)
        lp = np.zeros(nY)
        k = 0
        for l in range(self.lmax + 1):
            for m in range(-l, l + 1):
                lp[k] = l
                if m > 0:
                    sign[k] = (-1.0) ** m
                elif m < 0:
                    sign[k] = -1.0
                k += 1
        # note rhomt lm index runs m = -l..l (elk elem(l,m)), matching
        # the ops/rlm ordering
        self.C = t(np.transpose(st["rhomt"], (0, 2, 1))
                   * sign[None, :, None])              # (ncell, nY, nrmt)
        self.lpow = t(lp)

        # lattice for nearest-image wrapping
        self.P = t(x2c)
        self.Pinv = t(np.linalg.inv(x2c))

        # interstitial: FFT -> ngvec shortest G vectors (host)
        ngrid = st["ngrid"]
        rho_g = st["rhoir"].reshape(tuple(ngrid), order="F")
        rhok = np.fft.fftn(rho_g) / rho_g.size
        b = 2.0 * math.pi * np.linalg.inv(x2c).T          # rows b_i
        ii = [np.fft.fftfreq(n, 1.0 / n).astype(int) for n in ngrid]
        I, J, K = np.meshgrid(*ii, indexing="ij")
        gint = np.stack([I, J, K], -1).reshape(-1, 3)
        gc = gint @ b                                      # (Ng, 3) cart
        glen = np.linalg.norm(gc, axis=1)
        order = np.argsort(glen, kind="stable")[:st["ngvec"]]
        self.vgc = t(gc[order])                            # (ngvec, 3)
        self.rhok_re = t(np.real(rhok.reshape(-1)[order]))
        self.rhok_im = t(np.imag(rhok.reshape(-1)[order]))
        self.block = max(1024, min(1 << 16, PHASE_ELEMENTS
                                   // max(len(order), 1)))

    @property
    def device(self) -> torch.device:
        return self.pos_cart.device

    @classmethod
    def from_files(cls, state_path: str, geometry_path: str, *,
                   device=None) -> "ElkField":
        dev = resolve_device(device)
        geo = read_geometry(geometry_path)
        st = read_state(state_path, ncell=sum(geo["natoms"]))
        return cls(geo, st, device=dev)

    # -- evaluation -----------------------------------------------------
    def _assign(self, vT):
        return nearest_sphere(vT, self.pos_cart, self.P, self.Pinv,
                              self.rmt_of)

    def _interstitial(self, vT):
        ph = self.vgc @ vT                                 # (ngvec, N)
        return (self.rhok_re @ torch.cos(ph)) - (self.rhok_im @ torch.sin(ph))

    def _mt(self, iat, vtT, r):
        """MT density: per-point gather of the four radial nodes of the
        point's atom table + Lagrange radial + solid-harmonics
        contraction (reference rho2 MT branch)."""
        from ..ops.rlm import solid_harmonics

        a, b, nr = self._a[iat], self._b[iat], self._nr[iat]
        rc = torch.maximum(r, a)
        ir = torch.clamp(torch.floor(torch.log(rc.detach() / a) / b)
                         .to(torch.int64) + 1, min=2)
        ir = torch.minimum(ir, nr - 2)
        ii = (ir[:, None] - 2) + torch.arange(4, device=r.device)[None, :]
        r1 = a[:, None] * torch.exp(ii.to(FDTYPE) * b[:, None])
        W = lagrange4(rc, r1)                              # (N,4)
        nY = self.C.shape[1]
        ys = torch.arange(nY, device=r.device)
        cn = self.C[iat[:, None, None], ys[None, :, None],
                    ii[:, None, :]]                        # (N, nY, 4)
        g = torch.einsum("na,nya->ny", W, cn)              # rho_lm(r)
        S = solid_harmonics(vtT, self.lmax)                # (nY, N)
        rl = torch.exp(self.lpow[:, None] * torch.log(rc)[None, :])
        return (g.T / rl * S).sum(0)

    def rho(self, vT):
        iat, d0, r, ins = self._assign(vT)
        mt = self._mt(iat, d0, r)
        return torch.where(ins, mt, self._interstitial(vT))

    def grd(self, points_cart, nder: int = 2):
        """(rho (N,), grad (3,N), hess6 (6,N)) at Cartesian (N,3) points,
        Hessian rows [xx, xy, xz, yy, yz, zz]; derivatives by autograd.
        Gradient nulled within 1e-5 of a nucleus (reference rho2
        :195-198)."""
        x = torch.atleast_2d(torch.as_tensor(points_cart, dtype=FDTYPE,
                                             device=self.device))
        f, gf, h6 = lapw_derivs(self.rho, x, nder, self.block)
        if nder <= 0:
            return f, None, None
        with torch.no_grad():
            _, _, r, ins = self._assign(x.T)
            isnuc = ins & (r < 1e-5)
        gf = torch.where(isnuc[None, :], 0.0, gf)
        return f, gf, h6
