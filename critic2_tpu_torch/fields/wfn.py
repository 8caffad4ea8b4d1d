"""Molecular wavefunctions: readers + batched GTO evaluation on the device.

Role of the reference wfn_private (src/wfn_private.f90, @proc.F90):
read .wfn/.wfx/.fchk/.molden molecular wavefunctions into primitive
Cartesian Gaussians phi_p = x^a y^b z^c exp(-alpha r^2) with MO
coefficients, and evaluate rho / grad / Hessian / G(r) / virial at
points (rho2, src/wfn_private@proc.F90:2032-2228).

Decomposition of the hot loop (calculate_mo_gto, :2707-2781), as in the
JAX package: the per-point loop over primitives becomes a dense
points x primitives computation - the derivative components chi_d are
(P, N) tensors built elementwise, and the MO contractions
phi_d = C (M, P) @ chi_d (P, N) are matmuls. Density assembly follows
rho2: rho = sum occ phi^2, grad = 2 sum occ phi dphi, H from
phi d2phi + dphi dphi, gkin = 1/2 sum occ |dphi|^2,
stress_ij = 1/2 sum occ (phi phi_ij - phi_i phi_j), vir = tr(stress).

Powers x^a are SELECTED from a product table V^0..V^nmax (rows of one
stacked tensor, gathered by exponent), never computed with pow: pow of a
subnormal base with a zero exponent is not 1 on every backend, and the
table is exact. The float32 route forms displacements in float64, runs
the (P, N) stage and the C @ chi matmuls in float32 at full precision
(no TF32) and accumulates every occupied-space contraction in float64.

Large molecules take the screened route (Morton-sorted 64-primitive
blocks, per-chunk block tables, see _screen): several chunks are
evaluated in one batched call through their block tables.

Primitive type convention = AIMPAC (li table,
src/wfn_private@proc.F90:2695-2705); fchk/molden shells are expanded to
normalized primitives as read_fchk does (gnorm, typtrans, basis-function
renormalization, :1230-1300).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field as dfield

import numpy as np
import torch

from ..config import EDTYPE, FDTYPE, resolve_device

__all__ = ["Wavefunction"]


def _morton3(cell):
    """Morton (Z-order) code of non-negative integer cells (N, 3):
    interleaves the low 21 bits of each axis so lexicographic order is
    spatially local (used to keep screening blocks/chunks compact)."""
    c = np.asarray(cell, dtype=np.uint64)

    def spread(v):
        v = v & np.uint64(0x1FFFFF)
        v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
        return v

    return ((spread(c[:, 0]) << np.uint64(2))
            | (spread(c[:, 1]) << np.uint64(1)) | spread(c[:, 2]))


# AIMPAC primitive type -> cartesian powers (reference li table)
_LI = np.array([
    (0, 0, 0),
    (1, 0, 0), (0, 1, 0), (0, 0, 1),
    (2, 0, 0), (0, 2, 0), (0, 0, 2), (1, 1, 0), (1, 0, 1), (0, 1, 1),
    (3, 0, 0), (0, 3, 0), (0, 0, 3), (2, 1, 0), (2, 0, 1), (0, 2, 1),
    (1, 2, 0), (1, 0, 2), (0, 1, 2), (1, 1, 1),
    (4, 0, 0), (0, 4, 0), (0, 0, 4), (3, 1, 0), (3, 0, 1), (1, 3, 0),
    (0, 3, 1), (1, 0, 3), (0, 1, 3), (2, 2, 0), (2, 0, 2), (0, 2, 2),
    (2, 1, 1), (1, 2, 1), (1, 1, 2),
    (0, 0, 5), (0, 1, 4), (0, 2, 3), (0, 3, 2), (0, 4, 1), (0, 5, 0),
    (1, 0, 4), (1, 1, 3), (1, 2, 2), (1, 3, 1), (1, 4, 0), (2, 0, 3),
    (2, 1, 2), (2, 2, 1), (2, 3, 0), (3, 0, 2), (3, 1, 1), (3, 2, 0),
    (4, 0, 1), (4, 1, 0), (5, 0, 0),
], dtype=np.int32)   # types 1..56 (0-indexed row = type-1; h block
                     # order matches the reference li table,
                     # src/wfn_private@proc.F90:2695-2705)

_DFACM1 = np.array([1, 1, 1, 2, 3, 8, 15, 48, 105, 384, 945],
                   dtype=float)   # (n-1)!! for n = 0..10

# fchk in-shell primitive order -> AIMPAC type (reference typtrans,
# src/wfn_private@proc.F90 read_fchk)
_TYPTRANS = np.array([
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 17, 14, 15, 18, 19, 16, 20,
    23, 29, 32, 27, 22, 28, 35, 34, 26, 31, 33, 30, 25, 24, 21],
    dtype=np.int32)

# molden in-shell order -> AIMPAC type: identical through f; the molden
# g cartesian order IS the AIMPAC order (reference typtrans,
# src/wfn_private@proc.F90:1503-1509)
_TYPTRANS_MOLDEN = np.array(
    list(_TYPTRANS[:20]) + list(range(21, 36)), dtype=np.int32)

# first/last fchk in-shell type index per |l| (reference jshl0/jshl1, 1-based)
_JSHL0 = {0: 1, 1: 2, 2: 5, 3: 11, 4: 21}
_JSHL1 = {0: 1, 1: 4, 2: 10, 3: 20, 4: 35}
_NSHLT_CAR = {0: 1, 1: 3, 2: 6, 3: 10, 4: 15}
_NSHLT_SPH = {0: 1, 1: 3, 2: 5, 3: 7, 4: 9}


def _gnorm(ityp: int, a: float) -> float:
    """Primitive normalization (reference gnorm,
    src/wfn_private@proc.F90:2877-2933)."""
    lx, ly, lz = _LI[ityp - 1]
    l = int(lx + ly + lz)
    dd = _DFACM1[2 * lx] * _DFACM1[2 * ly] * _DFACM1[2 * lz]
    return (2.0 ** (3.0 / 4.0 + l) * a ** (3.0 / 4.0 + l / 2.0)
            / np.pi ** (3.0 / 4.0) / np.sqrt(dd))


def _sph_to_car(l: int, order: str = "fchk") -> np.ndarray:
    """(nsph, ncar) solid-harmonic -> cartesian-product matrices
    (reference dsphcar/fsphcar/gsphcar{,_fchk}). Rows are m = 0, 1,
    -1, 2, -2, ...; columns follow the file format's in-shell cartesian
    component order. fchk and molden agree for d and f; only the g
    cartesian order differs (`order` selects it)."""
    s3 = np.sqrt(3.0); s3_8 = np.sqrt(3 / 8); s5_8 = np.sqrt(5 / 8)
    s6 = np.sqrt(6.0); s15 = np.sqrt(15.0); s15_4 = np.sqrt(15 / 4)
    s45_8 = np.sqrt(45 / 8)
    if l == 2:
        # fchk cartesian order: xx yy zz xy xz yz; sph: 0 1 -1 2 -2
        m = np.zeros((5, 6))
        s3_4 = np.sqrt(3 / 4)
        m[:, 0] = [-0.5, 0, 0, s3_4, 0]     # xx
        m[:, 1] = [-0.5, 0, 0, -s3_4, 0]    # yy
        m[:, 2] = [1.0, 0, 0, 0, 0]         # zz
        m[:, 3] = [0, 0, 0, 0, s3]          # xy
        m[:, 4] = [0, s3, 0, 0, 0]          # xz
        m[:, 5] = [0, 0, s3, 0, 0]          # yz
        return m
    if l == 3:
        # fchk cartesian order: xxx yyy zzz xyy xxy xxz xzz yzz yyz xyz
        m = np.zeros((7, 10))
        m[:, 0] = [0, -s3_8, 0, 0, 0, s5_8, 0]      # xxx
        m[:, 1] = [0, 0, -s3_8, 0, 0, 0, -s5_8]     # yyy
        m[:, 2] = [1, 0, 0, 0, 0, 0, 0]             # zzz
        m[:, 3] = [0, -s3_8, 0, 0, 0, -s45_8, 0]    # xyy
        m[:, 4] = [0, 0, -s3_8, 0, 0, 0, s45_8]     # xxy
        m[:, 5] = [-1.5, 0, 0, s15_4, 0, 0, 0]      # xxz
        m[:, 6] = [0, s6, 0, 0, 0, 0, 0]            # xzz
        m[:, 7] = [0, 0, s6, 0, 0, 0, 0]            # yzz
        m[:, 8] = [-1.5, 0, 0, -s15_4, 0, 0, 0]     # yyz
        m[:, 9] = [0, 0, 0, 0, s15, 0, 0]           # xyz
        return m
    if l == 4:
        d38 = 3 / 8; d34 = 3 / 4
        s5_16 = np.sqrt(5 / 16); s35_64 = np.sqrt(35 / 64)
        s10_8 = np.sqrt(10 / 8); s35_4 = np.sqrt(35 / 4)
        s35_8 = np.sqrt(35 / 8); s10 = np.sqrt(10.0)
        s45_4 = np.sqrt(45 / 4); s45 = np.sqrt(45.0)
        s315_8 = np.sqrt(315 / 8); s315_16 = np.sqrt(315 / 16)
        # fchk cart order: zzzz yzzz yyzz yyyz yyyy xzzz xyzz xyyz xyyy
        #                  xxzz xxyz xxyy xxxz xxxy xxxx
        m = np.zeros((9, 15))
        m[:, 0] = [1, 0, 0, 0, 0, 0, 0, 0, 0]                    # zzzz
        m[:, 1] = [0, 0, s10, 0, 0, 0, 0, 0, 0]                  # yzzz
        m[:, 2] = [-3, 0, 0, -s45_4, 0, 0, 0, 0, 0]              # yyzz
        m[:, 3] = [0, 0, -s45_8, 0, 0, 0, -s35_8, 0, 0]          # yyyz
        m[:, 4] = [d38, 0, 0, s5_16, 0, 0, 0, s35_64, 0]         # yyyy
        m[:, 5] = [0, s10, 0, 0, 0, 0, 0, 0, 0]                  # xzzz
        m[:, 6] = [0, 0, 0, 0, s45, 0, 0, 0, 0]                  # xyzz
        m[:, 7] = [0, -s45_8, 0, 0, 0, -s315_8, 0, 0, 0]         # xyyz
        m[:, 8] = [0, 0, 0, 0, -s10_8, 0, 0, 0, -s35_4]          # xyyy
        m[:, 9] = [-3, 0, 0, s45_4, 0, 0, 0, 0, 0]               # xxzz
        m[:, 10] = [0, 0, -s45_8, 0, 0, 0, s315_8, 0, 0]         # xxyz
        m[:, 11] = [d34, 0, 0, 0, 0, 0, 0, -s315_16, 0]          # xxyy
        m[:, 12] = [0, -s45_8, 0, 0, 0, s35_8, 0, 0, 0]          # xxxz
        m[:, 13] = [0, 0, 0, 0, -s10_8, 0, 0, 0, s35_4]          # xxxy
        m[:, 14] = [d38, 0, 0, -s5_16, 0, 0, 0, s35_64, 0]       # xxxx
        if order == "molden":
            # molden g cartesian order (reference gsphcar,
            # src/wfn_private@proc.F90:98-101): permute the fchk columns
            # xxxx yyyy zzzz xxxy xxxz xyyy yyyz xzzz yzzz xxyy xxzz
            # yyzz xxyz xyyz xyzz
            perm = [14, 4, 0, 13, 12, 8, 3, 5, 1, 11, 9, 2, 10, 7, 6]
            m = m[:, perm]
        return m
    raise ValueError(f"no spherical transform for l={l}")


def _shells_to_primitives(sh_l, sh_at, sh_exp, sh_cc, mo_sph,
                          order: str = "fchk"):
    """Expand contracted shells to normalized primitives and per-primitive
    MO coefficients (the tail of reference read_fchk/read_molden,
    src/wfn_private@proc.F90:1230-1300 and :1400-1425).

    sh_l: signed shell l (negative = spherical, except -1 which the
    caller unfolds to s+p); sh_at: 1-based atom; sh_exp/sh_cc: primitive
    exponents/contraction coefficients per shell; mo_sph: (M, nbas) MO
    coefficients over the shells' basis functions in shell order.
    Returns (icenter, itype, e, cmo).
    """
    icenter, itype, e, cmo_cols = [], [], [], []
    ns = 0
    for s in range(len(sh_l)):
        lsig = sh_l[s]
        l = abs(lsig)
        ee = np.asarray(sh_exp[s])
        cc = np.asarray(sh_cc[s])
        npr = len(ee)
        ncar = _NSHLT_CAR[l]
        nsph = _NSHLT_SPH[l] if lsig < -1 else ncar
        mo_blk = mo_sph[:, ns:ns + nsph]            # (M, nsph)
        if lsig < -1:
            mo_car = mo_blk @ _sph_to_car(l, order)  # (M, ncar)
        else:
            mo_car = mo_blk
        ns += nsph

        tt = _TYPTRANS if order == "fchk" else _TYPTRANS_MOLDEN
        for jj, j in enumerate(range(_JSHL0[l], _JSHL1[l] + 1)):
            ityp = int(tt[j - 1])
            cn = np.array([cc[k] * _gnorm(ityp, ee[k])
                           for k in range(npr)])
            # basis-function normalization (reference :1247-1258)
            norm = 0.0
            for k1 in range(npr):
                for k2 in range(npr):
                    norm += cn[k1] * cn[k2] / \
                        (ee[k1] + ee[k2]) ** (l + 1.5)
            cons = np.pi ** 1.5 * _DFACM1[2 * l] / 2 ** l
            norm = 1.0 / np.sqrt(norm * cons)
            if lsig >= 0:
                if 8 <= ityp <= 10:
                    norm *= np.sqrt(3.0)
                elif 14 <= ityp <= 19:
                    norm *= np.sqrt(5.0)
                elif ityp == 20:
                    norm *= np.sqrt(15.0)
                elif 24 <= ityp <= 29:
                    norm *= np.sqrt(7.0)
                elif 30 <= ityp <= 32:
                    norm *= np.sqrt(35.0 / 3.0)
                elif 33 <= ityp <= 35:
                    norm *= np.sqrt(35.0)
            for k in range(npr):
                icenter.append(sh_at[s] - 1)
                itype.append(ityp)
                e.append(ee[k])
                cmo_cols.append(cn[k] * norm * mo_car[:, jj])

    return (np.asarray(icenter, dtype=np.int32),
            np.asarray(itype, dtype=np.int32),
            np.asarray(e), np.stack(cmo_cols, axis=1))


@contextlib.contextmanager
def _full_f32(on: bool):
    """float32 matmuls at full precision inside the block, whatever the
    process-wide TF32 setting (the JAX route runs Precision.HIGHEST)."""
    if not on or (not torch.backends.cuda.matmul.allow_tf32
                  and torch.get_float32_matmul_precision() == "highest"):
        yield
        return
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.set_float32_matmul_precision(prev[1])


def _power_table(V, nmax: int):
    """V^0..V^nmax stacked on a new leading axis, plus a zero row at index
    nmax + 1 that out-of-range exponents select."""
    rows = [torch.ones_like(V), V]
    for _ in range(2, nmax + 1):
        rows.append(rows[-1] * V)
    rows.append(torch.zeros_like(V))
    return torch.stack(rows[:nmax + 1] + rows[-1:])


def _select(table, n, nmax: int):
    """table[n_p] per primitive p for integer exponents n (..., P), 0 for
    n < 0 or n > nmax: rows of the product table, selected, never pow."""
    idx = torch.where((n >= 0) & (n <= nmax), n, torch.full_like(n, nmax + 1))
    idx = idx.unsqueeze(0).unsqueeze(-1).expand((1,) + table.shape[1:])
    return torch.gather(table, 0, idx).squeeze(0)


def _gto_eval(xT, ctrT, lx, al, C, occ, nmax, nder, extras, lowp, edf=None):
    """The GTO density and its derivatives at points xT (..., 3, n), f64.

    ctrT (..., 3, P) f64 centres, lx (..., 3, P) int64 powers, al (..., P)
    and C (..., M, P) in the working dtype (f32 on the low-precision
    route), occ (M,) f64. Leading dimensions batch independent chunks
    (the screened route). edf: (ectrT (3, Pc), elx (3, Pc), eal (Pc,),
    ec (Pc,), enmax) of an EDF core density, or None. Returns
    (rho, grad (..., 3, n), h6 (..., 6, n)), or the extras dict."""
    wdt = EDTYPE if lowp else FDTYPE

    def acc(v):
        return v.to(FDTYPE) if lowp else v

    def psum(v):
        # f64 accumulation of the primitive-axis reductions
        return v.sum(-2, dtype=FDTYPE) if lowp else v.sum(-2)

    def mm(A, B):
        return torch.matmul(A, B)

    def occdot(v):
        return torch.matmul(occ, acc(v))

    # per-primitive displacements (..., 3, P, n): formed in f64 even on
    # the f32 route (casting xT first would shift positions by ~1e-7
    # bohr, a 1e-6-relative rho error near nuclei)
    dx = xT.unsqueeze(-2) - ctrT.unsqueeze(-1)
    if lowp:
        dx = dx.to(wdt)
    r2 = (dx * dx).sum(-3)                                 # (..., P, n)
    alb = al.unsqueeze(-1)
    ex = torch.exp(-alb * r2)
    X, Y, Z = dx.unbind(-3)
    a, b, c = lx.unbind(-2)
    af, bf, cf = (v.to(wdt).unsqueeze(-1) for v in (a, b, c))
    pX, pY, pZ = (_power_table(V, nmax) for V in (X, Y, Z))
    xa, yb, zc = _select(pX, a, nmax), _select(pY, b, nmax), \
        _select(pZ, c, nmax)
    chi0 = xa * yb * zc * ex
    phi0 = mm(C, chi0)                                     # (..., M, n)
    rho = occdot(phi0 * phi0)
    shp = xT.shape[:-2]
    n = xT.shape[-1]
    dev = xT.device

    if edf is not None:
        # EDF core density: rho_c = sum_p c_p x^l y^m z^n e^{-a r^2}
        # (reference calculate_edf; coefficients are raw, no gnorm)
        ectrT, elx, eal, ec, enmax = edf
        dxe = xT.unsqueeze(-2) - ectrT.unsqueeze(-1)       # (..., 3, Pc, n)
        if lowp:
            dxe = dxe.to(wdt)
        r2e = (dxe * dxe).sum(-3)
        exe = ec.unsqueeze(-1) * torch.exp(-eal.unsqueeze(-1) * r2e)
        Xe, Ye, Ze = dxe.unbind(-3)
        ae, be, ce_ = elx.unbind(-2)
        aef, bef, cef = (v.to(wdt).unsqueeze(-1) for v in (ae, be, ce_))
        eX, eY, eZ = (_power_table(V, enmax) for V in (Xe, Ye, Ze))
        xae, ybe, zce = _select(eX, ae, enmax), _select(eY, be, enmax), \
            _select(eZ, ce_, enmax)
        rho = rho + psum(xae * ybe * zce * exe)
    if nder < 1 and not extras:
        return (rho, torch.zeros(shp + (3, n), dtype=FDTYPE, device=dev),
                torch.zeros(shp + (6, n), dtype=FDTYPE, device=dev))

    dxa = af * _select(pX, a - 1, nmax) - 2.0 * alb * _select(pX, a + 1, nmax)
    dyb = bf * _select(pY, b - 1, nmax) - 2.0 * alb * _select(pY, b + 1, nmax)
    dzc = cf * _select(pZ, c - 1, nmax) - 2.0 * alb * _select(pZ, c + 1, nmax)
    phix = mm(C, dxa * yb * zc * ex)
    phiy = mm(C, xa * dyb * zc * ex)
    phiz = mm(C, xa * yb * dzc * ex)
    grad = torch.stack([occdot(phi0 * phix), occdot(phi0 * phiy),
                        occdot(phi0 * phiz)], dim=-2) * 2.0
    if edf is not None:
        ealb = eal.unsqueeze(-1)
        edxa = aef * _select(eX, ae - 1, enmax) \
            - 2.0 * ealb * _select(eX, ae + 1, enmax)
        edyb = bef * _select(eY, be - 1, enmax) \
            - 2.0 * ealb * _select(eY, be + 1, enmax)
        edzc = cef * _select(eZ, ce_ - 1, enmax) \
            - 2.0 * ealb * _select(eZ, ce_ + 1, enmax)
        grad = grad + torch.stack([psum(edxa * ybe * zce * exe),
                                   psum(xae * edyb * zce * exe),
                                   psum(xae * ybe * edzc * exe)], dim=-2)
    gkin = 0.5 * occdot(phix * phix + phiy * phiy + phiz * phiz)
    if nder < 2 and not extras:
        return (rho, grad,
                torch.zeros(shp + (6, n), dtype=FDTYPE, device=dev))

    al2 = 2.0 * alb
    al4 = 4.0 * alb ** 2
    sxa = (af * (af - 1)) * _select(pX, a - 2, nmax) \
        - al2 * (2 * af + 1) * xa + al4 * _select(pX, a + 2, nmax)
    syb = (bf * (bf - 1)) * _select(pY, b - 2, nmax) \
        - al2 * (2 * bf + 1) * yb + al4 * _select(pY, b + 2, nmax)
    szc = (cf * (cf - 1)) * _select(pZ, c - 2, nmax) \
        - al2 * (2 * cf + 1) * zc + al4 * _select(pZ, c + 2, nmax)
    phixx = mm(C, sxa * yb * zc * ex)
    phiyy = mm(C, xa * syb * zc * ex)
    phizz = mm(C, xa * yb * szc * ex)
    phixy = mm(C, dxa * dyb * zc * ex)
    phixz = mm(C, dxa * yb * dzc * ex)
    phiyz = mm(C, xa * dyb * dzc * ex)
    h6 = 2.0 * torch.stack([
        occdot(phi0 * phixx + phix * phix),
        occdot(phi0 * phiyy + phiy * phiy),
        occdot(phi0 * phizz + phiz * phiz),
        occdot(phi0 * phixy + phix * phiy),
        occdot(phi0 * phixz + phix * phiz),
        occdot(phi0 * phiyz + phiy * phiz)], dim=-2)
    if edf is not None:
        eal2 = 2.0 * ealb
        eal4 = 4.0 * ealb ** 2
        esxa = (aef * (aef - 1)) * _select(eX, ae - 2, enmax) \
            - eal2 * (2 * aef + 1) * xae + eal4 * _select(eX, ae + 2, enmax)
        esyb = (bef * (bef - 1)) * _select(eY, be - 2, enmax) \
            - eal2 * (2 * bef + 1) * ybe + eal4 * _select(eY, be + 2, enmax)
        eszc = (cef * (cef - 1)) * _select(eZ, ce_ - 2, enmax) \
            - eal2 * (2 * cef + 1) * zce + eal4 * _select(eZ, ce_ + 2, enmax)
        h6 = h6 + torch.stack([
            psum(esxa * ybe * zce * exe),
            psum(xae * esyb * zce * exe),
            psum(xae * ybe * eszc * exe),
            psum(edxa * edyb * zce * exe),
            psum(edxa * ybe * edzc * exe),
            psum(xae * edyb * edzc * exe)], dim=-2)
    if not extras:
        return rho, grad, h6
    s6 = 0.5 * torch.stack([
        occdot(phi0 * phixx - phix * phix),
        occdot(phi0 * phiyy - phiy * phiy),
        occdot(phi0 * phizz - phiz * phiz),
        occdot(phi0 * phixy - phix * phiy),
        occdot(phi0 * phixz - phix * phiz),
        occdot(phi0 * phiyz - phiy * phiz)], dim=-2)
    vir = s6[..., 0, :] + s6[..., 1, :] + s6[..., 2, :]
    return {"rho": rho, "grad": grad, "h6": h6, "gkin": gkin,
            "vir": vir, "stress6": s6}


def _is_low(dtype) -> bool:
    """True for the float32 route (dtype given and not float64)."""
    if dtype is None:
        return False
    if isinstance(dtype, torch.dtype):
        return dtype != torch.float64
    return np.dtype(dtype) != np.float64


def _as_points(xT, device):
    """xT (3, N) as a float64 tensor; a numpy input goes to `device`
    (cuda by default)."""
    if isinstance(xT, torch.Tensor):
        return xT.to(FDTYPE)
    return torch.as_tensor(np.ascontiguousarray(np.asarray(xT, float)),
                           dtype=FDTYPE, device=resolve_device(device))


class _ScreenShim:
    """Evaluator xT (3, G*n) -> (rho, grad, h6) over the screened kernel
    with G chunks' block tables (G, K): lane j belongs to chunk j // n.
    The consumers (ops.newton, ops.ode) must keep the lane layout (no
    lane packing) when G > 1."""

    def __init__(self, core, consts, bidx):
        self.core = core
        self.consts = consts
        self.bidx = bidx

    def __call__(self, xT):
        G = self.bidx.shape[0]
        xs = xT.reshape(3, G, -1).permute(1, 0, 2)
        f, gf, h6 = self.core(self.consts, xs, self.bidx)
        return (f.reshape(-1), gf.permute(1, 0, 2).reshape(3, -1),
                h6.permute(1, 0, 2).reshape(6, -1))


@dataclass
class Wavefunction:
    """Primitive-expanded molecular wavefunction (GTO). The arrays are
    host numpy; evaluations run on the device of their points."""

    atpos: np.ndarray          # (nat, 3) Cartesian bohr
    atz: np.ndarray            # (nat,)
    icenter: np.ndarray        # (P,) 0-based atom index per primitive
    itype: np.ndarray          # (P,) AIMPAC type (1-based)
    e: np.ndarray              # (P,) exponents
    cmo: np.ndarray            # (M, P) MO coefficients (primitive basis)
    occ: np.ndarray            # (M,) occupations
    wfntyp: str = "rhf"        # rhf | uhf | frac
    nalpha: int = 0
    source: str = ""
    # EDF core density (ECP wavefunctions; reference calculate_edf)
    edf_icenter: np.ndarray = None   # (Pc,) 0-based atom index
    edf_itype: np.ndarray = None     # (Pc,) AIMPAC type
    edf_e: np.ndarray = None         # (Pc,) exponents
    edf_c: np.ndarray = None         # (Pc,) coefficients
    # device tensors per (device, precision); screening plans
    _dev: dict = dfield(default_factory=dict, repr=False)
    _screen_cache: dict = dfield(default_factory=dict, repr=False)

    SCREEN_NPRI = 2048     # rho_eval_soa routes here above this size
    SWEEP_BYTES = 1 << 32  # budget of one batched screened evaluation

    @property
    def nmo(self):
        return self.cmo.shape[0]

    @property
    def npri(self):
        return self.cmo.shape[1]

    @property
    def nelec(self):
        return float(np.sum(self.occ))

    def reset_caches(self):
        """Forget device tensors and screening plans (after the arrays
        change, e.g. a shift of atpos into a molecular frame)."""
        self._dev = {}
        self._screen_cache = {}

    # ------------------------------------------------------------------
    def _consts(self, device, lowp: bool):
        """The dense evaluator's device tensors, cached per device and
        precision."""
        key = (str(device), lowp)
        if key not in self._dev:
            wdt = EDTYPE if lowp else FDTYPE
            li = _LI[self.itype - 1]               # (P, 3)

            def t(a, dt):
                return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                       device=device)

            d = dict(
                ctrT=t(np.asarray(self.atpos)[self.icenter].T, FDTYPE),
                lx=t(li.T, torch.int64),
                al=t(self.e, wdt), C=t(self.cmo, wdt),
                occ=t(self.occ, FDTYPE), nmax=int(li.max()) + 2,
                edf=None)
            if self.edf_e is not None:
                lie = _LI[self.edf_itype - 1]
                d["edf"] = (t(np.asarray(self.atpos)[self.edf_icenter].T,
                              FDTYPE),
                            t(lie.T, torch.int64), t(self.edf_e, wdt),
                            t(self.edf_c, wdt), int(lie.max()) + 2)
            self._dev[key] = d
        return self._dev[key]

    def eval_closure(self, nder: int = 2, extras: bool = False,
                     dtype=None):
        """The dense evaluator: xT (3, N) float64 tensor -> outputs on its
        device.

        Without extras: (rho, grad (3, N), h6 (6, N)).
        With extras: dict with rho, grad, h6, gkin, vir, stress6.

        dtype=torch.float32 selects the mixed-precision route:
        displacements formed in f64 then cast, the (P, N) stage and the
        C @ chi matmuls in f32 at full precision, every occ-contraction
        accumulated in f64 (pointwise rho error ~1e-6 relative; quadrature
        sums should use the f64 route). Outputs are always f64."""
        lowp = _is_low(dtype)

        def fn(xT):
            d = self._consts(xT.device, lowp)
            with _full_f32(lowp):
                return _gto_eval(xT, d["ctrT"], d["lx"], d["al"], d["C"],
                                 d["occ"], d["nmax"], nder, extras, lowp,
                                 d["edf"])

        return fn

    # ------------------------------------------------------------------
    # screened/blocked evaluation (large molecules)
    #
    # The reference evaluates per point through near-atom primitive
    # lists (list_near_atoms + the per-primitive dran cutoff,
    # src/wfn_private@proc.F90:2032-2228, 2707-2781, cutoffs
    # :3075-3145: dran_p = sqrt(-ln(1e-12)/alpha_p)). The batched form:
    #
    #   * primitives are sorted by a Morton code of their center (so
    #     nearby primitives are contiguous) and grouped into fixed-size
    #     blocks of B; each block carries a bounding sphere that
    #     contains every member's dran ball,
    #   * evaluation points are sorted spatially and cut into fixed
    #     chunks of n; each chunk carries its bounding sphere,
    #   * a host-computed (nchunk, K) table lists the blocks whose
    #     reach intersects each chunk (padded with an all-zero dummy
    #     block to the width K),
    #   * per chunk the evaluator gathers the K blocks' primitive data +
    #     the (M, Ka) MO-coefficient columns and contracts
    #     phi_d = C_g @ chi_d, rho = occ . phi^2 (the dense math
    #     restricted to the gathered primitives); several chunks go
    #     through one batched call.
    #
    # Primitives outside dran but inside a gathered block contribute
    # their true (sub-1e-12) exponential tails, so the screened result
    # differs from the dense one only below the reference's own
    # screening threshold.
    # ------------------------------------------------------------------
    def _screen(self, B: int = 64, thres: float = 1e-12):
        """Host-precomputed primitive blocks (cached). thres mirrors the
        reference rprim_thres (src/wfn_private@proc.F90:145):
        dran = sqrt(-ln(thres)/alpha)."""
        key = (B, thres)
        cache = self._screen_cache
        if key in cache:
            return cache[key]
        ctr = np.asarray(self.atpos)[self.icenter]        # (P, 3)
        al = np.asarray(self.e, float)
        li = _LI[self.itype - 1].astype(np.int32)         # (P, 3)
        dran = np.sqrt(-np.log(thres) / al)
        P = len(al)

        # spatial sort: Morton code of the quantized cell keeps
        # CONSECUTIVE primitives spatially adjacent, so 64-wide blocks
        # stay compact; within a cell, diffuse primitives (large dran)
        # group together so tight blocks keep small bounding radii
        h = 4.0
        cell = np.floor((ctr - ctr.min(0)) / h).astype(np.int64)
        perm = np.lexsort((dran, _morton3(cell)))
        ctr, al, li, dran = ctr[perm], al[perm], li[perm], dran[perm]

        # MO coefficients in the permuted primitive basis (the evaluator
        # contracts through the MOs, O(M Ka) per point, rather than a
        # density-matrix tile, O(Ka^2))
        Cp = np.ascontiguousarray(self.cmo[:, perm])      # (M, P)

        # pad to a block multiple with inert primitives (zero C columns
        # guarantee exactly zero contribution; dran = 0 keeps them out
        # of every block radius)
        npad = (-P) % B
        if npad:
            ctr = np.concatenate([ctr, np.broadcast_to(ctr.mean(0),
                                                       (npad, 3))])
            al = np.concatenate([al, np.ones(npad)])
            li = np.concatenate([li, np.zeros((npad, 3), np.int32)])
            dran = np.concatenate([dran, np.zeros(npad)])
            Cp = np.concatenate([Cp, np.zeros((len(Cp), npad))], axis=1)
        Pp = len(al)
        nb = Pp // B

        bctr = ctr.reshape(nb, B, 3).mean(axis=1)         # (nb, 3)
        spread = np.linalg.norm(
            ctr.reshape(nb, B, 3) - bctr[:, None, :], axis=2)
        bR = (spread + dran.reshape(nb, B)).max(axis=1)   # (nb,)

        # dummy block index nb: gathering it must be inert -> one extra
        # all-zero block appended to the per-primitive arrays
        ctr = np.concatenate([ctr, np.broadcast_to(ctr.mean(0), (B, 3))])
        al = np.concatenate([al, np.ones(B)])
        li = np.concatenate([li, np.zeros((B, 3), np.int32)])
        Cp = np.concatenate([Cp, np.zeros((len(Cp), B))], axis=1)
        scr = dict(
            perm=perm, B=B, nb=nb, Pp=Pp,
            bctr=bctr, bR=bR,
            ctrT=np.ascontiguousarray(ctr.T),             # (3, Pp+B)
            al=al, lxT=np.ascontiguousarray(li.T),        # (3, Pp+B)
            C=Cp,                                         # (M, Pp+B)
            occ=np.asarray(self.occ, np.float64),
            nmax=int(li.max()) + 2,
        )
        cache[key] = scr
        return scr

    def screen_consts(self, dtype=None, device=None):
        """The screened evaluator's device tensors, cached per precision
        and device (repeated driver calls do not re-transfer the MO
        coefficients)."""
        scr = self._screen()
        lowp = _is_low(dtype)
        dev = resolve_device(device)
        key = ("consts", lowp, str(dev))
        cache = self._screen_cache
        if key not in cache:
            wdt = EDTYPE if lowp else FDTYPE

            def t(a, dt):
                return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                       device=dev)

            cache[key] = {
                "s_ctrT": t(scr["ctrT"], FDTYPE),   # f64 displacements
                "s_al": t(scr["al"], wdt),
                "s_lxT": t(scr["lxT"], torch.int64),
                "s_C": t(scr["C"], wdt),
                "s_occ": t(scr["occ"], FDTYPE),     # f64 accumulation
            }
        return cache[key]

    def screened_shim(self, bidx, nder: int = 2, dtype=None, device=None):
        """Evaluator xT (3, G*n) -> (rho, grad, h6) for ops.newton /
        ops.ode over the block tables bidx (K,) of one chunk or (G, K) of
        G chunks (lane j in chunk j // n; the consumer must not pack
        lanes when G > 1)."""
        dev = resolve_device(device)
        key = ("shim", nder, _is_low(dtype))
        if key not in self._screen_cache:
            self._screen_cache[key] = self.screened_closure(nder=nder,
                                                            dtype=dtype)
        b = torch.as_tensor(self._trim(np.atleast_2d(np.asarray(bidx))),
                            dtype=torch.int64, device=dev)
        return _ScreenShim(self._screen_cache[key],
                           self.screen_consts(dtype, dev), b)

    def screened_closure(self, nder: int = 2, extras: bool = False,
                         dtype=None):
        """Screened evaluator: (consts, xT (..., 3, n), bidx (..., K)) ->
        (rho (..., n), grad (..., 3, n), h6 (..., 6, n)) [or extras
        dict]; leading dimensions batch chunks.

        Gathers the bidx blocks' primitive data and the (M, Ka)
        MO-coefficient columns, then runs the dense math on them. EDF
        core primitives (ECP wavefunctions) are evaluated densely per
        chunk (their count is O(atoms))."""
        scr = self._screen()
        B = scr["B"]
        nmax = scr["nmax"]
        lowp = _is_low(dtype)

        def fn(cst, xT, bidx):
            pidx = (bidx.unsqueeze(-1) * B
                    + torch.arange(B, dtype=bidx.dtype, device=bidx.device)
                    ).reshape(bidx.shape[:-1] + (-1,))     # (..., Ka)
            ctrT = cst["s_ctrT"][:, pidx].movedim(0, -2)   # (..., 3, Ka)
            lx = cst["s_lxT"][:, pidx].movedim(0, -2)
            al = cst["s_al"][pidx]
            Cg = cst["s_C"][:, pidx].movedim(0, -2)        # (..., M, Ka)
            edf = self._consts(xT.device, lowp)["edf"]
            with _full_f32(lowp):
                return _gto_eval(xT, ctrT, lx, al, Cg, cst["s_occ"], nmax,
                                 nder, extras, lowp, edf)

        return fn

    def screen_plan(self, points, n_chunk: int = 2048,
                    margin: float = 0.0):
        """Host chunk planner for the screened sweep.

        Sorts `points` (N, 3) spatially, cuts them into fixed chunks of
        n_chunk (tail padded by repeating the last point), and computes
        each chunk's active block list from bounding spheres. margin
        (bohr) widens the reach test - Newton/ODE callers use it to
        keep one block table valid while points move.

        Returns (order, xstack (nchunk, 3, n), bidx (nchunk, K), N).
        Outputs of the screened evaluator over xstack, flattened and
        indexed by argsort(order), restore caller order. K is the widest
        chunk's block count rounded up to a multiple of 64, as in the JAX
        package (the trailing entries are the inert dummy block)."""
        scr = self._screen()
        pts = np.asarray(points, float).reshape(-1, 3)
        N = len(pts)
        h = 3.0
        cell = np.floor((pts - pts.min(0)) / h).astype(np.int64)
        # Morton order: chunks of consecutive points stay spatially
        # compact
        order = np.argsort(_morton3(cell), kind="stable")
        p = pts[order]
        npadp = (-N) % n_chunk
        if npadp:
            p = np.concatenate([p, np.broadcast_to(p[-1], (npadp, 3))])
        nchunk = len(p) // n_chunk
        pc = p.reshape(nchunk, n_chunk, 3)
        centers = pc.mean(axis=1)                          # (nchunk, 3)
        rc = np.linalg.norm(pc - centers[:, None, :], axis=2).max(axis=1)

        dd = np.linalg.norm(centers[:, None, :] - scr["bctr"][None, :, :],
                            axis=2)                        # (nchunk, nb)
        act = dd <= rc[:, None] + scr["bR"][None, :] + margin
        kmax = int(act.sum(axis=1).max())
        K = max(64, -(-kmax // 64) * 64)
        bidx = np.full((nchunk, K), scr["nb"], dtype=np.int32)
        for i in range(nchunk):
            ai = np.flatnonzero(act[i])
            bidx[i, :len(ai)] = ai
        xstack = np.ascontiguousarray(pc.transpose(0, 2, 1))
        return order, xstack, bidx, N

    def _trim(self, bidx):
        """Block tables (G, K) cut to their widest row's active blocks:
        the trailing columns that are the inert dummy block in every row
        contribute exact zeros, so evaluating them only costs time."""
        nb = self._screen()["nb"]
        k = max(1, int((bidx != nb).sum(axis=1).max()))
        return bidx[:, :k]

    def sweep_group(self, n_chunk: int, K: int, nder: int) -> int:
        """Chunks one batched screened evaluation takes: the (G, Ka, n)
        temporaries (about 8 live at nder 0, 30 at nder 2) stay within
        SWEEP_BYTES."""
        live = 8 if nder < 1 else 30
        per = n_chunk * K * self._screen()["B"] * 8 * live
        return max(1, int(self.SWEEP_BYTES // max(per, 1)))

    def rho_eval_screened(self, xT, nder: int = 2, dtype=None,
                          n_chunk: int = 2048, device=None):
        """Screened (f, gf (3, N), h6 (6, N)) sweep; any N, any layout
        of points (they are re-sorted spatially internally). Outputs are
        float64 tensors on the device of xT (cuda for a numpy xT unless
        `device` says otherwise)."""
        dev = xT.device if isinstance(xT, torch.Tensor) \
            else resolve_device(device)
        pts = (xT.detach().cpu().numpy() if isinstance(xT, torch.Tensor)
               else np.asarray(xT)).T
        order, xstack, bidx, N = self.screen_plan(pts, n_chunk=n_chunk)
        key = ("sweep", nder, _is_low(dtype))
        if key not in self._screen_cache:
            self._screen_cache[key] = self.screened_closure(nder=nder,
                                                            dtype=dtype)
        core = self._screen_cache[key]
        cst = self.screen_consts(dtype, dev)
        G = self.sweep_group(n_chunk, bidx.shape[1], nder)
        parts = []
        for lo in range(0, len(xstack), G):
            xs = torch.as_tensor(xstack[lo:lo + G], dtype=FDTYPE,
                                 device=dev)
            bs = torch.as_tensor(self._trim(bidx[lo:lo + G]),
                                 dtype=torch.int64, device=dev)
            parts.append(core(cst, xs, bs))
        inv = torch.as_tensor(np.argsort(order), device=dev)
        res = []
        for i in range(3):
            o = torch.cat([p[i] for p in parts])           # (nch, [c,] n)
            o = o.movedim(0, -2).reshape(o.shape[1:-1] + (-1,))[..., :N]
            res.append(o[..., inv])
        return tuple(res)

    def rho_eval_dense(self, xT, nder: int = 2, block: int | None = None,
                       dtype=None, device=None):
        """(f, gf (3,N), h6 (6,N)) through the dense evaluator, `block`
        points a call (by default sized by the derivative order: ~6
        (P, N) temporaries live at nder 0 against ~20 at nder 2)."""
        xT = _as_points(xT, device)
        if block is None:
            block = {0: 1 << 17, 1: 1 << 15, 2: 1 << 12}[min(nder, 2)]
            if _is_low(dtype):
                block *= 2
        fn = self.eval_closure(nder=nder, dtype=dtype)
        N = xT.shape[1]
        if N <= block:
            return fn(xT)
        outs = [fn(xT[:, lo:lo + block]) for lo in range(0, N, block)]
        return tuple(torch.cat([o[i] for o in outs], dim=-1)
                     for i in range(3))

    def rho_eval_soa(self, xT, nder: int = 2, block: int | None = None,
                     dtype=None, device=None):
        """(f, gf (3,N), h6 (6,N)) float64 tensors, chunked.

        At or above SCREEN_NPRI primitives the points route through the
        screened sweep (rho_eval_screened): the dense route's (P, N)
        temporaries and O(M P N) matmuls do not survive a 10^4-primitive
        molecule. dtype=torch.float32 selects the mixed-precision
        evaluator (see eval_closure). A numpy xT goes to `device` (cuda
        by default)."""
        if self.npri >= self.SCREEN_NPRI:
            return self.rho_eval_screened(xT, nder=nder, dtype=dtype,
                                          device=device)
        return self.rho_eval_dense(xT, nder=nder, block=block, dtype=dtype,
                                   device=device)

    def extras_soa(self, xT, block: int = 4096, device=None):
        """rho, grad, h6, gkin, vir and stress6 at points xT (3, N)."""
        xT = _as_points(xT, device)
        fn = self.eval_closure(2, extras=True)
        N = xT.shape[1]
        if N <= block:
            return fn(xT)
        outs = [fn(xT[:, lo:lo + block]) for lo in range(0, N, block)]
        return {k: torch.cat([o[k] for o in outs], dim=-1) for k in outs[0]}

    def rho_eval(self, points, nder: int = 2, device=None):
        """Batch-first wrapper: points (N,3) -> (f, gf (N,3), hf (N,3,3))."""
        from ..ops.interp import sym6_to_mat

        pts = points if isinstance(points, torch.Tensor) \
            else _as_points(np.asarray(points, float).T, device).T
        f, gfT, h6 = self.rho_eval_soa(pts.T, nder=nder)
        return f, gfT.T, sym6_to_mat(h6)

    def mo_values(self, points, device=None):
        """MO values at points (N, 3) -> (M, N) float64 tensor."""
        pts = points if isinstance(points, torch.Tensor) \
            else _as_points(np.asarray(points, float).reshape(-1, 3).T,
                            device).T
        d = self._consts(pts.device, False)
        xT = pts.T.to(FDTYPE)
        dx = xT.unsqueeze(-2) - d["ctrT"].unsqueeze(-1)
        r2 = (dx * dx).sum(0)
        ex = torch.exp(-d["al"].unsqueeze(-1) * r2)
        nmax = d["nmax"] - 2
        chi = ex
        for k in range(3):
            chi = chi * _select(_power_table(dx[k], nmax), d["lx"][k], nmax)
        return d["C"] @ chi

    def rho_spin_soa(self, xT, device=None):
        """(rho_up, rho_dn) at points xT (3, N) (reference rho2 spin
        channels, src/wfn_private@proc.F90:2150-2176: RHF channels are
        rho/2 each; UHF sums alpha MOs then beta MOs)."""
        xT = _as_points(xT, device)
        mo = self.mo_values(xT.T)                           # (M, N)
        occ = torch.as_tensor(self.occ, dtype=FDTYPE, device=xT.device)
        if self.wfntyp == "uhf":
            up = torch.arange(self.nmo, device=xT.device) < self.nalpha
            zero = torch.zeros_like(occ)
            return (torch.where(up, occ, zero) @ (mo * mo),
                    torch.where(~up, occ, zero) @ (mo * mo))
        rho = occ @ (mo * mo)
        return 0.5 * rho, 0.5 * rho

    # ------------------------------------------------------------------
    # hole/potential properties (reference wfn_private@proc.F90
    # mep :2231, uslater :2311, xhole :2423)
    # ------------------------------------------------------------------
    def _hole_points(self, points, device):
        """points (N, 3) as an f64 tensor (numpy goes to `device`)."""
        if isinstance(points, torch.Tensor):
            return points.to(FDTYPE).reshape(-1, 3)
        return _as_points(np.asarray(points, float).reshape(-1, 3).T,
                          device).T

    def _rinv_chunk(self) -> int:
        """Points a block of (B, P, P) rinv integrals: about 2^22
        elements live at a time."""
        return max(8, (1 << 22) // max(self.npri * self.npri, 1))

    def mep(self, points, *, device=None):
        """Molecular electrostatic potential at points (N, 3):
        sum_A Z_A/|r-R_A| - sum_mn D_mn <m|1/|r-r0||n> (reference mep,
        src/wfn_private@proc.F90:2231-2309, via libCINT CINT1e_rinv;
        here via the McMurchie-Davidson rinv integrals), an f64 tensor on
        the points' device."""
        from ..ops.mdint import _rinv_chunks

        pts = self._hole_points(points, device)
        dev = pts.device
        C = torch.as_tensor(self.cmo, dtype=FDTYPE, device=dev)
        occ = torch.as_tensor(self.occ, dtype=FDTYPE, device=dev)
        el = torch.empty(pts.shape[0], dtype=FDTYPE, device=dev)
        with _full_f32(True):
            D = (C.T * occ) @ C                                # 1-RDM
            for lo, V in _rinv_chunks(self, pts, self._rinv_chunk()):
                el[lo:lo + V.shape[0]] = (V * D).sum((1, 2))
        at = torch.as_tensor(self.atpos, dtype=FDTYPE, device=dev)
        z = torch.as_tensor(self.atz, dtype=FDTYPE, device=dev)
        d = torch.linalg.norm(pts[:, None, :] - at[None], dim=-1)
        vnuc = (z[None, :] / torch.clamp(d, min=1e-14)).sum(1)
        return vnuc - el

    def uslater(self, points, want_nheff: bool = False, *, device=None):
        """Slater potential U_x (and optionally the effective hole
        normalization) at points (N, 3) (reference uslater,
        src/wfn_private@proc.F90:2311-2420): U_x = -(q V q)/rho with
        q_mu = sum_i phi_i(r) c_i_mu over occupied MOs. f64 tensors on
        the points' device."""
        from ..ops.brhole import xlnorm
        from ..ops.mdint import _rinv_chunks

        pts = self._hole_points(points, device)
        dev = pts.device
        C = torch.as_tensor(self.cmo, dtype=FDTYPE, device=dev)
        qVq = torch.empty(pts.shape[0], dtype=FDTYPE, device=dev)
        with _full_f32(True):
            q = self.mo_values(pts).T @ C                      # (B, P)
            for lo, V in _rinv_chunks(self, pts, self._rinv_chunk()):
                ql = q[lo:lo + V.shape[0]]
                qVq[lo:lo + V.shape[0]] = torch.einsum(
                    "bm,bmn,bn->b", ql, V, ql)
        ex = self.extras_soa(pts.T)
        rho = ex["rho"]
        ux = -qVq / torch.clamp(rho, min=1e-40)
        if not want_nheff:
            return ux
        lap = ex["h6"][0] + ex["h6"][1] + ex["h6"][2]
        gmod = torch.sqrt((ex["grad"] ** 2).sum(0))
        rhos = 0.5 * rho
        laps = 0.5 * lap
        drhos2 = (0.5 * gmod) ** 2
        dsigs = ex["gkin"] - 0.25 * drhos2 / torch.clamp(rhos, min=1e-40)
        quads = (laps - 2.0 * dsigs) / 6.0
        return ux, xlnorm(rhos, quads, 2.0 * ux)

    def xhole(self, points, xref, *, device=None):
        """Exchange hole h_x(r; r_ref) = -gamma_1(r, r_ref)^2 /
        rho_spin(r_ref) for RHF (reference xhole,
        src/wfn_private@proc.F90:2423-2453), an f64 tensor on the points'
        device."""
        if self.wfntyp != "rhf":
            raise NotImplementedError("xhole: only rhf supported "
                                      "(as in the reference)")
        pts = self._hole_points(points, device)
        xr = torch.as_tensor(np.asarray(xref, float).reshape(1, 3),
                             dtype=FDTYPE, device=pts.device)
        mop = self.mo_values(pts)                              # (M, B)
        mor = self.mo_values(xr)[:, 0]                         # (M,)
        gam1 = mor @ mop
        rho_ref = self.rho_eval_soa(xr.T, nder=0)[0]
        rho_spin = torch.clamp(0.5 * rho_ref[0], min=1e-40)
        return -(gam1 * gam1) / rho_spin

    def tile(self, reps=(2, 2, 2), gap: float = 4.0) -> "Wavefunction":
        """Non-interacting assembly: reps[0]*reps[1]*reps[2] displaced
        copies of this wavefunction, spaced bbox + gap (bohr) apart.

        The copies' MOs do not overlap electronically (each keeps its
        own occupied set; cmo is block-diagonal), so every integral is
        exactly ncopies x the monomer value - a machine-checkable
        large-molecule workload for the screened evaluator."""
        reps = tuple(int(v) for v in reps)
        ncopy = reps[0] * reps[1] * reps[2]
        span = self.atpos.max(0) - self.atpos.min(0) + gap
        offsets = np.stack(np.meshgrid(
            *[np.arange(r) for r in reps], indexing="ij"),
            -1).reshape(-1, 3) * span[None, :]
        nat, P, M = len(self.atz), self.npri, self.nmo
        atpos = (self.atpos[None, :, :] + offsets[:, None, :]
                 ).reshape(-1, 3)
        atz = np.tile(self.atz, ncopy)
        icenter = (self.icenter[None, :]
                   + (np.arange(ncopy) * nat)[:, None]).reshape(-1)
        itype = np.tile(self.itype, ncopy)
        e = np.tile(self.e, ncopy)
        cmo = np.zeros((M * ncopy, P * ncopy))
        for k in range(ncopy):
            cmo[k * M:(k + 1) * M, k * P:(k + 1) * P] = self.cmo
        occ = np.tile(self.occ, ncopy)
        if self.wfntyp == "uhf":
            # restore the "all alpha MOs first" layout that nalpha
            # encodes (the per-copy tiling interleaves spins)
            na = self.nalpha
            idx = np.concatenate([
                (np.arange(ncopy)[:, None] * M
                 + np.arange(na)[None, :]).ravel(),
                (np.arange(ncopy)[:, None] * M
                 + np.arange(na, M)[None, :]).ravel()])
            cmo = cmo[idx]
            occ = occ[idx]
        kw = {}
        if self.edf_e is not None:
            kw = dict(
                edf_icenter=(self.edf_icenter[None, :]
                             + (np.arange(ncopy) * nat)[:, None]
                             ).reshape(-1).astype(np.int32),
                edf_itype=np.tile(self.edf_itype, ncopy),
                edf_e=np.tile(self.edf_e, ncopy),
                edf_c=np.tile(self.edf_c, ncopy))
        return Wavefunction(
            atpos=atpos, atz=atz, icenter=icenter.astype(np.int32),
            itype=itype, e=e, cmo=cmo, occ=occ, wfntyp=self.wfntyp,
            nalpha=self.nalpha * ncopy if self.wfntyp == "uhf" else 0,
            source=f"{self.source}[tiled {reps}]", **kw)

    # ------------------------------------------------------------------
    # readers
    # ------------------------------------------------------------------
    @classmethod
    def from_file(cls, path: str) -> "Wavefunction":
        low = path.lower()
        if low.endswith(".wfn"):
            return cls.read_wfn(path)
        if low.endswith(".wfx"):
            return cls.read_wfx(path)
        if low.endswith(".fchk") or low.endswith(".fck") or \
                low.endswith(".fch"):
            return cls.read_fchk(path)
        if low.endswith(".molden") or low.endswith(".molden.input"):
            return cls.read_molden(path)
        raise ValueError(f"unknown wavefunction format: {path}")

    @classmethod
    def read_wfn(cls, path: str) -> "Wavefunction":
        """AIMPAC .wfn reader (reference read_wfn,
        src/wfn_private@proc.F90:484-...)."""
        import re

        with open(path) as fh:
            lines = fh.read().splitlines()
        m = re.search(r"(\d+)\s+MOL ORBITALS\s+(\d+)\s+PRIMITIVES\s+(\d+)\s+NUCLEI",
                      lines[1])
        if not m:
            raise ValueError("bad .wfn header")
        nmo, npri, nat = (int(v) for v in m.groups())
        atpos = np.zeros((nat, 3))
        atz = np.zeros(nat, dtype=int)
        iline = 2
        for i in range(nat):
            ln = lines[iline + i]
            mm = re.search(r"\)\s*([-\d.DEde+]+)\s+([-\d.DEde+]+)\s+"
                           r"([-\d.DEde+]+)\s+CHARGE\s*=\s*([-\d.DEde+]+)", ln)
            atpos[i] = [float(v.replace("D", "E")) for v in mm.groups()[:3]]
            atz[i] = int(float(mm.group(4).replace("D", "E")))
        iline += nat

        def read_ints(tag):
            nonlocal iline
            vals = []
            while iline < len(lines) and lines[iline].lstrip().startswith(tag):
                vals.extend(int(v) for v in
                            re.findall(r"(\d+)", lines[iline].split(tag)[1]))
                iline += 1
            return np.asarray(vals, dtype=np.int32)

        icenter = read_ints("CENTRE ASSIGNMENTS")
        itype = read_ints("TYPE ASSIGNMENTS")
        expos = []
        while iline < len(lines) and lines[iline].lstrip().startswith("EXPONENTS"):
            expos.extend(float(v.replace("D", "E")) for v in
                         re.findall(r"[-\d.]+[DEde][-+]\d+",
                                    lines[iline]))
            iline += 1
        e = np.asarray(expos)
        if not (len(icenter) == len(itype) == len(e) == npri):
            raise ValueError("inconsistent .wfn primitive data")

        occ = np.zeros(nmo)
        cmo = np.zeros((nmo, npri))
        imo = -1
        vals = []
        for ln in lines[iline:]:
            if ln.startswith("MO") or "OCC NO" in ln:
                if imo >= 0:
                    cmo[imo, :] = vals[:npri]
                mm = re.search(r"OCC NO\s*=\s*([-\d.DEde+]+)", ln)
                if mm is None:
                    break
                imo += 1
                occ[imo] = float(mm.group(1).replace("D", "E"))
                vals = []
            elif ln.strip().startswith("END DATA"):
                if imo >= 0:
                    cmo[imo, :] = vals[:npri]
                break
            else:
                vals.extend(float(v.replace("D", "E")) for v in
                            re.findall(r"[-\d.]+[DEde][-+]\d+", ln))
        return cls(atpos=atpos, atz=atz, icenter=icenter - 1, itype=itype,
                   e=e, cmo=cmo, occ=occ, source=path)

    @classmethod
    def read_wfx(cls, path: str) -> "Wavefunction":
        """AIM .wfx reader (reference read_wfx,
        src/wfn_private@proc.F90:588-913), including the EDF core
        density block of ECP wavefunctions."""
        import re

        with open(path) as fh:
            text = fh.read()

        def tag(name, dtype=float):
            m = re.search(rf"<{re.escape(name)}>(.*?)</{re.escape(name)}>",
                          text, re.S)
            if m is None:
                return None
            body = m.group(1)
            body = re.sub(r"<MO Number>.*?</MO Number>", " ", body, flags=re.S)
            vals = body.replace("D", "E").replace("d", "E").split()
            return np.asarray([dtype(v) for v in vals])

        nat = int(tag("Number of Nuclei", int)[0])
        atz = tag("Atomic Numbers", int)
        atpos = tag("Nuclear Cartesian Coordinates").reshape(nat, 3)
        icenter = tag("Primitive Centers", int)
        itype = tag("Primitive Types", int)
        e = tag("Primitive Exponents")
        occ = tag("Molecular Orbital Occupation Numbers")
        coefs = tag("Molecular Orbital Primitive Coefficients")
        nmo = len(occ)
        npri = len(e)
        cmo = coefs.reshape(nmo, npri)
        kw = {}
        edf_e = tag("EDF Primitive Exponents")
        if edf_e is not None and len(edf_e):
            kw = dict(
                edf_icenter=tag("EDF Primitive Centers",
                                int).astype(np.int32) - 1,
                edf_itype=tag("EDF Primitive Types",
                              int).astype(np.int32),
                edf_e=edf_e,
                edf_c=tag("EDF Primitive Coefficients"))
        return cls(atpos=atpos, atz=atz.astype(int),
                   icenter=icenter.astype(np.int32) - 1,
                   itype=itype.astype(np.int32), e=e, cmo=cmo, occ=occ,
                   source=path, **kw)

    @classmethod
    def read_fchk(cls, path: str, readvirtual: bool = False) -> "Wavefunction":
        """Gaussian formatted-checkpoint reader (reference read_fchk,
        src/wfn_private@proc.F90:920-1436)."""
        ints = {}
        arrays = {}
        with open(path) as fh:
            lines = fh.read().splitlines()
        i = 0
        while i < len(lines):
            ln = lines[i]
            if len(ln) > 47 and ln[43] == "I" and "N=" not in ln:
                ints[ln[:40].strip()] = int(ln.split()[-1])
                i += 1
                continue
            if "N=" in ln and len(ln) > 47 and ln[43] in "IR":
                name = ln[:40].strip()
                n = int(ln.split()[-1])
                kind = ln[43]
                perline = 5 if kind == "R" else 6
                nlines = (n + perline - 1) // perline
                vals = []
                i += 1
                for _ in range(nlines):
                    vals.extend(lines[i].split())
                    i += 1
                arrays[name] = (np.asarray(vals, dtype=float) if kind == "R"
                                else np.asarray(vals, dtype=int))
                continue
            if len(ln) > 47 and ln[43] == "R" and "N=" not in ln:
                try:
                    ints[ln[:40].strip()] = float(ln.split()[-1])
                except ValueError:
                    pass
            i += 1

        nelec = ints["Number of electrons"]
        nalpha = ints["Number of alpha electrons"]
        uhf = "Beta Orbital Energies" in arrays
        nat = ints["Number of atoms"]
        atz = arrays["Atomic numbers"].astype(int)
        atpos = arrays["Current cartesian coordinates"].reshape(nat, 3)

        ishlt = arrays["Shell types"].astype(int)
        ishlpri = arrays["Number of primitives per shell"].astype(int)
        ishlat = arrays["Shell to atom map"].astype(int)
        exppri = arrays["Primitive exponents"]
        ccontr = arrays["Contraction coefficients"]
        pccontr = arrays.get("P(S=P) Contraction coefficients")
        nbassph = ints["Number of basis functions"]

        if uhf:
            nmoocc = nelec
            occ = np.ones(nmoocc)
        else:
            if nelec % 2:
                raise ValueError("odd electron count for RHF fchk")
            nmoocc = nelec // 2
            occ = np.full(nmoocc, 2.0)

        amo = arrays["Alpha MO coefficients"].reshape(-1, nbassph)
        if uhf:
            bmo = arrays["Beta MO coefficients"].reshape(-1, nbassph)
            mo_sph = np.concatenate([amo[:nalpha], bmo[:nelec - nalpha]])
        else:
            mo_sph = amo[:nmoocc]

        # unfold SP (l = -1) shells into s + p
        sh_l, sh_at, sh_exp, sh_cc = [], [], [], []
        ip = 0
        for s in range(len(ishlt)):
            npr = ishlpri[s]
            ee = exppri[ip:ip + npr]
            cc = ccontr[ip:ip + npr]
            if ishlt[s] == -1:
                pc = pccontr[ip:ip + npr]
                sh_l.append(0); sh_at.append(ishlat[s])
                sh_exp.append(ee); sh_cc.append(cc)
                sh_l.append(1); sh_at.append(ishlat[s])
                sh_exp.append(ee); sh_cc.append(pc)
            else:
                sh_l.append(int(ishlt[s])); sh_at.append(ishlat[s])
                sh_exp.append(ee); sh_cc.append(cc)
            ip += npr

        icenter, itype, e, cmo = _shells_to_primitives(
            sh_l, sh_at, sh_exp, sh_cc, mo_sph)
        return cls(atpos=atpos, atz=atz, icenter=icenter, itype=itype,
                   e=e, cmo=cmo, occ=occ,
                   wfntyp="uhf" if uhf else "rhf", nalpha=nalpha,
                   source=path)

    @classmethod
    def read_molden(cls, path: str) -> "Wavefunction":
        """Molden file reader (reference read_molden,
        src/wfn_private@proc.F90:1438-1870): [Atoms], [GTO] with s/p/sp/
        d/f/g shells, [MO] blocks; [5D]/[7F]/[5D10F]/[5D7F]/[9G]
        spherical flags."""
        import re

        from .. import param

        with open(path, errors="replace") as fh:
            text = fh.read()
        low = text.lower()

        # spherical flags (reference read_molden tag parsing,
        # src/wfn_private@proc.F90:1618-1632)
        d_sph = "[5d" in low or "[5d]" in low
        f_sph = ("[7f]" in low or "[5d7f]" in low
                 or ("[5d]" in low and "[5d10f]" not in low))
        g_sph = "[9g]" in low

        def section(name):
            m = re.search(rf"\[{name}\][^\n]*\n(.*?)(?=\n\s*\[|\Z)", text,
                          re.S | re.I)
            return m.group(1) if m else None

        # atoms
        m = re.search(r"\[Atoms\]\s*(\S*)", text, re.I)
        unit = (m.group(1) or "").lower() if m else ""
        toang = unit.startswith("angs")
        atoms = section("Atoms")
        if atoms is None:
            raise ValueError("no [Atoms] section in molden file")
        atz, atpos = [], []
        for ln in atoms.splitlines():
            t = ln.split()
            if len(t) < 6:
                continue
            atz.append(int(t[2]))
            xyz = np.array([float(v) for v in t[3:6]])
            if toang:
                xyz = xyz * param.ANGSTROM_TO_BOHR
            atpos.append(xyz)
        atz = np.asarray(atz, dtype=int)
        atpos = np.asarray(atpos)

        # GTO shells
        gto = section("GTO")
        if gto is None:
            raise ValueError("no [GTO] section in molden file")
        sh_l, sh_at, sh_exp, sh_cc = [], [], [], []
        lmap = {"s": 0, "p": 1, "d": 2, "f": 3, "g": 4}
        lines = iter(gto.splitlines())
        cur_atom = None
        for ln in lines:
            t = ln.split()
            if not t:
                cur_atom = None
                continue
            if cur_atom is None:
                cur_atom = int(t[0])
                continue
            typ = t[0].lower()
            if typ in lmap or typ == "sp":
                npr = int(t[1])
                ee, cc, pc = [], [], []
                for _ in range(npr):
                    row = next(lines).replace("D", "E").replace(
                        "d", "e").split()
                    ee.append(float(row[0]))
                    cc.append(float(row[1]))
                    if typ == "sp":
                        pc.append(float(row[2]))
                if typ == "sp":
                    sh_l.append(0); sh_at.append(cur_atom)
                    sh_exp.append(np.asarray(ee)); sh_cc.append(np.asarray(cc))
                    sh_l.append(1); sh_at.append(cur_atom)
                    sh_exp.append(np.asarray(ee)); sh_cc.append(np.asarray(pc))
                else:
                    l = lmap[typ]
                    sph = (d_sph if l == 2 else f_sph if l == 3
                           else g_sph if l == 4 else False)
                    sh_l.append(-l if (sph and l >= 2) else l)
                    sh_at.append(cur_atom)
                    sh_exp.append(np.asarray(ee))
                    sh_cc.append(np.asarray(cc))

        nbas = sum(_NSHLT_SPH[abs(l)] if l < -1 else _NSHLT_CAR[abs(l)]
                   for l in sh_l)

        # MOs
        mo = section("MO")
        if mo is None:
            raise ValueError("no [MO] section in molden file")
        occs, coefs, spins = [], [], []
        cur = None
        for ln in mo.splitlines():
            st = ln.strip()
            lowln = st.lower()
            if lowln.startswith(("sym=", "ene=")):
                continue
            if lowln.startswith("spin="):
                spins.append(lowln.split("=")[1].strip())
                continue
            if lowln.startswith("occup="):
                occs.append(float(st.split("=")[1]))
                cur = np.zeros(nbas)
                coefs.append(cur)
                continue
            t = st.split()
            if len(t) >= 2 and cur is not None:
                cur[int(t[0]) - 1] = float(t[1].replace("D", "E"))

        occs = np.asarray(occs)
        keep = occs > 1e-12
        mo_sph = np.stack([c for c, k in zip(coefs, keep) if k])
        occ = occs[keep]
        uhf = any(s.startswith("beta") for s in spins)

        icenter, itype, e, cmo = _shells_to_primitives(
            sh_l, sh_at, sh_exp, sh_cc, mo_sph, order="molden")
        return cls(atpos=atpos, atz=atz, icenter=icenter, itype=itype,
                   e=e, cmo=cmo, occ=occ,
                   wfntyp="uhf" if uhf else "rhf", source=path)
