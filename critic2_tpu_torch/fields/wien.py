"""WIEN2k LAPW density evaluator (struct + clmsum files).

Reference behavior: src/wien_private.f90:61-70 with the implementation
src/wien_private@proc.f90 - read_clmsum (:146), rho2 (:174),
wien_read_struct (:476), readslm (:733), readk (:802), rotdef (:945),
gener (:1060), sternb (:1085), charge (:1291), radial (:1523), rhoout
(:1619). The field is a muffin-tin decomposition: inside atomic spheres
rho = sum_lm rho_lm(r) * S_lm(x^), with rho_lm on a logarithmic radial
grid and S_lm real (lattice/cubic) harmonics; in the interstitial
rho = sum_K s_K exp(2*pi*i K.x) over symmetry stars.

Design:
  - All file parsing, symmetry assignment (rotdef), star expansion
    (sternb) and cubic-harmonics folding (Kara & Kurki-Suonio c_kub
    pairs/triples) happen once on the host into dense per-atom-type
    tables: combined radial coefficient rows (T, jri) and an angular
    matrix A (T, (lmax+1)^2) over real solid harmonics, moved to the
    device.
  - Muffin-tin evaluation is batched over points: one (T, nY) x (nY, N)
    matmul for the angular part (ops/rlm.solid_harmonics), a 4-node
    gather + Lagrange combination on the log radial grid for the radial
    part (the reference `radial` node scheme for the value).
  - The interstitial is a waves-by-points phase matmul + cos/sin
    contraction, evaluated in point blocks so the (K, N) phase matrix
    stays bounded.
  - Gradients and Hessians come from autograd through the same smooth
    evaluation chain (one backward pass for the gradient, one per
    gradient row for the Hessian, as ghost fields take theirs); they are
    the exact derivatives of the interpolant. `grd` returns the Hessian
    rows in the order [xx, xy, xz, yy, yz, zz]; Field reorders them to
    the package's [xx, yy, zz, xy, xz, yz].
  - Per equivalent atom the whole symmetry chain (rotator/rotato/reduc/
    rotat) collapses to one constant 3x3 local map M applied to the
    nearest-image displacement; M is precomputed on the host.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..config import FDTYPE, resolve_device

LMAX2 = 14          # max l in the LM expansion (reference lmax2)
_SQFP = math.sqrt(4.0 * math.pi)
_PWCUT = 1e-30
# module Hessian rows [xx, xy, xz, yy, yz, zz] from the package's
# [xx, yy, zz, xy, xz, yz], and back
MODULE_FROM_SYM6 = [0, 3, 4, 1, 5, 2]
SYM6_FROM_MODULE = [0, 3, 5, 1, 2, 4]
# elements of a (K, N) phase matrix a point block may hold
PHASE_ELEMENTS = 1 << 27


def _c_kub() -> np.ndarray:
    """Kara & Kurki-Suonio cubic-harmonic coefficients
    (reference src/param.F90:629-653)."""
    c = np.zeros((LMAX2 + 1, LMAX2 + 1))
    c[0, 0] = 1.0
    c[3, 2] = 1.0
    c[4, 0] = 0.5 * math.sqrt(7.0 / 3.0)
    c[4, 4] = 0.5 * math.sqrt(5.0 / 3.0)
    c[6, 0] = 0.5 * math.sqrt(0.5)
    c[6, 2] = 0.25 * math.sqrt(11.0)
    c[6, 4] = -0.5 * math.sqrt(7.0 / 2.0)
    c[6, 6] = -0.25 * math.sqrt(5.0)
    c[7, 2] = 0.5 * math.sqrt(13.0 / 6.0)
    c[7, 6] = 0.5 * math.sqrt(11.0 / 6.0)
    c[8, 0] = 0.125 * math.sqrt(33.0)
    c[8, 4] = 0.25 * math.sqrt(7.0 / 3.0)
    c[8, 8] = 0.125 * math.sqrt(65.0 / 3.0)
    c[9, 2] = 0.25 * math.sqrt(3.0)
    c[9, 4] = 0.5 * math.sqrt(17.0 / 6.0)
    c[9, 6] = -0.25 * math.sqrt(13.0)
    c[9, 8] = -0.5 * math.sqrt(7.0 / 6.0)
    c[10, 0] = 0.125 * math.sqrt(65.0 / 6.0)
    c[10, 2] = 0.125 * math.sqrt(247.0 / 6.0)
    c[10, 4] = -0.25 * math.sqrt(11.0 / 2.0)
    c[10, 6] = 0.0625 * math.sqrt(19.0 / 3.0)
    c[10, 8] = -0.125 * math.sqrt(187.0 / 6.0)
    c[10, 10] = -0.0625 * math.sqrt(85.0)
    return c


def lapw_derivs(rho, x, nder: int, block: int):
    """Value, gradient (3, N) and Hessian (6, N) rows [xx, xy, xz, yy,
    yz, zz] of the batched density closure rho: vT (3, n) -> (n,) at
    Cartesian points x (N, 3), by autograd in point blocks of `block`
    (the WIEN2k and elk evaluators). nder 0 gives (f, None, None) and
    nder 1 (f, g, None)."""
    from .field import _ghost_derivs

    fs, gs, hs = [], [], []
    for lo in range(0, x.shape[0], block):
        f, g, h6 = _ghost_derivs(rho, x[lo:lo + block].T, nder)
        fs.append(f)
        gs.append(g)
        hs.append(h6[MODULE_FROM_SYM6])
    f = torch.cat(fs)
    if nder <= 0:
        return f, None, None
    g = torch.cat(gs, dim=1)
    return f, g, (torch.cat(hs, dim=1) if nder >= 2 else None)


def _f(s: str) -> float:
    s = s.strip()
    return float(s) if s else 0.0


def _i(s: str) -> int:
    s = s.strip()
    return int(s) if s else 0


# ---------------------------------------------------------------------
# struct file
# ---------------------------------------------------------------------

def read_struct(path: str) -> dict:
    """Parse a WIEN2k .struct file (reference wien_read_struct fixed
    formats, src/wien_private@proc.f90:476-733)."""
    lines = open(path, errors="replace").read().splitlines()
    out = {}
    out["title"] = lines[0]
    lattic = lines[1][0:4]
    out["lattic"] = lattic
    nat = _i(lines[1][27:30])
    out["nat"] = nat
    out["ishlat"] = lattic.startswith("H")
    # line 2 (mode of calc) skipped by the reference's format
    a = np.array([_f(lines[3][i * 10:(i + 1) * 10]) for i in range(3)])
    ang = np.array([_f(lines[3][(3 + i) * 10:(4 + i) * 10])
                    for i in range(3)])
    if ang[2] == 0.0:
        ang[2] = 90.0
    out["a"], out["angles"] = a, ang
    ca, cb, cg = np.cos(np.deg2rad(ang))
    sa, sb, sg = np.sin(np.deg2rad(ang))

    br1 = np.zeros((3, 3))
    br2 = np.zeros((3, 3))
    ortho = False
    L = lattic[0]
    if L in ("S", "P"):
        cosg1 = (cg - ca * cb) / (sa * sb)
        g0 = math.acos(min(1.0, max(-1.0, cosg1)))
        br2[0, 0] = a[0] * math.sin(g0) * sb
        br2[0, 1] = a[0] * math.cos(g0) * sb
        br2[0, 2] = a[0] * cb
        br2[1, 1] = a[1] * sa
        br2[1, 2] = a[1] * ca
        br2[2, 2] = a[2]
        br1 = br2.copy()
        ortho = np.allclose(ang, 90.0)
    elif L == "F":
        br2[0, 0] = 0.5 * a[0]
        br2[1, 0] = 0.5 * a[0]
        br2[1, 1] = 0.5 * a[1]
        br2[2, 1] = 0.5 * a[1]
        br2[0, 2] = 0.5 * a[2]
        br2[2, 2] = 0.5 * a[2]
        br1 = np.diag(a)
        ortho = True
    elif L == "B":
        br2 = 0.5 * np.array([[-a[0], a[1], a[2]],
                              [a[0], -a[1], a[2]],
                              [a[0], a[1], -a[2]]])
        br1 = np.diag(a)
        ortho = True
    elif L == "H":
        br1[0, 0] = math.sqrt(3.0) / 2.0 * a[0]
        br1[0, 1] = -0.5 * a[1]
        br1[1, 1] = a[1]
        br1[2, 2] = a[2]
        br2 = br1.copy()
        ortho = False
    elif L == "R":
        s3 = math.sqrt(3.0)
        br1[0] = [a[0] / s3 / 2.0, -0.5 * a[1], a[2] / 3.0]
        br1[1] = [a[0] / s3 / 2.0, 0.5 * a[1], a[2] / 3.0]
        br1[2] = [-a[0] / s3, 0.0, a[2] / 3.0]
        br2 = br1.copy()
        ortho = False
    elif lattic[:3] == "CXY":
        br2[0, 0] = 0.5 * a[0]
        br2[1, 0] = 0.5 * a[0]
        br2[0, 1] = 0.5 * a[1]
        br2[1, 1] = -0.5 * a[1]
        br2[2, 2] = a[2]
        br1 = np.diag(a)
        ortho = True
    elif lattic[:3] == "CYZ":
        br2[0, 0] = a[0]
        br2[1, 1] = -0.5 * a[1]
        br2[2, 1] = 0.5 * a[1]
        br2[1, 2] = 0.5 * a[2]
        br2[2, 2] = 0.5 * a[2]
        br1 = np.diag(a)
        ortho = True
    elif lattic[:3] == "CXZ":
        br2[0, 0] = 0.5 * a[0] * sg
        br2[0, 1] = 0.5 * a[0] * cg
        br2[0, 2] = -0.5 * a[2]
        br2[1, 1] = a[1]
        br2[2, 0] = 0.5 * a[0] * sg
        br2[2, 1] = 0.5 * a[0] * cg
        br2[2, 2] = 0.5 * a[2]
        br1[0, 0] = a[0] * sg
        br1[0, 1] = a[0] * cg
        br1[1, 1] = a[1]
        br1[2, 2] = a[2]
        ortho = False
    else:
        raise ValueError(f"unknown WIEN lattice type {lattic!r}")
    out["br1"], out["br2"], out["ortho"] = br1, br2, ortho
    out["br3"] = np.linalg.inv(br1)

    # atoms
    idx = 4
    pos, iatnr = [], []
    multw = np.zeros(nat, dtype=int)
    jri = np.zeros(nat, dtype=int)
    rnot = np.zeros(nat)
    rmt = np.zeros(nat)
    znuc = np.zeros(nat)
    rotloc = np.zeros((nat, 3, 3))
    names = []
    for jatom in range(nat):
        ln = lines[idx]
        iatnr.append(_i(ln[4:8]))
        pos.append([_f(ln[12:22]), _f(ln[25:35]), _f(ln[38:48])])
        idx += 1
        multw[jatom] = _i(lines[idx][15:17])
        idx += 1
        for _ in range(multw[jatom] - 1):
            ln = lines[idx]
            iatnr.append(_i(ln[4:8]))
            pos.append([_f(ln[12:22]), _f(ln[25:35]), _f(ln[38:48])])
            idx += 1
        ln = lines[idx]
        names.append(ln[0:10].strip())
        jri[jatom] = _i(ln[15:20])
        rnot[jatom] = _f(ln[25:35])
        rmt[jatom] = _f(ln[40:50])
        znuc[jatom] = _f(ln[55:60])
        idx += 1
        for j in range(3):      # 1051: each line is COLUMN j of rotloc
            ln = lines[idx]
            for i in range(3):
                rotloc[jatom, i, j] = _f(ln[20 + 10 * i:30 + 10 * i])
            idx += 1
    out["pos_frac"] = np.asarray(pos)
    out["iatnr"] = np.asarray(iatnr, dtype=int)
    out["multw"], out["jri"] = multw, jri
    out["rnot"], out["rmt"], out["znuc"] = rnot, rmt, znuc
    out["rotloc"], out["names"] = rotloc, names
    out["dx"] = np.log(rmt / rnot) / (jri - 1)

    # symmetry operations (iz columns per file record, like the
    # reference's implied-do read order)
    niord = _i(lines[idx][0:4])
    idx += 1
    iz = np.zeros((niord, 3, 3), dtype=int)
    tau = np.zeros((niord, 3))
    for op in range(niord):
        for j in range(3):
            ln = lines[idx]
            for i in range(3):
                iz[op, i, j] = _i(ln[2 * i:2 * i + 2])
            tau[op, j] = _f(ln[6:16])
            idx += 1
        idx += 1                # op index line
    out["niord"], out["iz"], out["tau"] = niord, iz, tau

    out["iop"] = _rotdef(out)
    out["pos_cart"] = out["pos_frac"] @ br1      # v_i = sum_j br1[j,i] x_j
    return out


def _rotdef(st: dict) -> np.ndarray:
    """Per equivalent atom: index of the symmetry op mapping it onto the
    first atom of its class (reference rotdef,
    src/wien_private@proc.f90:945-1050)."""
    toler = 1e-4
    lattic = st["lattic"]
    pos = st["pos_frac"]
    iop = np.zeros(len(pos), dtype=int)
    index = 0
    for jatom in range(st["nat"]):
        first = index
        for _ in range(st["multw"][jatom]):
            p = pos[index]
            found = False
            for i in range(st["niord"]):
                x = st["iz"][i].T @ p + st["tau"][i]
                x = np.mod(x + toler / 2.0 + 5.0, 1.0) - toler / 2.0
                d = np.abs(x - pos[first])
                d = np.minimum(d, np.abs(d - 1.0))
                shifts = [np.zeros(3)]
                if lattic[0] == "B":
                    shifts.append(np.array([0.5, 0.5, 0.5]))
                if lattic[0] == "F" or lattic[:3] == "CXY":
                    shifts.append(np.array([0.5, 0.5, 0.0]))
                if lattic[0] == "F" or lattic[:3] == "CXZ":
                    shifts.append(np.array([0.5, 0.0, 0.5]))
                if lattic[0] == "F" or lattic[:3] == "CYZ":
                    shifts.append(np.array([0.0, 0.5, 0.5]))
                for sh in shifts:
                    ds = np.mod(d + sh + 1e-9, 1.0)
                    ds = np.minimum(ds, np.abs(ds - 1.0))
                    if np.all(ds < toler):
                        iop[index] = i
                        found = True
                        break
                if found:
                    break
            if not found:
                raise ValueError(
                    f"rotdef: no symmetry op maps atom {index} onto its "
                    "class representative")
            index += 1
    return iop


# ---------------------------------------------------------------------
# clmsum file
# ---------------------------------------------------------------------

def read_clmsum(path: str, st: dict) -> dict:
    """Parse the clmsum: MT lm radial tables + plane-wave part
    (reference readslm/readk, src/wien_private@proc.f90:733-918)."""
    lines = open(path, errors="replace").read().splitlines()
    pos = 3                              # FORMAT(//) skips 3 records
    nat = st["nat"]
    lmlist, slm = [], []
    for jatom in range(nat):
        jrj = int(st["jri"][jatom])
        pos += 1                         # leading / of format 118
        ll = _i(lines[pos][15:18])
        pos += 3                         # the read line + trailing //
        lms = []
        tab = np.zeros((ll, jrj))
        for l in range(ll):
            l1 = _i(lines[pos][15:18])
            l2 = _i(lines[pos][23:25])
            pos += 2                     # read line + trailing /
            lms.append((l1, l2))
            vals = []
            nlines = (jrj + 3) // 4
            for k in range(nlines):
                ln = lines[pos + k]
                for c in range(4):
                    s = ln[3 + 19 * c:3 + 19 * (c + 1)]
                    if s.strip():
                        vals.append(float(s.replace("D", "E")))
            pos += nlines
            tab[l, :] = np.asarray(vals[:jrj])
            pos += 2                     # FORMAT(/) skips 2 records
            if l == 0:
                tab[0] /= _SQFP         # density normalization (cnorm)
        pos += 4                         # FORMAT(///) skips 4 records
        lmlist.append(lms)
        slm.append(tab)

    # plane waves: FORMAT(//,13X,I6)
    pos += 2
    nwav = _i(lines[pos][13:19])
    pos += 1
    k2 = np.zeros((nwav, 3), dtype=int)
    sk = np.zeros(nwav)
    ski = np.zeros(nwav)
    cmpl = False
    for i in range(nwav):
        ln = lines[pos + i]
        k2[i] = [_i(ln[3 + 5 * j:8 + 5 * j]) for j in range(3)]
        sk[i] = float(ln[18:37].replace("D", "E"))
        s2 = ln[37:56].strip()
        ski[i] = float(s2.replace("D", "E")) if s2 else 0.0
        if abs(ski[i]) > _PWCUT:
            cmpl = True
    return {"lmlist": lmlist, "slm": slm, "k2": k2, "sk": sk,
            "ski": ski, "cmpl": cmpl, "nwav": nwav}


def _expand_stars(st: dict, pw: dict):
    """Symmetry-star expansion of the plane-wave list (reference
    sternb + readk postprocessing, src/wien_private@proc.f90:860-918).

    Returns (krec (K,3) float, a_re (K,), a_im (K,)) such that
    rho_I(v) = sum_K a_re cos(2 pi phi) - a_im sin(2 pi phi), with
    phi = krec . (v scaled by 1/a for ortho lattices, cartesian else).
    """
    iz, tau, niord = st["iz"], st["tau"], st["niord"]
    krec_l, are_l, aim_l = [], [], []
    for iw in range(pw["nwav"]):
        k1 = pw["k2"][iw]
        istg = np.einsum("oij,j->oi", iz, k1)           # row J: iz@k1
        tk = 2.0 * math.pi * (tau @ k1)
        # dedup members, averaging phases over coincident images
        uniq: dict[tuple, list] = {}
        for o in range(niord):
            key = tuple(int(v) for v in istg[o])
            uniq.setdefault(key, []).append(tk[o])
        nst = len(uniq)
        s_re = pw["sk"][iw] / nst
        s_im = pw["ski"][iw] / nst
        if abs(s_re) < _PWCUT and abs(s_im) < _PWCUT:
            continue
        for key, tks in uniq.items():
            taup = float(np.mean(np.cos(tks)))
            taupi = float(np.mean(np.sin(tks))) if pw["cmpl"] else 0.0
            # roc = (s_re + i s_im)(taup + i taupi)
            are_l.append(s_re * taup - s_im * taupi)
            aim_l.append(s_re * taupi + s_im * taup)
            krec_l.append(np.asarray(key, dtype=float))
    krec = np.asarray(krec_l) if krec_l else np.zeros((0, 3))
    if not st["ortho"] and len(krec):
        krec = krec @ st["br3"]          # krec_j = sum_i br3[i,j] k_i
    return krec, np.asarray(are_l), np.asarray(aim_l)


def _fold_terms(st: dict, pw: dict, jatom: int):
    """Fold the LM list (with Kara-Kurki-Suonio cubic pairs/triples for
    iatnr > 0, reference charge :1291-1521) into dense (T, jri) radial
    rows and (T, nY) angular coefficient rows over real solid
    harmonics S_lm (ops/rlm ordering: per l, m = -l..l)."""
    first = int(np.sum(st["multw"][:jatom]))
    cubic = st["iatnr"][first] > 0
    lms = pw["lmlist"][jatom]
    tab = pw["slm"][jatom]
    ck = _c_kub()
    nY = (LMAX2 + 1) ** 2

    def yidx(l: int, m_signed: int) -> int:
        return l * l + l + m_signed

    def ang_entry(l1: int, m: int) -> tuple[int, int]:
        """(l, signed m index) of the real harmonic for LM entry
        (l1, m): l1 >= 0 -> cosine (+m), l1 < 0 -> sine (-m)."""
        l = abs(l1)
        return l, (m if l1 >= 0 else -m) if m != 0 else 0

    rad_rows, ang_rows, lpow = [], [], []

    def add_term(radial, pieces):
        row = np.zeros(nY)
        l0 = None
        for (l1, m), cc in pieces:
            l, ms = ang_entry(l1, m)
            row[yidx(l, ms)] += cc
            l0 = l
        rad_rows.append(radial)
        ang_rows.append(row)
        lpow.append(l0)

    i = 0
    while i < len(lms):
        l1, m = lms[i]
        if not cubic:
            add_term(tab[i], [((l1, m), 1.0)])
            i += 1
            continue
        if l1 == 0 and m == 0:
            add_term(tab[i], [((0, 0), 1.0)])
            i += 1
        elif l1 == -3 and m == 2:
            add_term(tab[i], [((-3, 2), 1.0)])
            i += 1
        elif l1 in (4, 6, -7, -9):
            c1 = ck[abs(l1), m]
            c2 = ck[abs(l1), m + 4]
            rad = c1 * tab[i] + c2 * tab[i + 1]
            add_term(rad, [((l1, m), c1), ((l1, m + 4), c2)])
            i += 2
        elif l1 in (8, 10):
            c1, c2, c3 = ck[l1, m], ck[l1, m + 4], ck[l1, m + 8]
            rad = c1 * tab[i] + c2 * tab[i + 1] + c3 * tab[i + 2]
            add_term(rad, [((l1, m), c1), ((l1, m + 4), c2),
                           ((l1, m + 8), c3)])
            i += 3
        else:
            raise ValueError(
                f"invalid LM list for cubic structure: l={l1} m={m}")
    return (np.asarray(rad_rows), np.asarray(ang_rows),
            np.asarray(lpow, dtype=int))


def lagrange4(rc, r1):
    """Weights (N, 4) of the 4-node Lagrange interpolant at rc (N,) over
    the nodes r1 (N, 4): smooth in rc, so autograd differentiates it."""
    dr = rc[:, None] - r1
    w = []
    for a in range(4):
        num = 1.0
        for b in range(4):
            if b != a:
                num = num * dr[:, b] / (r1[:, a] - r1[:, b])
        w.append(num)
    return torch.stack(w, dim=1)


def nearest_sphere(vT, pos_cart, P, Pinv, rmt_of):
    """Nearest-image sphere assignment of Cartesian points vT (3, N)
    over atoms at pos_cart (nd, 3) with lattice columns P: (iat (N,),
    displacement d0 (3, N) to that atom, r (N,), inside (N,) bool). The
    lattice wrap is detached: integer shifts carry no derivative."""
    d = vT[None, :, :] - pos_cart[:, :, None]                # (nd,3,N)
    f = torch.einsum("ij,ajn->ain", Pinv, d)
    f = f - torch.round(f.detach())
    dc = torch.einsum("ij,ajn->ain", P, f)                  # (nd,3,N)
    r2 = (dc * dc).sum(1)                                   # (nd,N)
    iat = torch.argmin(r2 - (rmt_of ** 2)[:, None], dim=0)
    r = torch.sqrt(r2.gather(0, iat[None, :])[0] + 1e-300)
    inside = r < rmt_of[iat]
    d0 = dc.gather(0, iat[None, None, :].expand(1, 3, dc.shape[2]))[0]
    return iat, d0, r, inside


# ---------------------------------------------------------------------
# the field
# ---------------------------------------------------------------------

class WienField:
    """Batched LAPW density evaluator on a device.

    grd(points_cart, nder) evaluates rho (and derivatives by autograd)
    at Cartesian bohr points in the WIEN frame (lattice vectors = rows
    of br1; a Crystal built by the .struct seed reader uses the same
    frame).
    """

    def __init__(self, st: dict, pw: dict, *, device=None):
        dev = resolve_device(device)

        def t(a):
            return torch.as_tensor(np.asarray(a, dtype=float), dtype=FDTYPE,
                                   device=dev)

        self.st = st
        self.cmpl = pw["cmpl"]
        nat = st["nat"]
        # per-equivalent-atom data
        ndat = len(st["pos_frac"])
        jatom_of = np.concatenate(
            [np.full(st["multw"][j], j) for j in range(nat)])
        self.jatom_of = torch.as_tensor(jatom_of, dtype=torch.int64,
                                        device=dev)
        self.pos_cart = t(st["pos_cart"])
        # local map M = rotloc . (linear part of the symmetry op): for
        # ortho lattices iz acts directly on cartesian displacements,
        # else M = rotloc . br1^T . iz^T . br3 (reference rho2 `mat`)
        M = np.zeros((ndat, 3, 3))
        for iat in range(ndat):
            j = jatom_of[iat]
            izt = st["iz"][st["iop"][iat]].T.astype(float)
            if st["ortho"]:
                lin = izt
            else:
                lin = st["br1"].T @ izt @ st["br3"]
            M[iat] = st["rotloc"][j] @ lin
        self.M = t(M)

        # primitive lattice (rows of br2 are the primitive vectors):
        # v_cart = br2^T @ n  for integer n
        self.P = t(st["br2"].T)
        self.Pinv = t(np.linalg.inv(st["br2"].T))

        self.rmt_of = t(st["rmt"][jatom_of])
        self.rnot = t(st["rnot"])
        self.jri = st["jri"]

        # muffin-tin tables per atom type
        terms = [_fold_terms(st, pw, j) for j in range(nat)]
        self.mt = []
        for j, (rad, angm, lpow) in enumerate(terms):
            lm = int(lpow.max())                 # trim unused harmonics
            self.mt.append({
                "CRT": t(rad.T),                 # (jri, T)
                "A": t(angm[:, :(lm + 1) ** 2]),
                "lmax": lm,
                "lpow": t(lpow),
                "rnot": float(st["rnot"][j]),
                "dx": float(st["dx"][j]),
                "jri": int(st["jri"][j]),
            })

        krec, a_re, a_im = _expand_stars(st, pw)
        self.krec = t(krec.reshape(-1, 3))
        self.a_re = t(a_re)
        self.a_im = t(a_im)
        factor = 1.0 / st["a"] if st["ortho"] else np.ones(3)
        self.factor = t(factor)
        self.block = max(1024, min(1 << 16, PHASE_ELEMENTS
                                   // max(len(a_re), 1)))
        self.zpsp = None

    @property
    def device(self) -> torch.device:
        return self.pos_cart.device

    @classmethod
    def from_files(cls, clmsum_path: str, struct_path: str, *,
                   device=None) -> "WienField":
        dev = resolve_device(device)
        st = read_struct(struct_path)
        pw = read_clmsum(clmsum_path, st)
        return cls(st, pw, device=dev)

    # -- components ----------------------------------------------------
    def _interstitial(self, vT):
        """rho_I at cartesian points vT (3, N) (reference rhoout)."""
        ph = (2.0 * math.pi) * (self.krec @ (vT * self.factor[:, None]))
        return (self.a_re @ torch.cos(ph)) - (self.a_im @ torch.sin(ph))

    def _mt_type(self, j: int, vtT, r):
        """MT density of atom type j at local coords vtT (3,N), radii
        r (N,) (reference charge/radial)."""
        from ..ops.rlm import solid_harmonics

        p = self.mt[j]
        rnot, dx, jri = p["rnot"], p["dx"], p["jri"]
        rc = torch.clamp(r, min=rnot)
        # 1-based ir = 1 + int(log(r/rnot)/dx), clamped to [2, jri-2];
        # nodes (1-based) temp_ir-1 .. temp_ir+2  ->  0-based ii0-1+k
        ir = torch.clamp(1 + torch.floor(torch.log(rc.detach() / rnot)
                                         / dx).to(torch.int64), 2, jri - 2)
        ii = (ir[:, None] - 2) + torch.arange(4, device=r.device)[None, :]
        r1 = rnot * torch.exp(ii.to(FDTYPE) * dx)             # (N,4)
        W = lagrange4(rc, r1)                                 # (N,4)
        cn = p["CRT"][ii]                                     # (N,4,T)
        g = torch.einsum("na,nat->nt", W / (r1 * r1), cn)     # rho_lm(r)
        # angular: S_lm(x^) = solid_lm(vt)/r^l
        S = solid_harmonics(vtT, p["lmax"])                   # (nY, N)
        ang = p["A"] @ S                                      # (T, N)
        rl = torch.exp(p["lpow"][:, None] * torch.log(rc)[None, :])
        return (g.T / rl * ang).sum(0)

    def _assign(self, vT):
        """Nearest-image sphere assignment: returns (iat (N,), d0 (3,N)
        displacement to that atom, r (N,), insphere (N,) bool)."""
        return nearest_sphere(vT, self.pos_cart, self.P, self.Pinv,
                              self.rmt_of)

    def rho(self, vT):
        """Density at cartesian points vT (3, N): branch-masked
        combination of MT and interstitial values (reference rho2)."""
        iat, d0, r, insphere = self._assign(vT)
        jat = self.jatom_of[iat]
        vt = torch.einsum("nij,jn->in", self.M[iat], d0)      # local frame
        out = torch.where(insphere, 0.0, self._interstitial(vT))
        for j in range(len(self.mt)):
            mask = insphere & (jat == j)
            # evaluate everywhere (dense); select by mask
            out = torch.where(mask, self._mt_type(j, vt, r), out)
        return out

    def grd(self, points_cart, nder: int = 2):
        """Evaluate (rho, grad (3,N), hess6 (6,N)) at (N,3) points, the
        Hessian rows in the order [xx, xy, xz, yy, yz, zz].

        At nuclear positions (r < rnot) the reference zeroes the
        gradient and sets the Hessian diagonal to -1e15 (nucleus
        signal); reproduced here at nder=2.
        """
        x = torch.atleast_2d(torch.as_tensor(points_cart, dtype=FDTYPE,
                                             device=self.device))
        f, gf, h6 = lapw_derivs(self.rho, x, nder, self.block)
        if nder < 2:
            return f, gf, h6
        # nuclear capture (reference charge :1506-1519)
        with torch.no_grad():
            iat, _, r, ins = self._assign(x.T)
            isnuc = ins & (r < self.rnot[self.jatom_of[iat]] + 1e-10)
        gf = torch.where(isnuc[None, :], 0.0, gf)
        diag = torch.tensor([-1e15, 0.0, 0.0, -1e15, 0.0, -1e15],
                            dtype=FDTYPE, device=self.device)[:, None]
        h6 = torch.where(isnuc[None, :], diag, h6)
        return f, gf, h6
