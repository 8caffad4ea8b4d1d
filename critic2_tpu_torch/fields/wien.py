"""WIEN2k files: the .struct reader.

Role of the reference's wien_read_struct and rotdef
(src/wien_private@proc.f90:476-733, :945-1050). The port carries only
`read_struct`, which the WIEN2k structure reader needs; the LAPW density
field (clmsum) waits for queue 1 item 4 of the roadmap.
"""
from __future__ import annotations

import math

import numpy as np


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
