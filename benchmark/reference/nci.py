"""Plain reference of NCIPLOT on a periodic grid density (Johnson et al.,
JACS 132, 6498 (2010); critic2 src/nci@proc.f90), output grid = the
density's grid.

At each output node x_i = i / m (fractional, computed in float64), the
density, its gradient and Hessian come from critic2's tricubic
interpolant: the Lekien-Marsden cell with central-difference corner
derivatives, which is the tensor product of Catmull-Rom cubics, evaluated
here axis by axis. Then the Cartesian gradient and Hessian, the middle
eigenvalue by the trigonometric closed form (Smith, CACM 4, 168 (1961)),
sign(lambda_2) rho x 100, the reduced density gradient
s = |grad rho| / (2 (3 pi^2)^(1/3) rho^(4/3)) and critic2's default
cutoffs for a density (rhocut 0.2, dimcut 2.0, rhoplot 0.1).

`sweep_dtype` sets the precision of the interpolation; the rest runs in
float64, or in float32 when the sweep runs below float64.
"""
from __future__ import annotations

import math

import numpy as np
import torch

CONST = 2.0 * (3.0 * math.pi ** 2) ** (1.0 / 3.0)
RHOCUT, DIMCUT, RHOPLOT = 0.2, 2.0, 0.1
PLANES = 16          # output planes a block


def _axis(m: int, n: int, device):
    """Per output node along one axis: the 4 input indices (m, 4) and the
    Catmull-Rom weights of value, first and second derivative (per unit
    fractional coordinate), float64."""
    x = torch.arange(m, dtype=torch.float64, device=device) / m * n
    base = torch.floor(x)
    t = (x - base)[:, None]
    w = 0.5 * torch.cat([-t ** 3 + 2 * t ** 2 - t, 3 * t ** 3 - 5 * t ** 2 + 2,
                         -3 * t ** 3 + 4 * t ** 2 + t, t ** 3 - t ** 2], 1)
    d = 0.5 * torch.cat([-3 * t ** 2 + 4 * t - 1, 9 * t ** 2 - 10 * t,
                         -9 * t ** 2 + 8 * t + 1, 3 * t ** 2 - 2 * t], 1) * n
    s = 0.5 * torch.cat([-6 * t + 4, 18 * t - 10, -18 * t + 8, 6 * t - 2],
                        1) * n * n
    idx = (base.to(torch.int64)[:, None]
           + torch.arange(-1, 3, device=device)[None, :]) % n
    return idx, w, d, s


def _mid_eigenvalue(h):
    """Middle eigenvalue of symmetric 3x3 matrices given as a dict of the
    six components, by the trigonometric closed form."""
    q = (h["xx"] + h["yy"] + h["zz"]) / 3.0
    off = h["xy"] ** 2 + h["xz"] ** 2 + h["yz"] ** 2
    axx, ayy, azz = h["xx"] - q, h["yy"] - q, h["zz"] - q
    p = torch.sqrt((axx ** 2 + ayy ** 2 + azz ** 2 + 2.0 * off) / 6.0)
    safe = torch.where(p > 0, p, torch.ones_like(p))
    bxx, byy, bzz = axx / safe, ayy / safe, azz / safe
    bxy, bxz, byz = h["xy"] / safe, h["xz"] / safe, h["yz"] / safe
    det = (bxx * (byy * bzz - byz * byz) - bxy * (bxy * bzz - byz * bxz)
           + bxz * (bxy * byz - byy * bxz))
    phi = torch.acos(torch.clamp(det / 2.0, -1.0, 1.0)) / 3.0
    lmax = q + 2.0 * p * torch.cos(phi)
    lmin = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    return torch.where(p > 0, 3.0 * q - lmax - lmin, q)


def nci(rho, lattice_bohr, sweep_dtype=torch.float64) -> dict:
    """sign(lambda_2) rho x 100 and the RDG after the plot cutoffs on the
    density's own grid, as float64 (or float32) device tensors, and the
    count of points under the selection cutoffs."""
    dev = rho.device
    n1, n2, n3 = (int(v) for v in rho.shape)
    out_dt = torch.float64 if sweep_dtype == torch.float64 else torch.float32
    m_c2x = np.linalg.inv(np.asarray(lattice_bohr, dtype=float))
    M = torch.as_tensor(m_c2x, dtype=out_dt, device=dev)
    f = rho.to(sweep_dtype)
    i1, w1, d1, s1 = _axis(n1, n1, dev)
    i2, w2, d2, s2 = _axis(n2, n2, dev)
    i3, w3, d3, s3 = _axis(n3, n3, dev)
    cast = lambda *a: [v.to(sweep_dtype) for v in a]  # noqa: E731
    w1, d1, s1 = cast(w1, d1, s1)
    w2, d2, s2 = cast(w2, d2, s2)
    w3, d3, s3 = cast(w3, d3, s3)
    crho = torch.empty((n1, n2, n3), dtype=out_dt, device=dev)
    cgrad = torch.empty((n1, n2, n3), dtype=out_dt, device=dev)
    nsel = 0
    for a in range(0, n1, PLANES):
        b = min(n1, a + PLANES)
        blk = f[i1[a:b]]                                   # (c, 4, n2, n3)
        x = {k: torch.einsum("cqjz,cq->cjz", blk, wt[a:b])
             for k, wt in (("W", w1), ("D", d1), ("S", s1))}
        y = {}
        for k1, k2 in (("W", "W"), ("W", "D"), ("W", "S"), ("D", "W"),
                       ("D", "D"), ("S", "W")):
            wt = {"W": w2, "D": d2, "S": s2}[k2]
            y[k1 + k2] = torch.einsum("cjqz,jq->cjz", x[k1][:, i2], wt)
        del x
        z = {}
        for k12, k3 in (("WW", "W"), ("WW", "D"), ("WW", "S"), ("WD", "W"),
                        ("WD", "D"), ("WS", "W"), ("DW", "W"), ("DW", "D"),
                        ("DD", "W"), ("SW", "W")):
            wt = {"W": w3, "D": d3, "S": s3}[k3]
            z[k12 + k3] = torch.einsum("cjzq,zq->cjz", y[k12][:, :, i3],
                                       wt).to(out_dt)
        del y
        val = z["WWW"]
        gf = (z["DWW"], z["WDW"], z["WWD"])
        hf = [[z["SWW"], z["DDW"], z["DWD"]],
              [z["DDW"], z["WSW"], z["WDD"]],
              [z["DWD"], z["WDD"], z["WWS"]]]
        # Cartesian: g = M^T g_f, H = M^T H_f M (M = m_c2x)
        gc = [sum(M[p, a_] * gf[p] for p in range(3)) for a_ in range(3)]
        hc = {}
        for nm, (a_, b_) in (("xx", (0, 0)), ("yy", (1, 1)), ("zz", (2, 2)),
                             ("xy", (0, 1)), ("xz", (0, 2)), ("yz", (1, 2))):
            hc[nm] = sum(M[p, a_] * hf[p][q] * M[q, b_]
                         for p in range(3) for q in range(3))
        lam2 = _mid_eigenvalue(hc)
        floor = 1e-40 if out_dt == torch.float64 else 1e-30
        rdg = torch.sqrt(gc[0] ** 2 + gc[1] ** 2 + gc[2] ** 2) / (
            CONST * torch.clamp(val, min=floor) ** (4.0 / 3.0))
        cr = torch.sign(lam2) * val.abs() * 100.0
        sel = (cr.abs() < RHOCUT * 100.0) & (rdg < DIMCUT)
        nsel += int(sel.sum())
        crho[a:b] = cr
        cgrad[a:b] = torch.where(cr.abs() > RHOPLOT * 100.0,
                                 torch.full_like(rdg, 100.0), rdg)
    return {"crho": crho, "cgrad": cgrad, "ndat": nsel}
