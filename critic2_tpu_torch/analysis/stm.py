"""STM images (Tersoff-Hamann approximation).

Role of the reference stm (src/stm@proc.f90:28-545): from the reference
field (usually a local DOS grid), produce constant-height (field value on
a plane) or constant-current (isodensity height by bisection) images over
the surface cell; auto-detect the vacuum position as the minimum-density
plane.

Decomposition: constant-height is one batched plane evaluation on the
device; constant-current runs the per-pixel bisection as a lockstep loop
of NHALVE halvings over a block of pixels on the device, with no read to
the host inside it: 40 halvings of a half-cell bracket leave it near
5e-13, far above the spacing of the floats, so no pixel settles early
and there is no done flag worth reading.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import FDTYPE, resolve_device

__all__ = ["stm", "STMResult"]

NHALVE = 40          # halvings of the reference's bisection


def _stm_bisect(fn, fx, fy, m, ztop, level):
    """Constant-current bisection for one pixel block: NHALVE halvings
    of [ztop - 0.5, ztop] (fractional z), the result the midpoint."""
    lo = torch.full_like(fx, ztop - 0.5)     # half a cell below vacuum
    hi = torch.full_like(fx, ztop)
    for _ in range(NHALVE):
        mid = 0.5 * (lo + hi)
        rmid = fn(m @ torch.stack([fx, fy, torch.remainder(mid, 1.0)]))[0]
        # density decreases toward vacuum (increasing z up to ztop):
        # if rho(mid) > level, the isosurface is above mid
        above = rmid > level
        lo, hi = torch.where(above, mid, lo), torch.where(above, hi, mid)
    return 0.5 * (lo + hi)


@dataclass
class STMResult:
    mode: str
    image: np.ndarray           # (nx, ny)
    extent: tuple               # cell-plane lengths (bohr)
    ztop: float                 # vacuum/reference fractional z
    value: float                # height (const current) or current level


def _detect_vacuum(field):
    """Fractional z of minimum plane-averaged density (reference
    detect_vacuum, src/stm@proc.f90:122)."""
    g = field.grid.f
    prof = g.mean(dim=(0, 1)).cpu().numpy()
    k = int(np.argmin(prof))
    return k / g.shape[2], float(prof[k])


def stm(system, mode: str = "current", level: float | None = None,
        npts=(96, 96), top: float | None = None, block: int = 1 << 14):
    """Compute an STM image from the reference field (grid required for
    vacuum detection; any field evaluates), on the system's device."""
    dev = resolve_device(system.device)
    f = system.ref
    c = system.crystal
    if f.type != "grid":
        raise ValueError("STM needs a grid reference field")
    if top is None:
        top, _ = _detect_vacuum(f)
    nx, ny = (int(v) for v in npts)

    fn = f.eval_fn(nder=0)
    m_np = np.asarray(c.m_x2c)
    m = torch.as_tensor(m_np, dtype=FDTYPE, device=dev)
    extent = (float(np.linalg.norm(m_np[:, 0])),
              float(np.linalg.norm(m_np[:, 1])))
    idx = torch.arange(nx * ny, device=dev)
    fx = (idx // ny).to(FDTYPE) / nx
    fy = (idx % ny).to(FDTYPE) / ny
    out = torch.empty(nx * ny, dtype=FDTYPE, device=dev)

    if mode == "height":
        z = top if level is None else level
        for lo in range(0, nx * ny, block):
            sl = slice(lo, lo + block)
            frac = torch.stack([fx[sl], fy[sl],
                                torch.full_like(fx[sl], float(z))])
            out[sl] = fn(m @ frac)[0]
        return STMResult(mode=mode, image=out.reshape(nx, ny).cpu().numpy(),
                         extent=extent, ztop=top, value=z)

    if mode != "current":
        raise ValueError(f"unknown STM mode {mode}")

    # constant current: for each pixel, find z in [zsurf, ztop] with
    # rho(z) == level, by bisection from the vacuum downward
    if level is None:
        g = f.grid.f.detach().cpu().numpy()
        level = float(np.percentile(g, 75)) * 1e-3 + g.mean() * 1e-3
        level = max(level, 1e-6)

    for lo in range(0, nx * ny, block):
        sl = slice(lo, lo + block)
        out[sl] = _stm_bisect(fn, fx[sl], fy[sl], m, float(top),
                              float(level))
    return STMResult(mode=mode, image=out.reshape(nx, ny).cpu().numpy(),
                     extent=extent, ztop=top, value=level)
