"""Sharded grid-field evaluation: slab decomposition + halo exchange.

The workload the reference runs as an OpenMP loop over a shared-memory
grid (interpolation hot loops, src/grid3mod@proc.f90:1978-2143; property
accumulation, src/integration@proc.f90:949-1178) runs here over a
("space", "points") mesh (parallel/mesh.py):

  grid  : slab-sharded along axis 0 over "space"
  points: split over "points"

Each space shard takes one halo plane from its left neighbour and two
from its right (cyclic, so the periodic wrap is free), evaluates the
tricubic stencil for the points whose base plane it owns, and the
partial results are summed over "space" (each point has exactly one
owner). Weighted reductions (basin sums) then sum over "points".
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.eig3 import sym6_rotation
from ..ops.interp import _axes01, _axis2, _catmull_rom_weights, sym6_to_mat
from .mesh import halo_pad, psum

__all__ = ["sharded_eval_fn", "slab_tricubic"]


def slab_tricubic(slab_pad, xfracT, n_global, lo, nder: int = 2):
    """Tricubic interpolation against a padded slab, batch-last SoA.

    slab_pad: (m+3, n2, n3) local slab with halo planes [left1|slab|right2].
    xfracT: (3, N) fractional coords.
    n_global: (3,) full grid shape; lo: global index of slab row 0.
    Returns (y (N,), yp (3, N), ypp6 (6, N)); points whose base plane is
    outside [lo, lo+m) return zeros (their owner shard computes them) -
    combine with a sum over "space".
    """
    m = slab_pad.shape[0] - 3
    dt, dev = slab_pad.dtype, slab_pad.device
    n = torch.tensor([float(v) for v in n_global], dtype=dt, device=dev)
    x = xfracT.to(dt)
    x = x - torch.floor(x)
    xg = x * n[:, None]
    fl = torch.floor(xg)
    i0 = fl.to(torch.int64)
    t = xg - fl

    own = (i0[0] >= lo) & (i0[0] < lo + m)
    row = torch.clamp(i0[0] - lo, 0, m - 1) + 1            # padded-row base
    offs = torch.arange(-1, 3, device=dev)
    ridx = row[None, :] + offs[:, None]                     # (4, N)
    cidx = torch.remainder(i0[1][None, :] + offs[:, None], n_global[1])
    didx = torch.remainder(i0[2][None, :] + offs[:, None], n_global[2])
    n2, n3 = slab_pad.shape[1], slab_pad.shape[2]
    flat = (ridx[:, None, None, :] * (n2 * n3)
            + cidx[None, :, None, :] * n3
            + didx[None, None, :, :])                       # (4,4,4,N)
    g = torch.take(slab_pad.reshape(-1), flat.reshape(-1)).reshape(
        flat.shape)

    w1, d1, s1 = (a.T for a in _catmull_rom_weights(t[0]))
    w2, d2, s2 = (a.T for a in _catmull_rom_weights(t[1]))
    w3, d3, s3 = (a.T for a in _catmull_rom_weights(t[2]))
    a0 = _axis2(g, w3)
    y = _axes01(a0, w1, w2)
    N = xfracT.shape[1]
    yp = torch.zeros((3, N), dtype=dt, device=dev)
    ypp6 = torch.zeros((6, N), dtype=dt, device=dev)
    if nder >= 1:
        a1 = _axis2(g, d3)
        gx = _axes01(a0, d1, w2)
        gy = _axes01(a0, w1, d2)
        gz = _axes01(a1, w1, w2)
        yp = torch.stack([gx, gy, gz]) * n[:, None]
    if nder >= 2:
        a2 = _axis2(g, s3)
        hxx = _axes01(a0, s1, w2)
        hyy = _axes01(a0, w1, s2)
        hzz = _axes01(a2, w1, w2)
        hxy = _axes01(a0, d1, d2)
        hxz = _axes01(a1, d1, w2)
        hyz = _axes01(a1, w1, d2)
        nn = torch.stack([n[0] * n[0], n[1] * n[1], n[2] * n[2],
                          n[0] * n[1], n[0] * n[2], n[1] * n[2]])
        ypp6 = torch.stack([hxx, hyy, hzz, hxy, hxz, hyz]) * nn[:, None]
    mask = own.to(dt)
    return y * mask, yp * mask[None, :], ypp6 * mask[None, :]


def sharded_eval_fn(mesh, n_global, m_c2x, m_x2c, nder: int = 2):
    """Build a sharded evaluator.

    Returns fn(grid, points_cart, weights) -> (f (N,), gf (N, 3),
    hf (N, 3, 3), wsum) where the grid ((n1, n2, n3) tensor or array) is
    cut into slabs over "space", the points ((N, 3) Cartesian) and
    weights over "points", the outputs are gathered in point order on the
    first mesh device, and wsum = sum(weights * f) (the basin-reduction
    pattern).
    """
    nspace = mesh.shape["space"]
    npoints = mesh.shape["points"]
    if n_global[0] % nspace:
        raise ValueError(f"grid axis 0 ({n_global[0]}) not divisible by "
                         f"space axis ({nspace})")
    m = n_global[0] // nspace
    ng = tuple(int(v) for v in n_global)
    c2x = np.asarray(m_c2x, dtype=float)
    r6 = sym6_rotation(c2x)
    devs = mesh.devices
    dev0 = devs[0, 0]

    def fn(grid, points_cart, weights):
        g = torch.as_tensor(grid, device=dev0)
        dt = g.dtype
        pads = halo_pad([g[s * m:(s + 1) * m].to(devs[s, 0])
                         for s in range(nspace)], 1, 2)
        pts = torch.tensor_split(torch.as_tensor(points_cart, dtype=dt,
                                                 device=dev0), npoints)
        ws = torch.tensor_split(torch.as_tensor(weights, dtype=dt,
                                                device=dev0), npoints)
        fs, gfs, hfs, wsum = [], [], [], []
        for p in range(npoints):
            parts = []
            for s in range(nspace):
                d = devs[s, p]
                c2x_d = torch.as_tensor(c2x, dtype=dt, device=d)
                wxT = c2x_d @ pts[p].to(d).T
                wxT = wxT - torch.floor(wxT)
                parts.append(slab_tricubic(pads[s].to(d), wxT, ng, s * m,
                                           nder=nder))
            f = psum([q[0] for q in parts])
            d = f.device
            gf = (torch.as_tensor(c2x, dtype=dt, device=d).T
                  @ psum([q[1] for q in parts])).T
            h6 = torch.as_tensor(r6, dtype=dt, device=d) \
                @ psum([q[2] for q in parts])
            fs.append(f)
            gfs.append(gf)
            hfs.append(sym6_to_mat(h6))
            wsum.append((ws[p].to(d) * f).sum())
        return (torch.cat([x.to(dev0) for x in fs]),
                torch.cat([x.to(dev0) for x in gfs]),
                torch.cat([x.to(dev0) for x in hfs]), psum(wsum))

    return fn
