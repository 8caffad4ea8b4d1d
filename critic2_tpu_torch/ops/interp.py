"""Batched periodic grid interpolation on the device (PyTorch).

Replacement for the reference's per-point interpolators
(src/grid3mod@proc.f90: grinterp_nearest :1633, grinterp_trilinear :1651,
grinterp_tricubic :1978). All functions take a batch of fractional
coordinates and return value / gradient / Hessian for the whole batch;
gradients are in fractional coordinates scaled by the grid size (reference
convention, src/grid3mod@proc.f90:2133-2140), the Cartesian rotation
happens in the field layer.

The tricubic interpolant: the reference uses the Lekien-Marsden 64x64
matrix with corner derivatives estimated by central differences. That
construction is *exactly* the separable tensor-product cubic-convolution
(Catmull-Rom) interpolant - the tensor polynomial satisfies all 64 LM
constraints and the LM system is nonsingular - so it is evaluated axis by
axis: 3x4 basis weights and a 4x4x4 stencil contraction per point, instead
of a 64x64 matvec.

Layout: the hot entry points are batch-LAST ("structure of arrays"):
points (3, N), gradient (3, N), Hessian as the six components
(xx, yy, zz, xy, xz, yz) in a (6, N) array, so every elementwise op runs
over contiguous batch vectors. `interp_batch` keeps the (N, ...)
convention for host-facing callers and wraps interp_soa.

Three routes to the tricubic interpolant, same numbers from each:
  interp_soa       scattered points, one 64-element stencil gather a point
  interp_soa_rows  scattered points, 16 whole-row gathers a point, chunked
  interp_grid_soa  a regular output grid, three separable 1-D passes
"""
from __future__ import annotations

import torch

from .eig3 import SYM6  # noqa: F401  (the (6, N) component order)

__all__ = ["interp_batch", "interp_soa", "interp_soa_rows",
           "interp_grid_soa", "eval_at_nodes", "sym6_to_mat", "mat_to_sym6",
           "SYM6"]


def _catmull_rom_weights(t):
    """Catmull-Rom basis weights over stencil offsets (-1, 0, 1, 2).

    t: (...,) fractional position in the base cell, in [0, 1).
    Returns (w, dw, d2w): each (..., 4).
    """
    t2 = t * t
    t3 = t2 * t
    w = torch.stack(
        [
            0.5 * (-t3 + 2.0 * t2 - t),
            0.5 * (3.0 * t3 - 5.0 * t2 + 2.0),
            0.5 * (-3.0 * t3 + 4.0 * t2 + t),
            0.5 * (t3 - t2),
        ],
        dim=-1,
    )
    dw = torch.stack(
        [
            0.5 * (-3.0 * t2 + 4.0 * t - 1.0),
            0.5 * (9.0 * t2 - 10.0 * t),
            0.5 * (-9.0 * t2 + 8.0 * t + 1.0),
            0.5 * (3.0 * t2 - 2.0 * t),
        ],
        dim=-1,
    )
    d2w = torch.stack(
        [
            0.5 * (-6.0 * t + 4.0),
            0.5 * (18.0 * t - 10.0),
            0.5 * (-18.0 * t + 8.0),
            0.5 * (6.0 * t - 2.0),
        ],
        dim=-1,
    )
    return w, dw, d2w


def _linear_weights(t):
    w = torch.stack([1.0 - t, t], dim=-1)
    dw = torch.stack([-torch.ones_like(t), torch.ones_like(t)], dim=-1)
    return w, dw


def _axis2(g, w):
    """Contract stencil axis 2 of g (a, b, k, N) with w (k, N) -> (a, b, N)."""
    return (g * w[None, None, :, :]).sum(2)


def _axes01(a, wa, wb):
    """Contract axes 0, 1 of a (ka, kb, N) with wa (ka, N), wb (kb, N)."""
    return (a * (wa[:, None, :] * wb[None, :, :])).sum((0, 1))


def _base_cell(f, xT):
    """Wrap xT (3, N) to the main cell and split into the base node index
    i0 (3, N) int64 and the position t (3, N) in [0, 1) within its cell.
    x - floor(x) can round to exactly 1, so i0 can equal n: every stencil
    index downstream goes through a non-negative modulus."""
    n = torch.tensor(f.shape, dtype=f.dtype, device=f.device)
    x = xT - torch.floor(xT)  # wrap to [0,1), reference interp :1052
    xg = x * n[:, None]
    fl = torch.floor(xg)
    return fl.to(torch.int64), xg - fl, n


def _gather_stencil_soa(f, i0T, offsets):
    """Batch-last stencil gather.

    f: (n1, n2, n3) grid; i0T: (3, N) int64 base indices; offsets: (k,)
    int64. Returns (k, k, k, N).
    """
    k = len(offsets)
    i = torch.remainder(i0T[0][None, :] + offsets[:, None], f.shape[0])
    j = torch.remainder(i0T[1][None, :] + offsets[:, None], f.shape[1])
    l = torch.remainder(i0T[2][None, :] + offsets[:, None], f.shape[2])
    flat = (i[:, None, None, :] * (f.shape[1] * f.shape[2])
            + j[None, :, None, :] * f.shape[2]
            + l[None, None, :, :])                               # (k,k,k,N)
    return torch.take(f.reshape(-1), flat.reshape(-1)).reshape(
        k, k, k, flat.shape[-1])


def _scaled(n, gx, gy, gz, h=None):
    """Stack the derivative components with the reference's scaling:
    yp_i by n_i, ypp_ij by n_i n_j (src/grid3mod@proc.f90:2133-2140)."""
    yp = torch.stack([gx, gy, gz]) * n[:, None]
    if h is None:
        return yp, None
    nn = torch.stack([n[0] * n[0], n[1] * n[1], n[2] * n[2],
                      n[0] * n[1], n[0] * n[2], n[1] * n[2]])
    return yp, torch.stack(h) * nn[:, None]


def _tricubic_contract(a0, a1, a2, t, n, nder):
    """x/y contraction of the z-contracted stencils a0 (weights), a1
    (first derivative), a2 (second derivative), each (4, 4, N)."""
    w1, d1, s1 = (a.T for a in _catmull_rom_weights(t[0]))   # each (4,N)
    w2, d2, s2 = (a.T for a in _catmull_rom_weights(t[1]))
    y = _axes01(a0, w1, w2)
    if nder < 1:
        return y, None, None
    gx = _axes01(a0, d1, w2)
    gy = _axes01(a0, w1, d2)
    gz = _axes01(a1, w1, w2)
    if nder < 2:
        return (y,) + _scaled(n, gx, gy, gz)
    h = [_axes01(a0, s1, w2), _axes01(a0, w1, s2), _axes01(a2, w1, w2),
         _axes01(a0, d1, d2), _axes01(a1, d1, w2), _axes01(a1, w1, d2)]
    return (y,) + _scaled(n, gx, gy, gz, h)


def _zero_fill(y, yp, ypp6):
    """Derivative orders that were not asked for come back as zeros."""
    N = y.shape[0]
    if yp is None:
        yp = torch.zeros((3, N), dtype=y.dtype, device=y.device)
    if ypp6 is None:
        ypp6 = torch.zeros((6, N), dtype=y.dtype, device=y.device)
    return y, yp, ypp6


def interp_soa(f, xfracT, mode: str = "tricubic", nder: int = 2):
    """Batch-last interpolation: xfracT is (3, N) fractional coords.

    Returns (y (N,), ypT (3, N), ypp6 (6, N)) with ypp6 in SYM6 component
    order; derivatives are d/d(frac) scaled by n per axis (reference
    convention, src/grid3mod@proc.f90:2133-2140).
    """
    xT = xfracT.to(f.dtype)
    dev = f.device

    if mode == "nearest":
        n = torch.tensor(f.shape, dtype=f.dtype, device=dev)
        x = xT - torch.floor(xT)
        idx = torch.remainder(
            torch.round(x * n[:, None]).to(torch.int64),
            torch.tensor(f.shape, dtype=torch.int64, device=dev)[:, None])
        y = torch.take(f.reshape(-1), idx[0] * (f.shape[1] * f.shape[2])
                       + idx[1] * f.shape[2] + idx[2])
        return _zero_fill(y, None, None)

    i0, t, n = _base_cell(f, xT)

    if mode == "trilinear":
        g = _gather_stencil_soa(f, i0, torch.arange(0, 2, device=dev))
        w1, d1 = (a.T for a in _linear_weights(t[0]))        # (2,N)
        w2, d2 = (a.T for a in _linear_weights(t[1]))
        w3, d3 = (a.T for a in _linear_weights(t[2]))
        a0 = _axis2(g, w3)
        y = _axes01(a0, w1, w2)
        if nder < 1:
            return _zero_fill(y, None, None)
        a1 = _axis2(g, d3)
        yp, _ = _scaled(n, _axes01(a0, d1, w2), _axes01(a0, w1, d2),
                        _axes01(a1, w1, w2))
        return _zero_fill(y, yp, None)

    if mode != "tricubic":
        raise ValueError(f"unknown interpolation mode {mode}")

    g = _gather_stencil_soa(f, i0, torch.arange(-1, 3, device=dev))
    w3, d3, s3 = (a.T for a in _catmull_rom_weights(t[2]))
    # contract axis z first (separable Catmull-Rom)
    a0 = _axis2(g, w3)
    a1 = _axis2(g, d3) if nder >= 1 else None
    a2 = _axis2(g, s3) if nder >= 2 else None
    return _zero_fill(*_tricubic_contract(a0, a1, a2, t, n, nder))


def interp_soa_rows(f, xfracT, nder: int = 2, chunk: int = 8192):
    """Tricubic interpolation for scattered points via whole-row gathers.

    Same contract and results as interp_soa(mode="tricubic"), with the
    memory access restructured: each point gathers its 16 whole (x, y)
    rows along z (contiguous n3-vectors) and takes the four wrapped z
    columns of its stencil out of them; the x/y contraction is shared
    with interp_soa. Points are processed in `chunk` blocks to bound the
    (chunk, 16, n3) row buffer. Moves n3/4 times the bytes of the minimal
    stencil but reads them as contiguous rows.
    """
    n1, n2, n3 = f.shape
    frows = f.reshape(n1 * n2, n3)
    xT = xfracT.to(f.dtype)
    N = xT.shape[1]
    offs = torch.arange(-1, 3, device=f.device)

    outs = []
    for lo in range(0, max(N, 1), chunk):
        xcT = xT[:, lo:lo + chunk]
        C = xcT.shape[1]
        i0, t, n = _base_cell(f, xcT)
        xi = torch.remainder(i0[0][:, None] + offs[None, :], n1)   # (C, 4)
        yj = torch.remainder(i0[1][:, None] + offs[None, :], n2)
        ridx = xi[:, :, None] * n2 + yj[:, None, :]                # (C, 4, 4)
        rows = frows.index_select(0, ridx.reshape(-1)).reshape(C, 16, n3)
        pos = torch.remainder(i0[2][:, None] + offs[None, :], n3)  # (C, 4)
        st = torch.gather(rows, 2, pos[:, None, :].expand(C, 16, 4))
        del rows
        w3, d3, s3 = _catmull_rom_weights(t[2])                    # (C, 4)

        def zcontract(w):                                  # -> [i, j, C]
            return (st * w[:, None, :]).sum(-1).T.reshape(4, 4, C)

        a0 = zcontract(w3)
        a1 = zcontract(d3) if nder >= 1 else None
        a2 = zcontract(s3) if nder >= 2 else None
        outs.append(_zero_fill(*_tricubic_contract(a0, a1, a2, t, n, nder)))
    if len(outs) == 1:
        return outs[0]
    return (torch.cat([o[0] for o in outs]),
            torch.cat([o[1] for o in outs], dim=1),
            torch.cat([o[2] for o in outs], dim=1))


def interp_grid_soa(f, nout, origin=(0.0, 0.0, 0.0),
                    lengths=(1.0, 1.0, 1.0), nder: int = 2):
    """Tricubic evaluation on a REGULAR output grid, separable fast path.

    The hot workloads (NCI boxes, cube maps, supersampled property grids)
    evaluate on regular grids; there the 4^3 stencil factorizes into three
    1-D passes of 4 whole-plane index_selects + weighted sums per axis:
    4 multiply-adds per output per pass, coarse-grained memory access.

    f: (n1, n2, n3); nout: (m1, m2, m3) output shape; output node x_a =
    origin_a + i/m_a * lengths_a (fractional). Returns (y (m...),
    yp (3, m...), ypp6 (6, m...)) in the same derivative conventions as
    interp_soa. Weights are built in float64 and cast to f's dtype.
    """
    n = f.shape
    m1, m2, m3 = (int(v) for v in nout)
    dev = f.device

    def axis_weights(a, m):
        """Per output index along axis a: the four wrapped input indices
        (m, 4) and the weights for value, first and second derivative."""
        xg = (float(origin[a]) + torch.arange(m, device=dev).to(torch.float64)
              / m * float(lengths[a])) * n[a]
        xg = xg - torch.floor(xg / n[a]) * n[a]
        fl = torch.floor(xg)
        w, d, s = _catmull_rom_weights(xg - fl)                   # (m, 4)
        idx = torch.remainder(
            fl.to(torch.int64)[:, None]
            + torch.arange(-1, 3, device=dev)[None, :], n[a])
        return ((idx, w.to(f.dtype)), (idx, (d * n[a]).to(f.dtype)),
                (idx, (s * n[a] * n[a]).to(f.dtype)))

    W1, D1, S1 = axis_weights(0, m1)
    W2, D2, S2 = axis_weights(1, m2)
    W3, D3, S3 = axis_weights(2, m3)

    def take(arr, axis, M):
        idx, wt = M
        shape = [1, 1, 1]
        shape[axis] = -1
        out = None
        for tt in range(4):
            term = arr.index_select(axis, idx[:, tt]) \
                * wt[:, tt].reshape(shape)
            out = term if out is None else out.add_(term)
        return out

    zeros = lambda k: torch.zeros((k, m1, m2, m3), dtype=f.dtype,  # noqa: E731
                                  device=dev)

    aw = take(f, 0, W1)
    aww = take(aw, 1, W2)                   # (m1, m2, n3)
    y = take(aww, 2, W3)
    if nder < 1:
        return y, zeros(3), zeros(6)

    ad = take(f, 0, D1)
    awd = take(aw, 1, D2)
    adw = take(ad, 1, W2)
    yp = torch.stack([take(adw, 2, W3), take(awd, 2, W3),
                      take(aww, 2, D3)])
    if nder < 2:
        return y, yp, zeros(6)

    ypp6 = torch.empty((6, m1, m2, m3), dtype=f.dtype, device=dev)
    ypp6[2] = take(aww, 2, S3)
    del aww
    ypp6[4] = take(adw, 2, D3)
    del adw
    ypp6[5] = take(awd, 2, D3)
    del awd
    ypp6[3] = take(take(ad, 1, D2), 2, W3)
    del ad
    ypp6[1] = take(take(aw, 1, S2), 2, W3)
    del aw
    ypp6[0] = take(take(take(f, 0, S1), 1, W2), 2, W3)
    return y, yp, ypp6


def sym6_to_mat(h6):
    """(6, N) SYM6 components -> (N, 3, 3) full matrices (host-facing)."""
    xx, yy, zz, xy, xz, yz = h6
    return torch.stack(
        [torch.stack([xx, xy, xz], -1),
         torch.stack([xy, yy, yz], -1),
         torch.stack([xz, yz, zz], -1)], dim=-2)


def mat_to_sym6(h):
    """(N, 3, 3) symmetric matrices -> (6, N) SYM6 components."""
    return torch.stack([h[..., 0, 0], h[..., 1, 1], h[..., 2, 2],
                        h[..., 0, 1], h[..., 0, 2], h[..., 1, 2]])


def interp_batch(f, xfrac, mode: str = "tricubic", nder: int = 2):
    """Batch-first wrapper over interp_soa for host-facing callers.

    xfrac (N, 3) -> (y (N,), yp (N, 3), ypp (N, 3, 3)).
    """
    y, ypT, ypp6 = interp_soa(f, xfrac.T, mode=mode, nder=nder)
    return y, ypT.T, sym6_to_mat(ypp6)


def eval_at_nodes(f, idx):
    """Exact node values at integer grid indices idx (N,3) (the nder==0
    near-grid shortcut of reference grd, src/fieldmod@proc.f90:728-737)."""
    idx = torch.remainder(
        idx, torch.tensor(f.shape, dtype=torch.int64, device=f.device))
    return f[idx[:, 0], idx[:, 1], idx[:, 2]]
