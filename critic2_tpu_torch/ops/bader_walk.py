"""The near-grid Bader walk: the CUDA kernel's wrapper and its plain
version.

Every grid point walks uphill by the near-grid rule (Tang, Sanville and
Henkelman 2009; critic2 src/bader@proc.f90 max_neargrid/step_neargrid)
until it stops, and its attractor is where it stops:

  * bader_walk (csrc/bader_walk.cu): one thread walks one point to its
    end; a tensor on a CUDA device takes it, float32 or float64;
  * neargrid_walk_plain: the same walk as batched PyTorch steps, blocks of
    `walk_block` walkers that take WALK_SEGMENT steps between two reads
    of the host, arrived walkers leaving the set after each; a CPU tensor
    takes it.

A near-grid step onto a point the walker stood on in its last WALK_MEMORY
steps takes the on-grid step in its place, dr reset (critic2 falls back
so on any point of the trajectory, src/bader@proc.f90:422-427; at its
first step a walker counts as coming from p - (1, 1, 1), as in the JAX
package, whose guard is this one with a memory of 1). Both stop a walker
that has not arrived after `maxiter` steps rounded up to whole segments
where it stands, and give the same roots bit for bit
(the kernel repeats _neargrid_step's arithmetic operation for operation).
`launches` counts kernel launches. Each walk counts into the program's
record (utils/trace.py): `bader.blocks` (a launch or a block of walkers),
`bader.segments` (reads of the host: none in the kernel),
`bader.walker_steps` (the steps the walk computed: each walker's own in
the kernel, live walkers times WALK_SEGMENT a segment in the plain
version), `bader.capped` (walkers stopped at the cap) and `host_syncs`.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import trace
from . import _ext

__all__ = ["neargrid_walk", "neargrid_walk_plain", "bader_walk",
           "launches", "WALK_SEGMENT"]

WALK_SEGMENT = 16          # near-grid steps between two reads of `done`
WALK_MEMORY = 8            # the last points a walker does not step back onto
launches = {"bader_walk": 0}


def _steps(maxiter: int) -> int:
    """The cap: maxiter rounded up to whole segments."""
    return -(-int(maxiter) // WALK_SEGMENT) * WALK_SEGMENT


def neargrid_walk(rho, G, offs, invd, maxiter: int,
                  walk_block: int = 1 << 21):
    """Attractor flat index of every point of the grid `rho` (n1, n2, n3),
    (N,) int64 on its device.

    G: the direct-coordinate gradient operator (3 x 3 nested floats);
    offs: the 26 neighbour offsets (-1, 0, 1)^3 \\ 0 in lexicographic order,
    (26, 3) ints; invd: 1 / their Cartesian lengths, (26,) floats."""
    if rho.device.type == "cpu":
        return neargrid_walk_plain(rho, G, offs, invd, maxiter, walk_block)
    return bader_walk(rho, G, invd, maxiter)


def bader_walk(rho, G, invd, maxiter: int):
    """The walk by the CUDA kernel; see neargrid_walk."""
    if not rho.is_cuda:
        raise ValueError("bader_walk: rho must be on a CUDA device (CPU "
                         "tensors take the plain version)")
    if rho.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"bader_walk: float32 or float64 only, got "
                        f"{rho.dtype}")
    if rho.dim() != 3 or min(rho.shape) < 2 or not rho.is_contiguous() \
            or rho.numel() >= 1 << 31:
        raise ValueError("bader_walk: rho must be a contiguous (n1, n2, n3) "
                         "grid, each n >= 2, of fewer than 2^31 points, got "
                         f"{tuple(rho.shape)}")
    lib = _ext.load("bader_walk")
    fn = lib.bader_walk_f32 if rho.dtype == torch.float32 \
        else lib.bader_walk_f64
    dp = ctypes.POINTER(ctypes.c_double)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, dp, dp, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    g = np.ascontiguousarray(np.asarray(G, dtype=np.float64).reshape(9))
    w = np.ascontiguousarray(np.asarray(invd, dtype=np.float64).reshape(26))
    n1, n2, n3 = (int(v) for v in rho.shape)
    roots = torch.empty(n1 * n2 * n3, dtype=torch.int64, device=rho.device)
    counts = torch.zeros(2, dtype=torch.int64, device=rho.device)
    with torch.cuda.device(rho.device):
        err = fn(rho.data_ptr(), n1, n2, n3, g.ctypes.data_as(dp),
                 w.ctypes.data_as(dp), _steps(maxiter), WALK_MEMORY,
                 roots.data_ptr(),
                 counts.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"bader_walk: CUDA kernel launch failed with "
                           f"CUDA error {err}")
    launches["bader_walk"] += 1
    trace.count("bader.blocks")
    trace.count("bader.segments", 0)
    trace.count_device("bader.walker_steps", counts, 0)
    trace.count_device("bader.capped", counts, 1)
    return roots


def _stencil(f_flat, shape, p, around):
    """f on the 27 grid points p + (-1, 0, 1)^3 with pbc, (B, 27), in the
    lexicographic order of the offsets (`around` = arange(-1, 2))."""
    n1, n2, n3 = shape
    x = torch.remainder(p[:, 0:1] + around, n1) * (n2 * n3)
    y = torch.remainder(p[:, 1:2] + around, n2) * n3
    z = torch.remainder(p[:, 2:3] + around, n3)
    return f_flat[(x[:, :, None, None] + y[:, None, :, None]
                   + z[:, None, None, :]).reshape(-1, 27)]


def _flat(p, shape):
    """Flat grid index of the points p (B, 3), wrapped into the grid."""
    n1, n2, n3 = shape
    return (torch.remainder(p[:, 0], n1) * (n2 * n3)
            + torch.remainder(p[:, 1], n2) * n3
            + torch.remainder(p[:, 2], n3))


def _walkers(order, shape, dtype):
    """The state of walkers starting on the flat points `order`: position,
    dr, the flat points of their last WALK_MEMORY steps (-1: none yet;
    the first as if they came from p - (1, 1, 1)), done."""
    n1, n2, n3 = shape
    p = torch.stack([order // (n2 * n3), (order // n3) % n2, order % n3], -1)
    seen = torch.full((len(order), WALK_MEMORY), -1, dtype=torch.int64,
                      device=order.device)
    seen[:, 0] = _flat(p - 1, shape)
    return (p, torch.zeros(p.shape, dtype=dtype, device=order.device), seen,
            torch.zeros(len(order), dtype=torch.bool, device=order.device))


def _neargrid_step(state, f_flat, G, offs, invd, shape, around):
    p, dr, seen, done = state
    v = _stencil(f_flat, shape, p, around)
    c = v.view(-1, 3, 3, 3)
    f0 = c[:, 1, 1, 1]
    # the +1 and -1 neighbours along each axis (views: no index tensor to
    # copy to the device)
    fp = torch.stack([c[:, 2, 1, 1], c[:, 1, 2, 1], c[:, 1, 1, 2]], -1)
    fm = torch.stack([c[:, 0, 1, 1], c[:, 1, 0, 1], c[:, 1, 1, 0]], -1)
    glat = 0.5 * (fp - fm)
    glat = torch.where((fp < f0[:, None]) & (fm < f0[:, None]),
                       torch.zeros_like(glat), glat)
    # gdir = glat @ G.T as three products summed in a fixed order, so the
    # rint below sees the same rounding on every device
    gdir = torch.stack([glat[:, 0] * G[i][0] + glat[:, 1] * G[i][1]
                        + glat[:, 2] * G[i][2] for i in range(3)], -1)
    gmax = gdir.abs().max(dim=1).values
    flat = gmax < 1e-30

    nbr = torch.cat([v[:, :13], v[:, 14:]], 1)        # (B, 26), as offs
    ismax26 = ~(nbr > f0[:, None]).any(-1)   # reference is_max (26 nbrs)

    g = gdir / torch.clamp(gmax, min=1e-300)[:, None]
    rg = torch.round(g)
    pm_g = p + rg.to(torch.int64)
    dr_g = dr + g - rg
    rdr = torch.round(dr_g)
    pm_g = pm_g + rdr.to(torch.int64)
    dr_g = dr_g - rdr

    # the on-grid step: to the neighbour of the steepest rise (the first of
    # equals), none where no neighbour is higher
    best, k = ((nbr - f0[:, None]) * invd[None, :]).max(dim=1)
    pm_o = torch.where((best > 0.0)[:, None], p + offs[k], p)

    use_o = flat & ~ismax26
    # visited-point guard: a near-grid step onto a point of the last
    # WALK_MEMORY steps takes the on-grid step in its place, dr reset
    back = (seen == _flat(pm_g, shape)[:, None]).any(-1)
    grid = use_o | back
    pm = torch.where(grid[:, None], pm_o, pm_g)
    zero = torch.zeros_like(dr_g)
    drn = torch.where((flat | grid)[:, None], zero, dr_g)

    newdone = done | (flat & ismax26) | (pm == p).all(-1)
    pm = torch.where(newdone[:, None], p, pm)
    drn = torch.where(newdone[:, None], zero, drn)
    seen = torch.cat([_flat(p, shape)[:, None], seen[:, :-1]], 1)
    return pm, drn, seen, newdone


def neargrid_walk_plain(rho, G, offs, invd, maxiter: int,
                        walk_block: int = 1 << 21):
    """The walk as batched PyTorch steps on any device; see neargrid_walk.
    Each block's walkers are independent, so the roots do not depend on
    `walk_block`."""
    shape = tuple(int(s) for s in rho.shape)
    N = shape[0] * shape[1] * shape[2]
    dev = rho.device
    f_flat = rho.reshape(-1)
    trace.count("host_syncs", 2)    # offs, invd: pageable copies
    offs = torch.as_tensor(np.asarray(offs), dtype=torch.int64, device=dev)
    invd = torch.as_tensor(np.asarray(invd), dtype=rho.dtype, device=dev)
    around = torch.arange(-1, 2, device=dev)
    cap = _steps(maxiter)

    roots = torch.empty(N, dtype=torch.int64, device=dev)
    for lo in range(0, N, walk_block):
        trace.count("bader.blocks")
        order = torch.arange(lo, min(N, lo + walk_block), device=dev)
        state = _walkers(order, shape, rho.dtype)
        for _ in range(0, cap, WALK_SEGMENT):
            if not len(order):
                break
            trace.count("bader.segments")
            trace.count("bader.walker_steps", len(order) * WALK_SEGMENT)
            for _ in range(WALK_SEGMENT):
                state = _neargrid_step(state, f_flat, G, offs, invd, shape,
                                       around)
            trace.count("host_syncs")
            gone = torch.nonzero(state[3]).reshape(-1)
            if len(gone):              # arrived walkers leave the set
                trace.count("host_syncs")
                keep = torch.nonzero(~state[3]).reshape(-1)
                roots[order[gone]] = _flat(state[0][gone], shape)
                order = order[keep]
                state = tuple(v[keep] for v in state)
        trace.count("bader.capped", len(order))
        if len(order):
            roots[order] = _flat(state[0], shape)
    return roots
