"""Plain reference of critic2's BADER near-grid assignment on a periodic
grid (Tang, Sanville and Henkelman, J. Phys.: Condens. Matter 21, 084204
(2009), section 2; critic2 src/bader@proc.f90 max_neargrid and
step_neargrid), with each basin's volume and charge.

The rule, for one grid point x that walks uphill from itself:

- g_lat, the central difference of the density along each grid axis,
  (rho(x + e_d) - rho(x - e_d)) / 2, set to 0 along an axis where x lies
  above both neighbours;
- g = G g_lat, the gradient in direct coordinates, G = C C^T with C the
  inverse of the grid's step matrix L (columns: the lattice vectors over
  the grid sizes); each row of G times g_lat is summed left to right;
- where max|g| is not 0: u = g / max|g|, the step is round(u) plus the
  rounded part of the carried correction dr + u - round(u), which keeps
  the rest (round half to even);
- where max|g| is 0 and x is not above its 26 neighbours: the on-grid
  step, to the neighbour of the largest (rho_k - rho(x)) / |L o_k|, the
  first of equals in the order of the offsets (-1, 0, 1)^3 taken
  lexicographically, or no step where none is larger; dr is reset;
- a near-grid step onto a point the walker stood on in its last MEMORY
  (8) steps takes the on-grid step in its place and resets dr; at its
  first step the walker counts as coming from x - (1, 1, 1);
- the walker stops where max|g| is 0 and no neighbour is higher, or
  where its step is 0; at 4 max(n) + 64 steps it stops where it stands.

Its attractor is where it stops. Basins are the distinct attractors in
ascending flat index (torch.unique); volumes and charges are sums in
float64 over each basin's points times V / N.

Departures from critic2's Fortran, as the port makes them: every point
walks on its own, so there is no shortcut into points already assigned,
no refine_edge pass and no dependence on the order of the scan; and the
guard against cycles remembers the walker's last 8 points, where
critic2's marks every point of the trajectory (its `known` array), so a
cycle of more than 8 points would run to the cap. On a
hexagonal grid lattice a component of u can be exactly 1/2 and two steps
can be of equal length, so L, C, G and the step lengths are formed by
the numpy operations the port uses: such ties are decided by their last
bit. Runs in the dtype it is given: float64 is the reference, float32 its
control.
"""
from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# walkers advanced together
BLOCK = 1 << 21
# the last points of its walk a walker does not take a near-grid step onto
MEMORY = 8
# the 27 points around x, as (-1, 0, 1)^3 in lexicographic order
STENCIL = np.array([(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                    for k in (-1, 0, 1)], dtype=np.int64)
CENTRE = 13
NEIGHBOURS = [s for s in range(27) if s != CENTRE]
# the stencil slots of x + e_d and x - e_d, d = 0, 1, 2
PLUS, MINUS = (22, 16, 14), (4, 10, 12)


def metric(lattice_bohr, shape):
    """(G as nested floats, 1 / |L o_k| for the 26 offsets)."""
    step = np.asarray(lattice_bohr, dtype=float) @ np.diag(
        1.0 / np.asarray(shape, dtype=float))
    c = np.linalg.inv(step)
    offs = STENCIL[NEIGHBOURS]
    return (c @ c.T).tolist(), 1.0 / np.linalg.norm(offs @ step.T, axis=1)


def _walk(f, shape, start, G, invd, maxiter):
    """Attractor flat index of each point in `start`, all walked together
    until every one has stopped."""
    dev = f.device
    n = torch.tensor(shape, device=dev)
    strides = (shape[1] * shape[2], shape[2], 1)
    around = torch.arange(-1, 2, device=dev)
    steps = torch.as_tensor(STENCIL[NEIGHBOURS], device=dev)   # (26, 3)
    p = torch.stack([start // strides[0], (start // strides[1]) % shape[1],
                     start % shape[2]], -1)

    def flat(q):
        return q[:, 0] * strides[0] + q[:, 1] * strides[1] + q[:, 2]

    # the flat points of the walker's last MEMORY steps, newest first
    seen = torch.full((len(start), MEMORY), -1, dtype=torch.int64,
                      device=dev)
    seen[:, 0] = flat(torch.remainder(p - 1, n))
    dr = torch.zeros(p.shape, dtype=f.dtype, device=dev)
    stopped = torch.zeros(len(start), dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=f.dtype, device=dev)
    for _ in range(maxiter):
        # the density on the 27 points around each walker, (B, 27)
        ax = [torch.remainder(p[:, a, None] + around, shape[a]) * strides[a]
              for a in range(3)]
        v = f[(ax[0][:, :, None, None] + ax[1][:, None, :, None]
               + ax[2][:, None, None, :]).reshape(len(p), 27)]
        v0 = v[:, CENTRE, None]
        fp, fm = v[:, list(PLUS)], v[:, list(MINUS)]             # (B, 3)
        glat = torch.where((fp < v0) & (fm < v0), zero, 0.5 * (fp - fm))
        g = torch.stack([glat[:, 0] * G[r][0] + glat[:, 1] * G[r][1]
                         + glat[:, 2] * G[r][2] for r in range(3)], -1)
        gmax = g.abs().max(-1).values
        level = gmax < 1e-30
        top = ~(v[:, NEIGHBOURS] > v0).any(-1)
        # the near-grid step
        u = g / torch.where(level, 1.0, gmax)[:, None]
        ru = torch.round(u)
        carry = dr + u - ru
        rc = torch.round(carry)
        near = p + ru.to(torch.int64) + rc.to(torch.int64)
        carry = carry - rc
        # the on-grid step
        best, k = ((v[:, NEIGHBOURS] - v0) * invd).max(-1)
        on = torch.where((best > 0)[:, None], p + steps[k], p)
        back = (seen == flat(torch.remainder(near, n))[:, None]).any(-1)
        grid = level | back
        nxt = torch.where(grid[:, None], on, near)
        stopped = stopped | (level & top) | (nxt == p).all(-1)
        dr = torch.where((grid | stopped)[:, None], zero, carry)
        seen = torch.cat([flat(p)[:, None], seen[:, :-1]], 1)
        p = torch.where(stopped[:, None], p, torch.remainder(nxt, n))
        if bool(stopped.all()):
            break
    return flat(p)


def basins(rho, lattice_bohr, dtype=torch.float64) -> dict:
    """Attractors (flat grid indices, ascending), each grid point's basin
    (labels, on rho's device), and each basin's volume (bohr^3) and charge
    (e), the walks in `dtype`."""
    f = rho.to(dtype).reshape(-1)
    shape = tuple(int(v) for v in rho.shape)
    N = f.numel()
    G, invd = metric(lattice_bohr, shape)
    invd = torch.as_tensor(invd, dtype=dtype, device=f.device)
    maxiter = 4 * max(shape) + 64
    roots = torch.empty(N, dtype=torch.int64, device=f.device)
    for lo in range(0, N, BLOCK):
        start = torch.arange(lo, min(N, lo + BLOCK), device=f.device)
        roots[lo:lo + len(start)] = _walk(f, shape, start, G, invd, maxiter)
    iattr, labels = torch.unique(roots, return_inverse=True)
    dv = abs(float(np.linalg.det(np.asarray(lattice_bohr, float)))) / N
    f64 = f.to(torch.float64)
    q = torch.zeros((2, len(iattr)), dtype=torch.float64, device=f.device)
    q[0].index_add_(0, labels, torch.ones_like(f64))
    q[1].index_add_(0, labels, f64)
    q = q.cpu().numpy() * dv
    return {"iattr": iattr.cpu().numpy(), "labels": labels.reshape(shape),
            "volume": q[0], "charge": q[1]}
