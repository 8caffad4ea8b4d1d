"""Sharded Yu-Trinkle integration: the sorted sweep as a slab-parallel
fixpoint with halo exchange, solved by the port's two YT kernels.

Role: the reference YT sweep is strictly sequential in descending-rho
order (src/yt@proc.f90:106-190). As in the JAX package, the sorted sweep
is one solution order of the linear recurrence

    w_i(b) = sum_k chi_ik w_k(b),   chi_ik ~ A_k (rho_k - rho_i)/l_k

over the uphill Wigner-Seitz facet neighbours k of i - an acyclic system,
so any fixpoint iteration reaches the same weights exactly. Every space
shard holds its slab of the normalized flux tensors chi (the rule of
analysis/yt._uphill_flux, fed from the slab padded with its neighbours'
planes) and of the solution, with halo planes exchanged along the sharded
axis (parallel/mesh.halo_pad).

Charges come from the ADJOINT solve s = f + R^T s, batched over the
integrands; labels, weight grids and basin supports from FORWARD solves
flooded in chunks of <= 8 basins, computed lazily - the design of the
single-device analysis/yt.YTResult.

The solve runs on slabs padded with H = max |o_0| halo planes a side
(m + 2H planes), through the kernels of ops/yt_pass:

  * method="gs" (default): each outer iteration is a forward and then a
    backward plane-ordered Gauss-Seidel sweep, each preceded by a halo
    exchange, each one yt_gs_pass launch per shard. The padded operand is
    zero on the 2H halo planes and the right-hand side there holds the
    exchanged old values, so the halo planes stay fixed bit for bit and
    the interior planes read them as old values (the JAX scan carry);
    since |o_0| <= H, the kernel's own axis-0 wrap reaches only halo
    planes. The solve ends when no shard changed a point in either sweep.
  * method="jacobi": each pass is one halo exchange and one yt_pass per
    shard, keeping the interior; the change test is read every `chunk`
    passes. Kept for cross-checks.

`stats` of the solver records the iterations of the last solve.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.yt_pass import yt_gs_pass, yt_pass
from .mesh import gather, halo_pad, psum

__all__ = ["yt_integrate_sharded", "ShardedYTResult"]


class ShardedYTResult:
    """Duck-type of analysis.yt.YTResult over the sharded flux tensors,
    so intgrid/multipoles can consume the multi-device path unchanged.

    Charges: adjoint solve batched over integrands ((nprops, N) state).
    Labels / weight grids / basin supports: lazy forward solves in
    basin chunks of <= 8 ((8, N) state) - nothing dense in nattr."""

    def __init__(self, crystal, shape, nattr, xattr, iattr, solver):
        self.crystal = crystal
        self.shape = shape
        self.nattr = nattr
        self.xattr = xattr
        self.iattr = iattr
        self._solver = solver        # _ShardedSweeper
        self._labels = None
        self._nboundary = None

    def integrate(self, field_flat) -> np.ndarray:
        """sum_i w_i(b) f_i per basin (NOT scaled by Omega/N).
        Accepts one integrand (N,) or a stack (nprops, N)."""
        f = torch.as_tensor(field_flat)
        # a (1, N) stack also has size N: detect stacks by ndim, not size
        single = f.dim() == 1 or tuple(f.shape) == self.shape
        f3 = f.reshape((1 if single else f.shape[0],) + self.shape)
        s = self._solver.solve(f3, adjoint=True)
        q = self._solver.at(s, self.iattr)
        return q[0] if single else q

    def _basin_chunk(self, b0: int, nb: int) -> list:
        """Weight slabs (nb, m, n2, n3) of basins b0..b0+nb-1."""
        sv = self._solver
        i1, i2, i3 = np.unravel_index(self.iattr[b0:b0 + nb], self.shape)
        seeds = []
        for r, d in enumerate(sv.devs):
            seed = torch.zeros((nb, sv.m) + self.shape[1:], dtype=sv.dt,
                               device=d)
            mine = np.flatnonzero(i1 // sv.m == r)
            seed[torch.as_tensor(mine, device=d),
                 torch.as_tensor(i1[mine] - r * sv.m, device=d),
                 torch.as_tensor(i2[mine], device=d),
                 torch.as_tensor(i3[mine], device=d)] = 1.0
            seeds.append(seed)
        return sv.solve(seeds, adjoint=False)

    def _compute_labels(self, chunk: int = 8):
        sv = self._solver
        wmax = [torch.full((sv.m,) + self.shape[1:], -1.0, dtype=sv.dt,
                           device=d) for d in sv.devs]
        lab = [torch.zeros(w.shape, dtype=torch.int32, device=w.device)
               for w in wmax]
        frac = [torch.zeros(w.shape, dtype=torch.bool, device=w.device)
                for w in wmax]
        for b0 in range(0, self.nattr, chunk):
            nb = min(chunk, self.nattr - b0)
            for r, w in enumerate(self._basin_chunk(b0, nb)):
                cmax, carg = w.max(0)
                upd = cmax > wmax[r]
                lab[r] = torch.where(upd, (b0 + carg).to(torch.int32),
                                     lab[r])
                wmax[r] = torch.where(upd, cmax, wmax[r])
                frac[r] |= ((w > 1e-15) & (w < 1.0 - 1e-12)).any(0)
        self._labels = gather(lab, device="cpu").numpy()
        self._nboundary = int(sum(int(x.sum()) for x in frac))

    @property
    def labels(self) -> np.ndarray:
        """Basin per point by max weight; lazy (charges never need it)."""
        if self._labels is None:
            self._compute_labels()
        return self._labels

    @property
    def nboundary(self) -> int:
        """Points with a fractional weight in some basin."""
        if self._nboundary is None:
            self._compute_labels()
        return self._nboundary

    def weights(self, b: int) -> np.ndarray:
        return gather(self._basin_chunk(int(b), 1), dim=1,
                      device="cpu")[0].numpy()

    def basin_support(self, a: int, tol: float = 1e-15):
        """(flat indices, weights) of every point with weight > tol in
        basin `a` — the YT fractional weights, NOT argmax labels."""
        w = self.weights(a).reshape(-1)
        idx = np.where(w > tol)[0]
        return idx, w[idx]


class _ShardedSweeper:
    """Solves (I - R) s = f (forward) or (I - R^T) s = f (adjoint) to
    exact bitwise stationarity (R is nilpotent in sorted order) over the
    space shards, by yt_gs_pass (method="gs") or yt_pass ("jacobi") on
    halo-padded slabs. `stats` records the passes/sweeps of the last
    solve."""

    def __init__(self, mesh, chi, offs, shape, H, m, dt,
                 max_iters: int | None = None, method: str = "gs"):
        if method not in ("gs", "jacobi"):
            raise ValueError(f"unknown sweep method {method}")
        self.mesh = mesh
        self.chi = chi               # per shard (K, m, n2, n3) flux slabs
        self.offs = offs
        self.shape = shape
        self.H = H
        self.m = m
        self.dt = dt
        self.max_iters = max_iters   # None -> n1+n2+n3+16 (worst chain)
        self.method = method
        self.devs = mesh.space_devices
        self.stats: dict = {}
        self._ops = {}

    def operand(self, adjoint: bool) -> list:
        """The kernels' padded operand per shard, (K, m + 2H, n2, n3):
        chi'_k = roll(chi_k, o_k) over the halo-exchanged chi for the
        adjoint, chi for the forward direction, zero on the halo planes.
        Built once per direction."""
        if adjoint not in self._ops:
            H, m = self.H, self.m
            if adjoint:
                ops = []
                for c in halo_pad(self.chi, H, H, dim=1):
                    for k, o in enumerate(self.offs):
                        c[k] = torch.roll(c[k], tuple(o), (0, 1, 2))
                    ops.append(c)
            else:
                ops = [torch.nn.functional.pad(c, (0, 0, 0, 0, H, H))
                       for c in self.chi]
            for c in ops:
                c[:, :H] = 0
                c[:, H + m:] = 0
            self._ops[adjoint] = ops
        return self._ops[adjoint]

    def at(self, slabs, flat) -> np.ndarray:
        """(P, len(flat)) host values of the solution at flat indices."""
        i1, i2, i3 = np.unravel_index(flat, self.shape)
        out = np.zeros((slabs[0].shape[0], len(flat)))
        for r, s in enumerate(slabs):
            mine = np.flatnonzero(i1 // self.m == r)
            d = s.device
            out[:, mine] = s[:, torch.as_tensor(i1[mine] - r * self.m,
                                                device=d),
                             torch.as_tensor(i2[mine], device=d),
                             torch.as_tensor(i3[mine], device=d)].cpu()
        return out

    def _slabs(self, f3) -> list:
        if isinstance(f3, list):
            return [x.to(self.dt) for x in f3]
        m = self.m
        return [f3[:, r * m:(r + 1) * m].to(device=d, dtype=self.dt)
                .contiguous() for r, d in enumerate(self.devs)]

    def solve(self, f3, adjoint: bool) -> list:
        """Solution slabs (P, m, n2, n3) per shard for f3, a (P, n1, n2,
        n3) tensor or a list of such slabs."""
        fs = self._slabs(f3)
        n1, n2, n3 = self.shape
        H, m, offs = self.H, self.m, self.offs
        ops = self.operand(adjoint)
        max_iters = (self.max_iters if self.max_iters is not None
                     else n1 + n2 + n3 + 16)
        s = fs
        it = 0
        if self.method == "gs":
            while it < max_iters:
                flags = []
                for backward in (False, True):
                    new = []
                    for r, sp in enumerate(halo_pad(s, H, H, dim=1)):
                        # the right-hand side: f inside, the exchanged old
                        # values on the halo planes (kept fixed there)
                        fp = sp.clone()
                        fp[:, H:H + m] = fs[r]
                        out, flag = yt_gs_pass(ops[r], sp, fp, offs=offs,
                                               adjoint=adjoint,
                                               backward=backward)
                        new.append(out[:, H:H + m])
                        flags.append(flag.reshape(()))
                    s = new
                it += 1
                if int(psum(flags)) == 0:
                    break
            self.stats = {"method": "gs", "outer_iters": it,
                          "sweeps": 2 * it}
            return s
        fpad = [torch.nn.functional.pad(f, (0, 0, 0, 0, H, H)) for f in fs]
        chunk = min(max(8, (n1 + n2 + n3) // 4), max_iters)
        while it < max_iters:
            for j in range(chunk):
                new = [yt_pass(ops[r], sp, fpad[r], offs=offs,
                               adjoint=adjoint)[:, H:H + m]
                       for r, sp in enumerate(halo_pad(s, H, H, dim=1))]
                if j == chunk - 1:
                    changed = psum([(a != b).sum() for a, b in zip(new, s)])
                s = new
            it += chunk
            if int(changed) == 0:
                break
        self.stats = {"method": "jacobi", "passes": it}
        return s


def yt_integrate_sharded(mesh, crystal, rho, fields_flat=None,
                         max_iters: int | None = None,
                         result: bool = False, method: str = "gs"):
    """YT basin charges over a slab-sharded grid.

    mesh: device mesh with a "space" axis (parallel/mesh.make_mesh); rho
    (n1, n2, n3) tensor or array with n1 divisible by the space axis.
    fields_flat: optional (nf, N) extra integrands. Returns (xattr
    (nattr, 3) fractional, charges (nf+1, nattr) basin sums of rho and
    the integrands, labels (n1, n2, n3) argmax assignment) — or, with
    result=True, a ShardedYTResult that plugs into
    analysis.integration.intgrid in place of YTResult.
    """
    from ..analysis.yt import _grid_ws_neighbors, _uphill_flux

    devs = mesh.space_devices
    rho = torch.as_tensor(rho, device=devs[0])
    shape = tuple(int(v) for v in rho.shape)
    n1, n2, n3 = shape
    N = n1 * n2 * n3
    nspace = mesh.shape["space"]
    if n1 % nspace:
        raise ValueError(f"n1={n1} not divisible by space={nspace}")
    m = n1 // nspace

    offs_np, wts = _grid_ws_neighbors(crystal, shape)
    offs = tuple(tuple(int(v) for v in o) for o in np.asarray(offs_np))
    H = max(abs(o[0]) for o in offs)             # halo width along axis 0
    if H > m:
        raise ValueError("halo wider than slab; use fewer shards")

    # ---- flux tensors + attractor mask, per padded slab ---------------
    rslabs = [rho[r * m:(r + 1) * m].to(d) for r, d in enumerate(devs)]
    islabs = [torch.arange(r * m * n2 * n3, (r + 1) * m * n2 * n3,
                           dtype=torch.int64, device=d).reshape(m, n2, n3)
              for r, d in enumerate(devs)]
    def slab_flux(rp, ip):
        # x + o: rows H + o_0 .. of the padded slab (|o_0| <= H)
        return _uphill_flux(
            rp[H:H + m], ip[H:H + m], wts, offs,
            lambda o: tuple(torch.roll(p[H + o[0]:H + o[0] + m],
                                       (-o[1], -o[2]), (1, 2))
                            for p in (rp, ip)))

    chi, is_attr = zip(*(
        slab_flux(rp, ip)
        for rp, ip in zip(halo_pad(rslabs, H, H), halo_pad(islabs, H, H))))

    # small host transfers only: the bool mask and the attractor rhos
    iattr = np.flatnonzero(gather(list(is_attr), device="cpu").numpy())
    rho_at = rho.reshape(-1)[torch.as_tensor(iattr, device=rho.device)]
    iattr = iattr[np.lexsort((iattr, -rho_at.cpu().numpy()))]
    nattr = len(iattr)
    xattr = np.stack(np.unravel_index(iattr, shape), axis=1) \
        / np.asarray(shape)

    # ---- adjoint charges + lazy forward labels ----------------------
    solver = _ShardedSweeper(mesh, list(chi), offs, shape, H, m, rho.dtype,
                             max_iters=max_iters, method=method)
    res = ShardedYTResult(crystal, shape, nattr, xattr, iattr, solver)
    if result:
        return res

    integrands = [rho.reshape(-1)]
    if fields_flat is not None:
        ff = torch.as_tensor(fields_flat, device=rho.device)
        integrands += list(ff.reshape(-1, N).to(rho.dtype))
    charges = res.integrate(torch.stack(integrands))
    return xattr, charges, res.labels
