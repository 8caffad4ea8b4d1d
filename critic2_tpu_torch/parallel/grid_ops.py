"""Sharded whole-grid pipeline: distributed FFT operators, the fused
NCI sweep, and basin-weighted reductions over a slab-sharded grid.

The reference runs its whole-grid workloads as OpenMP loops over one
shared-memory array: the FFT-derived grids (laplacian/gradrho/hxx/pot,
src/grid3mod@proc.f90:1075-1439), the NCI box sweep
(src/nci@proc.f90:496-562) and the basin property sums
(src/integration@proc.f90:949-1178). Here each runs over the "space"
axis of the device mesh (parallel/mesh.py):

 - grids are slab-sharded along axis 0: one (m, n2, n3) tensor per space
   index, on that shard's device;
 - the 3-D FFT is the classic transpose algorithm: a local FFT over axes
   (1, 2), the tiled all-to-all (axis 1 scattered, axis 0 gathered), a
   local FFT over axis 0 - the transpose is the only collective;
 - k-space scalings are built from 1-D frequency vectors per shard, so
   no (n1, n2, n3, 3) G-vector tensor is ever materialized;
 - the NCI sweep is elementwise per slab after the FFT grids exist;
 - basin reductions are sums over space of per-shard segment sums.

Dtype rule of ops/fft.py: the transform runs in the grid's own dtype on
every device (f64 grid -> complex128). The JAX package drops f64 grids to
complex64 on the TPU, which has no complex128; a CUDA card has it, so
that branch does not carry over.
"""
from __future__ import annotations

import numpy as np
import torch

from .mesh import all_to_all, psum

__all__ = ["ShardedGridOps", "basin_reduce_sharded"]


def _recip_columns(m_x2c):
    """Reciprocal basis B (3,3) with G = kx B[:,0] + ky B[:,1] + kz B[:,2]."""
    m = np.asarray(m_x2c, dtype=float)
    vol = abs(np.linalg.det(m))
    b = np.empty((3, 3))
    b[:, 0] = np.cross(m[:, 1], m[:, 2])
    b[:, 1] = np.cross(m[:, 2], m[:, 0])
    b[:, 2] = np.cross(m[:, 0], m[:, 1])
    return b * (2.0 * np.pi / vol), vol


class ShardedGridOps:
    """FFT grid operators over a slab-sharded grid.

    Each operator takes a grid ((n1, n2, n3) tensor or array, cut into
    slabs here) or a list of slabs, one per space index, and returns a
    list of slabs, one per space index on its shard's device
    (parallel.mesh.gather joins them into one tensor).
    """

    def __init__(self, mesh, shape, m_x2c):
        self.mesh = mesh
        self.shape = tuple(int(v) for v in shape)
        n1, n2, n3 = self.shape
        self.nspace = mesh.shape["space"]
        if n1 % self.nspace or n2 % self.nspace:
            raise ValueError(
                f"grid axes 0/1 ({n1},{n2}) must divide the space axis "
                f"({self.nspace}) for the transpose FFT")
        b, vol = _recip_columns(m_x2c)
        self._b = b
        self.vol = vol
        # integer FFT frequencies, host constants
        self._k1 = np.fft.fftfreq(n1, d=1.0 / n1)
        self._k2 = np.fft.fftfreq(n2, d=1.0 / n2)
        self._k3 = np.fft.fftfreq(n3, d=1.0 / n3)
        self._devs = mesh.space_devices

    # -- distributed FFT core ----------------------------------------

    def _slabs(self, f):
        """A grid as its list of slabs on the space devices."""
        if isinstance(f, (list, tuple)):
            return list(f)
        g = torch.as_tensor(f, device=self._devs[0])
        m = self.shape[0] // self.nspace
        return [g[r * m:(r + 1) * m].to(d) for r, d in enumerate(self._devs)]

    def _fwd(self, slabs):
        """real slabs (m, n2, n3) -> middle rep (n1, c2, n3) complex,
        complex128 for f64 grids."""
        fk = [torch.fft.fftn(s, dim=(1, 2)) for s in slabs]
        fk = all_to_all(fk, split_dim=1, concat_dim=0)
        return [torch.fft.fft(x, dim=0) for x in fk]

    def _bwd(self, fk, dt):
        """middle rep -> real slabs (m, n2, n3) of dtype dt."""
        f = [torch.fft.ifft(x, dim=0) for x in fk]
        f = all_to_all(f, split_dim=0, concat_dim=1)
        return [torch.fft.ifftn(x, dim=(1, 2)).real.to(dt) for x in f]

    def _gcomp(self, a, r, rdtype):
        """Cartesian G component a on shard r's middle rep, (n1, c2, n3):
        the shard holds the k2 slice r."""
        c2 = self.shape[1] // self.nspace
        dev = self._devs[r]

        def vec(k):
            return torch.as_tensor(k, dtype=rdtype, device=dev)

        k1 = vec(self._k1)
        k2 = vec(self._k2[r * c2:(r + 1) * c2])
        k3 = vec(self._k3)
        b = self._b
        return (k1[:, None, None] * float(b[a, 0])
                + k2[None, :, None] * float(b[a, 1])
                + k3[None, None, :] * float(b[a, 2]))

    def _scaled(self, fk, scale):
        """fk with shard r's middle rep multiplied by scale(r, g), g the
        three G components of shard r."""
        rd = fk[0].real.dtype
        return [scale([self._gcomp(a, r, rd) for a in range(3)]) * x
                for r, x in enumerate(fk)]

    # -- public operators --------------------------------------------

    def laplacian(self, f):
        """del^2 f (reference laplacian, src/grid3mod@proc.f90:1075)."""
        slabs = self._slabs(f)
        fk = self._fwd(slabs)
        return self._bwd(self._scaled(fk, lambda g: -(g[0] ** 2 + g[1] ** 2
                                                      + g[2] ** 2)),
                         slabs[0].dtype)

    def grad_components(self, f):
        """Cartesian gradient components: three lists of slabs."""
        slabs = self._slabs(f)
        fk = self._fwd(slabs)
        return tuple(self._bwd(self._scaled(fk, lambda g, a=a: 1j * g[a]),
                               slabs[0].dtype) for a in range(3))

    def gradrho(self, f):
        """|grad f| (reference gradrho, src/grid3mod@proc.f90:1164)."""
        comps = self.grad_components(f)
        return [torch.sqrt(gx * gx + gy * gy + gz * gz)
                for gx, gy, gz in zip(*comps)]

    def hxx(self, f, ix: int):
        """d2f/dx_ix^2 (reference hxx, src/grid3mod@proc.f90:1345)."""
        slabs = self._slabs(f)
        fk = self._fwd(slabs)
        return self._bwd(self._scaled(fk, lambda g: -g[ix] * g[ix]),
                         slabs[0].dtype)

    def pot(self, f, isry: bool = False):
        """Hartree potential, V(G)=4 pi rho(G)/G^2, V(0)=0 (reference
        pot, src/grid3mod@proc.f90:1245; isry doubles to Rydberg)."""
        def scale(g):
            g2 = g[0] ** 2 + g[1] ** 2 + g[2] ** 2
            small = g2 < 1e-12
            return torch.where(small, torch.zeros_like(g2),
                               4.0 * np.pi / torch.where(
                                   small, torch.ones_like(g2), g2))

        slabs = self._slabs(f)
        v = self._bwd(self._scaled(self._fwd(slabs), scale), slabs[0].dtype)
        return [2.0 * x for x in v] if isry else v

    def nci_grids(self, f, rho_min: float = 1e-30):
        """Fused sharded NCI sweep (reference hot loop,
        src/nci@proc.f90:496-562): returns (rho, rdg, sl2rho) slab lists
        where rdg = |grad|/(2 (3 pi^2)^(1/3) rho^(4/3)) and sl2rho =
        sign(lambda_2(H)) * rho from the FFT Hessian.
        """
        from ..ops.eig3 import eigvalsh3s

        slabs = self._slabs(f)
        dt = slabs[0].dtype
        fk = self._fwd(slabs)
        gmod = self.gradrho(slabs)
        # SYM6 order (xx, yy, zz, xy, xz, yz)
        pairs = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))
        h = [self._bwd(self._scaled(fk, lambda g, a=a, b=b: -g[a] * g[b]),
                       dt) for a, b in pairs]
        out = ([], [], [])
        c = 2.0 * (3.0 * np.pi ** 2) ** (1.0 / 3.0)
        for r, slab in enumerate(slabs):
            lam = eigvalsh3s(torch.stack([x[r].reshape(-1) for x in h]))
            l2sign = torch.sign(lam[1]).reshape(slab.shape)
            rho = slab.abs()
            out[0].append(rho)
            out[1].append(gmod[r] / (c * torch.clamp(rho, min=rho_min)
                                     ** (4.0 / 3.0)))
            out[2].append(l2sign.to(dt) * rho)
        return out


def basin_reduce_sharded(mesh, interior_label, bidx, Wb, nattr,
                         fields_flat):
    """Sharded YT/Bader property integration: for each integrand f,
    q[b] = sum_i w_i(b) f_i, with interior points one-hot on their label
    and boundary points weighted by columns of Wb (the reference's
    per-attractor OpenMP loop, src/integration@proc.f90:986-1178).

    interior_label: (N,) int, -1 at boundary points.
    bidx: (N,) int column into Wb for boundary points (0 elsewhere).
    Wb: (nattr, Nb) dense boundary weights (on every shard; small).
    fields_flat: (nf, N) stacked integrands.
    The N points are split over "space"; each shard sums its interior
    points by label (index_add_) and its boundary points into Wb's
    columns, takes the boundary part as one matrix product, and the
    shards' (nf, nattr) parts are summed. Returns (nf, nattr) on host.
    """
    nspace = mesh.shape["space"]
    N = len(interior_label)
    if N % nspace:
        raise ValueError(f"N={N} not divisible by space={nspace}")
    n = N // nspace
    devs = mesh.space_devices
    lab_all = torch.as_tensor(interior_label, device=devs[0])
    bi_all = torch.as_tensor(bidx, device=devs[0])
    ff_all = torch.as_tensor(fields_flat, device=devs[0])
    Wb0 = torch.as_tensor(Wb, device=devs[0])
    nb = Wb0.shape[1]
    parts = []
    for r, d in enumerate(devs):
        lab = lab_all[r * n:(r + 1) * n].to(d).to(torch.int64)
        bi = bi_all[r * n:(r + 1) * n].to(d).to(torch.int64)
        ff = ff_all[:, r * n:(r + 1) * n].to(d)
        Wbd = Wb0.to(d).to(ff.dtype)
        interior = lab >= 0
        qi = torch.zeros((ff.shape[0], nattr), dtype=ff.dtype, device=d)
        qi.index_add_(1, lab[interior], ff[:, interior])
        contrib = torch.zeros((ff.shape[0], nb), dtype=ff.dtype, device=d)
        contrib.index_add_(1, bi[~interior], ff[:, ~interior])
        parts.append(qi + contrib @ Wbd.T)
    return psum(parts).cpu().numpy()
