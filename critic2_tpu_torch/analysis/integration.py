"""Basin integration: YT/Bader + attractor-atom matching + integration.

Role of the reference integration (src/integration@proc.f90): build the
basin field (optionally core-augmented), run the decomposition, match
attractors to the atom list (int_reorder_gridout :821-945; unmatched
maxima become non-nuclear maxima, NNM), then integrate the volume, the
charge and any extra integrand in one batched adjoint solve.

Device: rasterization, decomposition and the solve. Host: matching,
merging, table assembly. The port carries method="yt" and "bader", the
INTEGRABLE expressions, DISCARD and the atomic multipoles; with a device
mesh (parallel/mesh.make_mesh), the YT decomposition and its solves run
slab-parallel across the mesh (parallel/yt_sharded).
"""
from __future__ import annotations

from dataclasses import dataclass, field as dfield

import numpy as np
import torch

from ..config import FDTYPE
from ..utils import trace
from .bader import bader_integrate
from .yt import yt_integrate

__all__ = ["intgrid", "multipoles", "IntegrationResult", "BasinRow"]


@dataclass
class BasinRow:
    idx: int
    name: str               # atom symbol or "nnm"
    atom: int               # cell-atom index or -1
    xfrac: np.ndarray
    volume: float
    pop: float              # integrated reference density
    lap: float | None = None
    extra: dict = dfield(default_factory=dict)


@dataclass
class IntegrationResult:
    method: str
    rows: list
    nattr_raw: int
    decomp: object = None        # YTResult/BaderResult (weight access)
    attr_map: list = None        # row index per raw attractor
    grid_shape: tuple = None
    rho: object = None           # basin-field grid (device tensor)

    @property
    def charges(self):
        return np.array([r.pop for r in self.rows])

    @property
    def volumes(self):
        return np.array([r.volume for r in self.rows])

    def table(self) -> str:
        extras = list(self.rows[0].extra) if self.rows else []
        hdr = ("# id  name  atom        volume            pop        "
               "position (frac)")
        for name in extras:
            hdr += f"  {name:>16s}"
        lines = [hdr]
        for r in self.rows:
            ln = (f"{r.idx:4d}  {r.name:>4s}  {r.atom:4d}  "
                  f"{r.volume:14.8f}  {r.pop:14.8f}   {r.xfrac[0]:.6f} "
                  f"{r.xfrac[1]:.6f} {r.xfrac[2]:.6f}")
            for name in extras:
                ln += f"  {r.extra[name]:16.8f}"
            lines.append(ln)
        tot_v = sum(r.volume for r in self.rows)
        tot_q = sum(r.pop for r in self.rows)
        lines.append(f"# sum             {tot_v:14.8f}  {tot_q:14.8f}")
        return "\n".join(lines)


def _match_attractors(crystal, xattr, ratom):
    """Map each attractor to the nearest atom within ratom (bohr), else -1
    (reference int_reorder_gridout, src/integration@proc.f90:821-945)."""
    out = np.full(len(xattr), -1, dtype=int)
    if crystal.ncel == 0:
        return out
    for i, xa in enumerate(xattr):
        d = xa[None, :] - np.asarray(crystal.x_frac)
        d -= np.rint(d)
        dc = np.linalg.norm(d @ np.asarray(crystal.m_x2c).T, axis=1)
        j = int(np.argmin(dc))
        if dc[j] <= ratom:
            out[i] = j
    return out


def intgrid(system, method: str = "yt", ratom: float = 1.0,
            fields: dict | None = None, block: int = 1 << 16,
            grid_shape=None, bader_method: str = "neargrid", mesh=None,
            nnm: bool = True, noatoms: bool = False,
            discard: str | None = None):
    """Run grid basin integration on the reference field of `system`.

    method: "yt" or "bader" (bader_method selects the reference's
    NEARGRID default or ONGRID, src/bader@proc.f90:81).
    The reference field must be (or is rasterized to, at `grid_shape`,
    64^3 by default) a grid; its core-augmented variant is the basin field
    when the field has usecore set (src/integration@proc.f90:176-183).
    fields: optional {name: (n1,n2,n3) array or tensor} of extra
    integrands; the expressions registered in system.integrables
    (strings, or (expr, label) pairs) join them, evaluated on the grid
    nodes. discard: an expression; attractors where it is non-zero are
    dropped with their basin's charge and volume.
    Attractor-to-atom assignment follows the reference keywords
    (src/integration@proc.f90:166-175): nnm=False assigns every attractor
    to its nearest atom; nnm=True keeps attractors farther than `ratom`
    (bohr) from any atom as non-nuclear maxima; noatoms=True treats all
    attractors as NNM. Everything runs on the system's device, except
    that with `mesh` (a parallel.mesh.Mesh with a "space" axis) the YT
    weights are built and solved slab-parallel on the mesh's devices
    (parallel.yt_sharded); identical weights.
    """
    with trace.span("intgrid"):
        if method not in ("yt", "bader"):
            raise ValueError(f"unknown integration method {method}")
        f = system.ref
        c = system.crystal
        if f.type == "grid":
            rho = f.grid.f
            shape = tuple(int(s) for s in rho.shape)
            env = f.coreenv
            if env is not None:
                rho = rho + _rasterize_env(c, env, shape, block=block)
        else:
            shape = tuple(grid_shape or (64, 64, 64))
            rho = _rasterize_field(f, shape, block=block)

        if method == "yt" and mesh is not None:
            from ..parallel.yt_sharded import yt_integrate_sharded

            res = yt_integrate_sharded(mesh, c, rho, result=True)
        elif method == "yt":
            res = yt_integrate(c, rho)
        else:
            res = bader_integrate(c, rho, block=max(block, 1 << 16),
                                  method=bader_method)

        dev = rho.device
        # registered INTEGRABLE expressions evaluate on the basin grid nodes
        # (reference intgrid_fields, src/integration@proc.f90:949-1178)
        if system.integrables:
            from ..arithmetic import compile_expr

            fields = dict(fields or {})
            N = int(np.prod(shape))
            for item in system.integrables:
                # entries are expression strings, or (expr, label) pairs
                # from INTEGRABLE ... NAME (reference propty NAME option)
                expr, label = item if isinstance(item, tuple) else (item, item)
                fn = compile_expr(expr, system)
                out = torch.empty(N, dtype=rho.dtype, device=dev)
                for lo in range(0, N, block):
                    hi = min(N, lo + block)
                    out[lo:hi] = fn(_grid_points(c, shape, lo, hi, rho.dtype,
                                                 dev))
                fields[label] = out.reshape(shape)

        npts = float(np.prod(shape))
        scale = c.volume / npts
        # one batched adjoint solve for every integrand (volume, charge,
        # extras)
        fnames = list(fields) if fields else []
        stack = torch.stack(
            [torch.ones(int(npts), dtype=rho.dtype, device=dev),
             rho.reshape(-1)]
            + [torch.as_tensor(fields[n], dtype=rho.dtype,
                               device=dev).reshape(-1) for n in fnames])
        qall = res.integrate(stack) * scale
        vol, pop = qall[0], qall[1]
        extras = {name: qall[2 + i] for i, name in enumerate(fnames)}

        with trace.span("intgrid.rows"):
            if noatoms:
                iat = np.full(res.nattr, -1, dtype=int)
            else:
                iat = _match_attractors(c, res.xattr, ratom if nnm else 1e40)

            # DISCARD: attractors where the expression is non-zero are dropped
            # with their basin's charge and volume (reference bas%expr,
            # src/yt@proc.f90:160-166)
            dropped = np.zeros(res.nattr, dtype=bool)
            if discard:
                xc_attr = np.asarray(res.xattr).reshape(-1, 3) @ \
                    np.asarray(c.m_x2c).T
                trace.count("host_syncs")
                vals = system.eval_expr(discard, xc_attr).cpu().numpy()
                dropped = np.abs(vals.reshape(-1)) > 1e-30

            # merge attractors mapped to the same atom (one row per
            # attractor-atom)
            rows = []
            used = {}
            attr_map = []
            for a in range(res.nattr):
                if dropped[a]:
                    attr_map.append(-1)
                    continue
                key = ("atom", iat[a]) if iat[a] >= 0 else ("nnm", a)
                if key in used:
                    r = rows[used[key]]
                    r.volume += float(vol[a])
                    r.pop += float(pop[a])
                    for name in extras:
                        r.extra[name] += float(extras[name][a])
                    attr_map.append(used[key])
                    continue
                if iat[a] >= 0:
                    nm = c.species[c.species_of[iat[a]]].name
                    xf = np.asarray(c.x_frac[iat[a]])
                else:
                    nm = "nnm"
                    xf = res.xattr[a]
                rows.append(BasinRow(
                    idx=len(rows) + 1, name=nm, atom=int(iat[a]), xfrac=xf,
                    volume=float(vol[a]), pop=float(pop[a]),
                    extra={k: float(v[a]) for k, v in extras.items()}))
                used[key] = len(rows) - 1
                attr_map.append(used[key])

        return IntegrationResult(method=method, rows=rows, nattr_raw=res.nattr,
                                 decomp=res, attr_map=attr_map,
                                 grid_shape=shape, rho=rho)


def _multipole_integrands(crystal, shape, rho_flat, center, lmax: int):
    """(nlm, N) integrands rho r^l S_lm(r - center) on the grid nodes, the
    displacements by minimum image; center is fractional."""
    from ..ops.rlm import solid_harmonics

    dev, dt = rho_flat.device, rho_flat.dtype
    n1, n2, n3 = shape
    idx = torch.arange(n1 * n2 * n3, device=dev)
    xf = torch.stack([(idx // (n2 * n3)).to(dt) / n1,
                      ((idx // n3) % n2).to(dt) / n2,
                      (idx % n3).to(dt) / n3], dim=1)            # (N, 3)
    m_x2c = torch.as_tensor(np.asarray(crystal.m_x2c), dtype=dt, device=dev)
    d = xf - torch.as_tensor(np.asarray(center), dtype=dt, device=dev)[None, :]
    d = d - torch.round(d)
    rl = solid_harmonics((d @ m_x2c.T).T, lmax)           # (nlm, N)
    return rl * rho_flat[None, :]


def multipoles(system, intres: IntegrationResult, lmax: int = 4):
    """Atomic multipoles Q_lm = int_basin w rho r^l S_lm(r - x_attr)
    (reference intgrid_multipoles, src/integration@proc.f90:1102-1178).

    Returns (nrows, (lmax+1)^2) with components in -m..m order per l,
    centered on each row's attractor (minimum-image displacements). One
    whole adjoint solve with (lmax+1)^2 integrands runs per attractor, on
    the device of the integration result.
    """
    from ..ops.rlm import nlm

    c = system.crystal
    res = intres.decomp
    shape = intres.grid_shape
    rho_flat = intres.rho.reshape(-1)
    scale = c.volume / float(np.prod(shape))

    out = np.zeros((len(intres.rows), nlm(lmax)))
    for a in range(res.nattr):
        row = intres.attr_map[a]
        if row < 0:              # DISCARDed attractor
            continue
        f = _multipole_integrands(c, shape, rho_flat,
                                  intres.rows[row].xfrac, lmax)
        qa = res.integrate(f)                             # (nlm, nattr)
        out[row] += np.asarray(qa[:, a]) * scale
    return out


def _grid_points(crystal, shape, lo, hi, dtype, device):
    """(3, hi-lo) Cartesian coordinates of flat grid nodes lo..hi-1 (node
    (i, j, k) sits at fractional (i/n1, j/n2, k/n3))."""
    n1, n2, n3 = shape
    idx = torch.arange(lo, hi, dtype=torch.int64, device=device)
    xf = torch.stack([(idx // (n2 * n3)).to(dtype) / n1,
                      ((idx // n3) % n2).to(dtype) / n2,
                      (idx % n3).to(dtype) / n3])
    m = torch.as_tensor(np.asarray(crystal.m_x2c), dtype=dtype,
                        device=device)
    return m @ xf


def _rasterize_field(f, shape, block: int = 1 << 16, nder: int = 0):
    """Evaluate a field on the regular grid nodes, `block` nodes at a time,
    on the field's device."""
    fn = f.eval_fn(nder=nder)
    dev = f.device
    dt = f.promol.atpos.dtype if f.type == "promol" else FDTYPE
    N = int(np.prod(shape))
    out = torch.empty(N, dtype=dt, device=dev)
    for lo in range(0, N, block):
        hi = min(N, lo + block)
        out[lo:hi] = fn(_grid_points(f.crystal, shape, lo, hi, dt, dev))[0]
    return out.reshape(shape)


def _rasterize_env(crystal, env, shape, block: int = 1 << 16):
    """Core-density grid from a PromolEnv (reference promolecular_grid,
    src/crystalmod@proc.f90:5118)."""
    from ..fields.promol import promolecular_soa

    dev, dt = env.atpos.device, env.atpos.dtype
    N = int(np.prod(shape))
    out = torch.empty(N, dtype=dt, device=dev)
    for lo in range(0, N, block):
        hi = min(N, lo + block)
        xT = _grid_points(crystal, shape, lo, hi, dt, dev)
        out[lo:hi] = promolecular_soa(xT, env.atpos, env.atspc, env.tab,
                                      nder=0)[0]
    return out.reshape(shape)
