"""NCIPLOT: reduced-density-gradient (RDG) non-covalent-interaction
analysis.

Role of the reference nci (src/nci@proc.f90:26-760): on a box grid,
compute s = |grad rho| / (2 (3 pi^2)^(1/3) rho^(4/3)) and sign(lambda_2)
rho, apply cutoffs, and emit -dens.cube / -grad.cube / .dat / .vmd / xyz
outputs; optional promolecular mode, fragment intra/inter filtering
(rhoparam/rhoparam2), VOID charge integration.

Decomposition: the reference's OpenMP triple loop over grid nodes
(src/nci@proc.f90:499-562) becomes batched device evaluations of rho,
gradient, Hessian, the middle eigenvalue (closed-form,
ops/eig3.eigvalsh3s) and the RDG: one separable whole-grid sweep for a
periodic grid field, chunks of points through the field's eval_fn
otherwise. File writers stay host-side.

Defaults mirror the reference: xinc = 0.1 bohr, rhocut = 0.2, rthres = 2
bohr, rhoparam = 0.95, rhoparam2 = 0.75; density fields get dimcut = 2.0,
dimplot = 0.5, rhoplot = 0.1 (src/nci@proc.f90:120-159).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field as dfield

import numpy as np
import torch

from .. import param
from ..config import EDTYPE, FDTYPE, resolve_device
from ..fields.promol import PromolEnv, promolecular_soa
from ..io.cube import write_cube
from ..ops.eig3 import eigvalsh3s, linmap, sym6_rotation
from ..ops.interp import interp_grid_soa

__all__ = ["nciplot", "NCIResult"]

_CONST = 2.0 * (3.0 * np.pi ** 2) ** (1.0 / 3.0)
_VSMALL = 1e-40


def _rdg(rho, gf, h6):
    """(sign(lambda_2) rho x 100, RDG) from SoA value, gradient (3, N)
    and Hessian components (6, N)."""
    lam2 = eigvalsh3s(h6)[1]
    gmod = torch.sqrt((gf * gf).sum(0))
    # f32 floor 1e-30: rho**(4/3) of anything smaller underflows,
    # turning far-from-atom RDG into inf
    vsmall = _VSMALL if rho.dtype == torch.float64 else 1e-30
    rdg = gmod / (_CONST * torch.clamp(rho, min=vsmall) ** (4.0 / 3.0))
    return torch.sign(lam2) * rho.abs() * 100.0, rdg


def _cutoffs(crho, cgrad_raw, inter, rhocut, dimcut, rhoplot, srho_lo,
             srho_hi, onlyneg):
    """.dat selection under cutoffs (reference :593-596) and the RDG cube
    after the plot cutoffs (reference :597-600)."""
    acr = crho.abs()
    sel = (acr < rhocut * 100.0) & (cgrad_raw < dimcut)
    mask = acr > rhoplot * 100.0
    mask = mask | (crho < srho_lo * 100.0) | (crho > srho_hi * 100.0)
    if inter is not None:
        sel = sel & inter
        mask = mask | (~inter)
    if onlyneg:
        mask = mask | (crho > 0)
    cgrad = torch.where(mask, torch.full_like(cgrad_raw, 100.0), cgrad_raw)
    return cgrad, sel


def _grid_sweep(gridf, shape, m_c2x):
    """The whole-grid compute for a periodic grid field: separable
    tricubic sweep -> frame rotation -> middle eigenvalue -> RDG, in
    gridf's dtype (nothing here is accumulated)."""
    y, yp, ypp6 = interp_grid_soa(gridf, shape, nder=2)
    gf = linmap(m_c2x.T, yp.reshape(3, -1))
    del yp
    h6 = linmap(sym6_rotation(m_c2x), ypp6.reshape(6, -1))
    del ypp6
    return _rdg(y.reshape(-1), gf, h6)


@dataclass
class NCIResult:
    """Cubes stay on the device (tensors); only the writers copy them to
    the host. `dat` compacts on the device and transfers the selected
    points only, on first access."""

    crho: object                 # (n1,n2,n3) sign(lambda2) rho x 100
    cgrad: object                # (n1,n2,n3) RDG (after plot cutoffs)
    cgrad_raw: object            # RDG before plot cutoffs
    rhoat: object | None         # promolecular density (if computed)
    x0: np.ndarray               # box origin (Cartesian bohr)
    xmat: np.ndarray             # (3,3) columns = step vectors
    dat_sel: object = None       # (N,) device bool: under-cutoff points
    files: list = dfield(default_factory=list)
    void: dict | None = None
    _dat: np.ndarray | None = None

    @property
    def ndat(self) -> int:
        return int(self.dat_sel.sum())

    @property
    def dat(self) -> np.ndarray:
        """(npts, 2) scatter (rho, rdg) under cutoffs (reference .dat
        emission, src/nci@proc.f90:593-596)."""
        if self._dat is None:
            idx = torch.nonzero(self.dat_sel.reshape(-1))[:, 0]
            cr = self.crho.reshape(-1)[idx] / 100.0
            cg = self.cgrad_raw.reshape(-1)[idx]
            self._dat = torch.stack([cr, cg], dim=1).cpu().numpy()
        return self._dat


def _box(system, nstep, xinc, rthres):
    """Reference box logic (src/nci@proc.f90:355-407)."""
    c = system.crystal
    f = system.ref
    m_x2c = np.asarray(c.m_x2c)
    if not c.ismolecule:
        x0 = np.zeros(3)
        if nstep is None:
            if f.type == "grid":
                nstep = tuple(int(n) for n in f.grid.n)
            else:
                nstep = tuple(int(np.ceil(np.linalg.norm(m_x2c[:, i]) / xinc))
                              for i in range(3))
        xmat = m_x2c / np.asarray(nstep)[None, :]
        periodic = True
    else:
        pos = np.asarray(c.x_cart)
        x0 = pos.min(axis=0) - rthres
        x1 = pos.max(axis=0) + rthres
        if nstep is None:
            nstep = tuple(int(np.ceil(v)) for v in (x1 - x0) / xinc)
        xmat = np.diag((x1 - x0) / np.asarray(nstep))
        periodic = False
    return x0, np.asarray(nstep, dtype=int), xmat, periodic


def nciplot(system, oname: str | None = None, outdir: str | None = None,
            rhocut: float = 0.2, dimcut: float | None = None,
            rhoplot: float | None = None, dimplot: float | None = None,
            srhorange=(-1e30, 1e30), onlyneg: bool = False,
            nstep=None, xinc: float = 0.1, rthres: float = 2.0,
            fragments=None, rhoparam: float = 0.95, rhoparam2: float = 0.75,
            rho_void: float = -1.0, isden: bool = True,
            block: int = 1 << 15, write_files: bool = False,
            molmotif: bool = False, precision: str = "f32") -> NCIResult:
    """Run the NCI analysis on the reference field of `system`.

    precision: "f32" (default) runs the grid fast path in single
    precision - NCI is a visualization workload. Relative to the
    reference's f64 cubes this costs ~1e-4 relative rho, flips up to
    ~1e-3 of .dat selection points and ~2e-3 of sign(lambda2) labels near
    |lambda2| ~ 0. Pass precision="f64" for reference-exact output.
    Runs on the system's device (cuda unless the system was built for
    another).
    """
    dev = resolve_device(system.device)
    if dimcut is None:
        dimcut = 2.0 if isden else 1.0
    if dimplot is None:
        dimplot = 0.5 if isden else 0.3
    if rhoplot is None:
        rhoplot = 0.1 if isden else 0.12

    c = system.crystal
    f = system.ref
    x0, nstep, xmat, periodic = _box(system, nstep, xinc, rthres)
    n1, n2, n3 = (int(v) for v in nstep)
    N = n1 * n2 * n3

    nfrag = len(fragments) if fragments else 0
    dopromol = nfrag > 0 or rho_void > 0.0
    fastpath = f.type == "grid" and periodic and not f.usecore

    promol_env = system.fields[0].promol if dopromol else None
    frag_envs = [PromolEnv(c, fragment=np.asarray(fr, dtype=int), device=dev)
                 for fr in fragments] if nfrag else []

    # chunk points generated on demand (the fast path never needs any)
    xmat_np = np.asarray(xmat)

    def chunk_pts(lo):
        idx = np.arange(lo, min(lo + block, N))
        ijk = np.stack(np.unravel_index(idx, (n1, n2, n3))).astype(float)
        return torch.as_tensor(x0[:, None] + xmat_np @ ijk, dtype=FDTYPE,
                               device=dev)

    # promolecular / fragment densities FIRST: the `inter` filter feeds
    # the cutoffs as a device tensor
    rhoat = rhofrag = None
    if dopromol:
        ras, rfs = [], []
        for lo in range(0, N, block):
            xT = chunk_pts(lo)
            ras.append(promolecular_soa(
                xT, promol_env.atpos, promol_env.atspc,
                promol_env.tab, nder=0)[0])
            if nfrag:
                rfs.append(torch.stack([promolecular_soa(
                    xT, env.atpos, env.atspc, env.tab, nder=0)[0]
                    for env in frag_envs]))
        rhoat = torch.cat(ras)
        if nfrag:
            rhofrag = torch.cat(rfs, dim=1)

    # fragment inter/intra filter (reference :577-583)
    inter = None
    if nfrag:
        tot = rhofrag.sum(dim=0)
        inter = (tot >= rhoparam2 * rhoat) & \
            (rhofrag <= tot[None, :] * rhoparam).all(dim=0)
    voidmask = None
    if rho_void > 0.0:
        voidmask = rhoat < rho_void
        inter = voidmask if inter is None else inter & voidmask

    # ALL whole-grid arrays stay on the device end to end; only scalars
    # and the lazily-materialized .dat selection cross to the host.
    if fastpath:
        # regular-grid separable fast path; the reference's analog builds
        # FFT grad/Hxx grids (src/nci@proc.f90:483-496)
        gridf = f.grid.f.to(EDTYPE if precision == "f32" else f.grid.f.dtype)
        crho, cgrad_raw = _grid_sweep(gridf, (n1, n2, n3),
                                      np.asarray(c.m_c2x))
    else:
        fn = f.eval_fn(nder=2, clamp_nuclei=False)
        crs, cgs = [], []
        for lo in range(0, N, block):
            cr, cg = _rdg(*fn(chunk_pts(lo)))
            crs.append(cr)
            cgs.append(cg)
        crho = torch.cat(crs)
        cgrad_raw = torch.cat(cgs)
    cgrad, sel = _cutoffs(crho, cgrad_raw, inter, rhocut, dimcut, rhoplot,
                          float(srhorange[0]), float(srhorange[1]), onlyneg)

    void = None
    if rho_void > 0.0:
        omega_cell = c.volume
        void = {
            "charge": float((crho.abs() * voidmask).sum() / 100.0
                            * omega_cell / N),
            "pcharge": float((rhoat * voidmask).sum() * omega_cell / N),
            "volume": int(voidmask.sum()) * omega_cell / N,
        }

    res = NCIResult(
        crho=crho.reshape(n1, n2, n3), cgrad=cgrad.reshape(n1, n2, n3),
        cgrad_raw=cgrad_raw.reshape(n1, n2, n3),
        rhoat=rhoat.reshape(n1, n2, n3) if dopromol else None,
        x0=x0, xmat=xmat_np, dat_sel=sel, void=void)

    if write_files:
        oname = oname or "nci"
        root = os.path.join(outdir or ".", oname)
        z = [c.species[si].z for si in c.species_of]
        pos = np.asarray(c.x_cart)
        write_cube(root + "-dens.cube", res.crho, x0, xmat, z, pos,
                   comment1="sign(lambda2) x rho x 100")
        write_cube(root + "-grad.cube", res.cgrad, x0, xmat, z, pos,
                   comment1="reduced density gradient")
        np.savetxt(root + ".dat", res.dat, fmt="%15.7E")
        _write_vmd(root, oname, rhoplot, dimplot)
        _write_cell_xyz(c, root + "_cell.xyz", x0, xmat,
                        (n1, n2, n3), molmotif=molmotif)
        res.files = [root + s for s in ("-dens.cube", "-grad.cube", ".dat",
                                        ".vmd", "_cell.xyz")]
    return res


def _write_cell_xyz(c, path, x0, xmat, nstep, molmotif: bool = False,
                    margin: float = 1.0):
    """Geometry for the NCI visualization: atoms (all lattice images)
    inside the plot box + `margin` bohr; MOLMOTIF completes molecules
    crossing the box boundary (reference _cell.xyz emission,
    src/nci@proc.f90:625-668)."""
    hi = np.asarray(x0) + np.asarray(xmat) @ np.asarray(nstep, float)
    lo = np.minimum(np.asarray(x0), hi) - margin
    hi = np.maximum(np.asarray(x0), hi) + margin
    m = np.asarray(c.m_x2c)
    corners = np.array([[i, j, k] for i in (0, 1) for j in (0, 1)
                        for k in (0, 1)])
    box_f = np.stack([np.linalg.solve(m, lo + cc * (hi - lo))
                      for cc in corners])
    imin = np.floor(box_f.min(0)).astype(int) - 1
    imax = np.ceil(box_f.max(0)).astype(int) + 1
    kept = set()
    xf = np.asarray(c.x_frac)
    for i in range(imin[0], imax[0] + 1):
        for j in range(imin[1], imax[1] + 1):
            for k in range(imin[2], imax[2] + 1):
                xc = (xf + np.array([i, j, k])) @ m.T
                ok = np.all((xc > lo) & (xc < hi), axis=1)
                for a in np.where(ok)[0]:
                    kept.add((int(a), i, j, k))
    if molmotif and not c.ismolecule:
        from ..crystal.fragment import list_molecules

        frags, _ = list_molecules(c)
        for fr in frags:
            mem = list(zip(np.asarray(fr.at_idx, dtype=int),
                           np.asarray(fr.lvec, dtype=int)))
            for a0, i, j, k in list(kept):
                for am, lvm in mem:
                    if am == a0:
                        base = np.array([i, j, k]) - lvm
                        for a2, lv2 in mem:
                            kept.add((int(a2), *(base + lv2)))
                        break
    rows = []
    for a, i, j, k in sorted(kept):
        xc = (xf[a] + np.array([i, j, k])) @ m.T
        if c.ismolecule and getattr(c, "molx0", None) is not None:
            xc = xc + np.asarray(c.molx0)
        rows.append((c.species[c.species_of[a]].name,
                     xc * param.BOHR_TO_ANGSTROM))
    with open(path, "w") as f:
        f.write(f"{len(rows)}\ncritic2-tpu nci cell\n")
        for nm, p in rows:
            f.write(f"{nm} {p[0]:.8f} {p[1]:.8f} {p[2]:.8f}\n")


def _write_vmd(root, oname, rhoplot, dimplot):
    """VMD visualization script (reference :675-760, abbreviated)."""
    with open(root + ".vmd", "w") as f:
        f.write(f"""#!/usr/local/bin/vmd
# NCI isosurface visualization (critic2-tpu)
mol new {oname}-dens.cube
mol addfile {oname}-grad.cube
mol addrep top
mol modstyle 1 top Isosurface {dimplot:.5f} 1 0 0 1 1
mol modcolor 1 top Volume 0
mol modmaterial 1 top Opaque
mol scaleminmax top 1 {-rhoplot * 100:.4f} {rhoplot * 100:.4f}
""")
