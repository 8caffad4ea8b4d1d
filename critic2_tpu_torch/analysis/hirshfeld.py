"""Hirshfeld atomic charges on grids.

Role of the reference hirshfeld (src/hirshfeld@proc.f90:26-120): per-atom
stockholder weights w_at = rho_at / rho_promol accumulated over expanding
image shells, populations N_at = int w_at rho, charges Z - N_at.

Decomposition: one device pass a block of grid nodes computes, for every
node, each atom image's promolecular contribution and the total, giving
all weights at once (no per-atom shell loop); the per-image sums fold
onto the cell atoms with index_add_. The populations accumulate on the
device in f64 and are read once at the end.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import FDTYPE, resolve_device

__all__ = ["hirshfeld_charges", "HirshfeldResult"]


@dataclass
class HirshfeldResult:
    names: list
    z: np.ndarray
    pops: np.ndarray            # integrated electron populations
    charges: np.ndarray         # Z - pop

    def table(self) -> str:
        lines = ["# i  Atom      population          charge"]
        for i, (nm, z, p, q) in enumerate(
                zip(self.names, self.z, self.pops, self.charges), 1):
            lines.append(f"{i:4d}  {nm:>4s}  {p:16.10f}  {q:16.10f}")
        lines.append(f"# total population: {self.pops.sum():.10f}")
        return "\n".join(lines)


def _hirsh_chunk(pT, rho_chunk, atpos, atspc, tab):
    """One block's per-image Hirshfeld accumulation (M,)."""
    from ..fields.promol import _radial_interp

    xx = pT[:, :, None] - atpos.T[:, None, :]          # (3, n, M)
    r = torch.sqrt(torch.clamp((xx * xx).sum(0), min=1e-28))
    s = atspc[None, :].expand(r.shape)
    within = r <= tab["cutoff"][atspc][None, :]
    rr, _, _ = _radial_interp(tab, s, r, nder=0)
    rr = torch.where(within, torch.clamp(rr, min=0.0), torch.zeros_like(rr))
    tot = rr.sum(1)
    w = rho_chunk / torch.clamp(tot, min=1e-300)
    return (rr * w[:, None]).sum(0)


def hirshfeld_charges(system, block: int = 1 << 15) -> HirshfeldResult:
    """Hirshfeld charges of the reference field (grid or rasterized at
    48^3), on the system's device, `block` grid nodes a pass."""
    from .integration import _grid_points, _rasterize_field

    dev = resolve_device(system.device)
    c = system.crystal
    f = system.ref
    if f.type == "grid":
        rho = f.grid.f
    else:
        rho = _rasterize_field(f, (48, 48, 48))
    rho = rho.to(device=dev, dtype=FDTYPE)
    shape = tuple(int(v) for v in rho.shape)

    env = system.fields[0].promol
    nat = c.ncel
    cellidx = torch.as_tensor(np.asarray(env.cellidx, dtype=np.int64),
                              device=dev)

    N = rho.numel()
    rho_flat = rho.reshape(-1)
    per_image = torch.zeros(env.atpos.shape[0], dtype=FDTYPE, device=dev)
    for lo in range(0, N, block):
        hi = min(N, lo + block)
        pT = _grid_points(c, shape, lo, hi, FDTYPE, dev)
        per_image += _hirsh_chunk(pT, rho_flat[lo:hi], env.atpos,
                                  env.atspc, env.tab)
    pops = torch.zeros(nat, dtype=FDTYPE, device=dev)
    pops.index_add_(0, cellidx, per_image)
    pops = pops.cpu().numpy() * (c.volume / N)
    zs = np.asarray(c.zatoms, dtype=float)
    names = [c.species[s].name for s in c.species_of]
    return HirshfeldResult(names=names, z=zs, pops=pops,
                           charges=zs - pops)
