"""Job `nci`: an NCIPLOT analysis of a grid density, at nciplot's
defaults (float32 over the float64 grid, the grid fast path, output grid
= the field's grid).

The timed call builds a System from the configuration's structure, loads
the density as a grid field already on the device, runs nciplot(system)
and takes what the cube writer needs to the host: the sign(lambda2) rho
and RDG grids and the count of selected points. The check holds both
grids and the count to the plain reference (benchmark/reference/nci.py)
in float64.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.lib import program
from benchmark.reference import nci as ref_nci

# the control: the reference's sweep one precision below nciplot's float32
CONTROL = torch.bfloat16


def run(ctx, rho):
    from critic2_tpu_torch.analysis.nci import nciplot

    s = program.system(ctx, rho)
    with ctx.span("analysis"):
        res = nciplot(s)
    with ctx.span("readback"):
        return {"crho": res.crho.cpu().numpy(),
                "cgrad": res.cgrad.cpu().numpy(), "ndat": res.ndat}


def info(ctx) -> dict:
    return {"N": int(np.prod([int(v) for v in ctx.cfg["grid"]]))}


def reference(ctx, rho, dtype):
    return ref_nci.nci(rho, ctx.cfg["structure"]["lattice_bohr"], dtype)


def as_output(ans) -> dict:
    return {"crho": ans["crho"].float().cpu().numpy(),
            "cgrad": ans["cgrad"].float().cpu().numpy(),
            "ndat": ans["ndat"]}


def compare(ctx, out, ans) -> dict:
    """dens_rel_gap: widest relative gap of |sign(lambda2) rho| where
    neither side reads lambda2 = 0;
    sign_flip_share: share of points whose sign(lambda2) differs (a
    lambda2 of exactly 0, sign 0, counts as differing);
    mask_flip_share: share of points plotted on one side only;
    rdg_gap: widest gap of the RDG where both plot it, relative above 1;
    ndat_rel_gap: relative gap of the selected-point count."""
    cr, cg = ans["crho"], ans["cgrad"]
    n = cr.numel()
    worst = {"dens_rel_gap": 0.0, "rdg_gap": 0.0}
    flips = masks = 0
    flat_p = (out["crho"].reshape(-1), out["cgrad"].reshape(-1))
    step = 1 << 24
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        rp = torch.from_numpy(flat_p[0][lo:hi]).to(cr.device, cr.dtype)
        gp = torch.from_numpy(flat_p[1][lo:hi]).to(cr.device, cr.dtype)
        rr, gr = cr.reshape(-1)[lo:hi], cg.reshape(-1)[lo:hi]
        nz = (rp != 0) & (rr != 0)
        gap = (rp.abs() - rr.abs()).abs() / rr.abs()
        worst["dens_rel_gap"] = max(worst["dens_rel_gap"],
                                    float(gap[nz].max()))
        flips += int((torch.sign(rp) != torch.sign(rr)).sum())
        mp, mr = gp == 100.0, gr == 100.0
        masks += int((mp != mr).sum())
        both = ~mp & ~mr
        if bool(both.any()):
            d = (gp - gr).abs() / torch.clamp(gr, min=1.0)
            worst["rdg_gap"] = max(worst["rdg_gap"], float(d[both].max()))
    return {**worst, "sign_flip_share": flips / n, "mask_flip_share": masks / n,
            "ndat_rel_gap": abs(out["ndat"] - ans["ndat"]) / max(ans["ndat"], 1)}
