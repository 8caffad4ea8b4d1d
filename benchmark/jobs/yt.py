"""Job `yt`: QTAIM basin volumes and charges by Yu-Trinkle integration,
critic2's INTEGRALS default for a grid density.

The timed call builds a System from the configuration's structure, loads
the density as a grid field already on the device, runs
intgrid(system, method="yt") with critic2's defaults and takes the table
of volumes and charges per attractor to the host (intgrid does). The
check holds the attractors (count and grid positions) and every basin's
volume and charge to the plain reference (benchmark/reference/yt.py),
which works the flux weights and attractors out again from the density.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.lib import program
from benchmark.reference import yt as ref_yt

# the control: the reference one precision below the float64 of the solve
CONTROL = torch.float32


def run(ctx, rho):
    from critic2_tpu_torch.analysis.integration import intgrid

    s = program.system(ctx, rho)
    with ctx.span("analysis"):
        res = intgrid(s, method="yt")
    with ctx.span("readback"):
        return {"iattr": np.asarray(res.decomp.iattr, dtype=np.int64),
                "attr_map": np.asarray(res.attr_map, dtype=np.int64),
                "volume": np.asarray(res.volumes, dtype=float),
                "charge": np.asarray(res.charges, dtype=float)}


def counters() -> dict:
    from critic2_tpu_torch.ops import yt_pass

    return dict(yt_pass.launches)


def info(ctx) -> dict:
    """Sizes of the solve: N grid points, K flux neighbours, P integrands
    (volume and charge)."""
    shape = tuple(int(v) for v in ctx.cfg["grid"])
    offs, _ = ref_yt.ws_facets(ref_yt.grid_lattice(
        ctx.cfg["structure"]["lattice_bohr"], shape))
    return {"N": int(np.prod(shape)), "K": len(offs), "P": 2}


def reference(ctx, rho, dtype):
    return ref_yt.basins(rho, ctx.cfg["structure"]["lattice_bohr"], dtype)


def as_output(ans) -> dict:
    """A reference answer in the shape of the program's outputs (one row
    per attractor): what the control hands to compare()."""
    n = len(ans["iattr"])
    return {"iattr": ans["iattr"], "attr_map": np.arange(n),
            "volume": ans["volume"], "charge": ans["charge"]}


def compare(ctx, out, ans) -> dict:
    """attractors_unmatched: attractors of one side missing on the other;
    charge_gap_e, volume_gap_bohr3: the widest gap of a basin's charge and
    volume (rows of attractors found on both sides)."""
    ref_pos = {int(v): i for i, v in enumerate(ans["iattr"])}
    prog = [int(v) for v in out["iattr"]]
    unmatched = len(set(prog) ^ set(ref_pos))
    qref = np.zeros(len(out["charge"]))
    vref = np.zeros(len(out["volume"]))
    whole = np.ones(len(out["charge"]), dtype=bool)
    for a, row in zip(prog, out["attr_map"]):
        if row < 0:
            continue
        if a in ref_pos:
            qref[row] += ans["charge"][ref_pos[a]]
            vref[row] += ans["volume"][ref_pos[a]]
        else:
            whole[row] = False
    if not whole.any():
        return {"attractors_unmatched": unmatched,
                "charge_gap_e": np.inf, "volume_gap_bohr3": np.inf}
    return {"attractors_unmatched": unmatched,
            "charge_gap_e": float(np.abs(out["charge"] - qref)[whole].max()),
            "volume_gap_bohr3": float(np.abs(out["volume"]
                                             - vref)[whole].max())}
